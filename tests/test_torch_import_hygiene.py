"""The port imports neither JAX nor the JAX package, in any module."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
import runpy
runpy.run_path(sys.argv[1], run_name="chip_smoke")   # defines, runs nothing
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro") or m.startswith(
                 ("jax.", "jaxlib.", "repro.")))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    # every module of the slice was imported, and nothing of JAX came along
    for mod in ("repro_torch.core.tuner", "repro_torch.core.gp",
                "repro_torch.core.lasso", "repro_torch.core.evaluators",
                "repro_torch.kernels.gp_gram.ops", "repro_torch.__main__",
                "repro_torch.kernels.build", "repro_torch.kernels.tma",
                "repro_torch.kernels.flash_attention.ops",
                "repro_torch.kernels.flash_attention.ref",
                "repro_torch.kernels.mlstm_chunk.ops",
                "repro_torch.kernels.mlstm_chunk.ref",
                "repro_torch.models.xlstm", "repro_torch.models.moe",
                "repro_torch.models.ssm", "repro_torch.models.whisper",
                "repro_torch.parallel.sharding",
                "repro_torch.parallel.collectives", "repro_torch.runconfig",
                "repro_torch.models.common", "repro_torch.models.rotary",
                "repro_torch.models.mlp", "repro_torch.models.attention",
                "repro_torch.models.transformer", "repro_torch.models.model",
                "repro_torch.serve.kvcache", "repro_torch.serve.engine",
                "repro_torch.launch.serve", "repro_torch.core.faults",
                "repro_torch.core.bo", "repro_torch.core.optimizers",
                "repro_torch.transfer", "repro_torch.transfer.corpus",
                "repro_torch.transfer.strategy", "repro_torch.service",
                "repro_torch.service.__main__", "repro_torch.service.cache",
                "repro_torch.service.shardlog", "repro_torch.service.pool",
                "repro_torch.service.session", "repro_torch.service.server",
                "repro_torch.service.wire", "repro_torch.service.client",
                "repro_torch.train", "repro_torch.train.optimizer",
                "repro_torch.train.train_loop", "repro_torch.train.data",
                "repro_torch.train.checkpoint", "repro_torch.train.elastic",
                "repro_torch.launch.train", "repro_torch.launch.mesh",
                "repro_torch.launch.dryrun", "repro_torch.launch.roofline"):
        assert mod in res["modules"]
    assert res["bad"] == []


def test_port_core_does_not_import_faults():
    """The port's ``core`` package re-exports the fault-injection harness
    (``core/faults.py``), as the reference's ``core/__init__`` does."""
    init = (ROOT / "src" / "repro_torch" / "core" / "__init__.py").read_text()
    assert "from repro_torch.core.faults import" in init
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", "import repro_torch.core as c, "
         "repro_torch.core.faults as f; "
         "print(c.FaultPlan is f.FaultPlan and "
         "c.FaultInjectingService is f.FaultInjectingService)"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"

"""Expert parallelism on the port's mesh: the MoE families' sharded train
step (``models/moe.py`` under a ``launch.mesh.ProcessMesh``) on gloo
worlds on the CPU (``launch.mesh.spawn`` running
``torch_sharded_worker.run_cases``), float32 smoke configs, against:

(a) the reference's sharded step on the same auto-axis mesh of forced
    CPU devices (``torch_sharded_reference.py`` in a subprocess), at
    ``test_torch_sharded_step.py``'s tolerances: qwen2-moe dense and
    dropping on 2 x 2 (the experts split over the model axis, two data
    ranks and two microbatches: each data rank's microbatch i is its
    block of the reference's global microbatch i, whose routing
    statistics are reduced over the data axis); dense on 1 x 2 under
    sequence parallelism; dense with ``tensor_parallel`` off on 1 x 2
    (the experts still split: the knob leaves the expert rules alone);
    grok-1 dense on 1 x 2 with ``expert_parallel`` off (the expert
    columns ``expert_ff`` split instead), under Adafactor; qwen2-moe
    dropping on 2 x 1 with a per-replica microbatch of 2 over a batch of
    8 (two microbatches of two data ranks: the capacity and every slot
    are those of the global microbatch);
(b) the port's one-process step on the global batch
    (``step_grads(..., mesh={"data": D})``, which cuts the reference's
    global microbatches): the loss within 1e-6 relative and every
    gathered gradient leaf within 1e-5 relative L2 (the attention keys'
    bias, zero in exact arithmetic, within 1e-5 of the whole gradient's
    norm);
(c) the 16 x 16 mesh's chip (0, 0) (a virtual mesh): neither smoke MoE's
    experts divide the model axis of 16, so ``expert_parallel`` on and
    off are one layout there (bit-equal step-1 loss, equal collective
    bytes by kind); on a virtual 2 x 2 they differ;
(d) the train launcher: ``launch.train --mesh 2x2`` at smoke width.

One spawn per mesh (three at once) and one reference subprocess run (a)
and (b) (module-scoped fixture); every join has a timeout.
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runconfig import runconfig_from_knobs as j_runconfig
from repro.train import optimizer as jopt
from repro_torch.configs import get_smoke_config
from repro_torch.launch import roofline
from repro_torch.launch.mesh import (make_production_mesh,
                                     make_virtual_mesh, spawn)
from repro_torch.models.common import (tree_flatten, tree_flatten_with_path,
                                       tree_unflatten)
from repro_torch.models.model import Model
from repro_torch.parallel.sharding import compute_range
from repro_torch.runconfig import runconfig_from_knobs
from repro_torch.train import train_loop as ttl
from test_torch_train import _pair
from test_torch_train_step import _assert_params_close, _assert_tree_close
import torch_sharded_worker as worker

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(param_dtype="float32", activation_dtype="float32",
           kv_cache_dtype="float32", learning_rate=1e-3)
QWEN, GROK = "qwen2-moe-a2.7b", "grok-1-314b"
S = 16
# name: (arch, knobs, mesh, global batch)
CASES = {
    "q-dense": (QWEN, dict(microbatch=1, moe_impl="dense"), (2, 2), 4),
    "q-drop": (QWEN, dict(microbatch=1, moe_impl="dropping"), (2, 2), 4),
    "q-sp": (QWEN, dict(microbatch=1, moe_impl="dense",
                        sequence_parallel=True), (1, 2), 4),
    "q-notp": (QWEN, dict(microbatch=1, moe_impl="dense",
                          tensor_parallel=False), (1, 2), 4),
    "g-noep": (GROK, dict(microbatch=1, moe_impl="dense",
                          expert_parallel=False, optimizer="adafactor"),
               (1, 2), 4),
    "q-drop-mb2": (QWEN, dict(microbatch=2, moe_impl="dropping"), (2, 1),
                   8),
}
MESHES = sorted({c[2] for c in CASES.values()})
SPAWN_TIMEOUT_S = 150
REFERENCE_TIMEOUT_S = 240


def _mesh_id(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def _batch(cfg, b, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(b, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(spec per case, the port's results per mesh, the reference's)."""
    tmp = tmp_path_factory.mktemp("expert")
    specs = {}
    for name, (arch, knobs, mesh, b) in CASES.items():
        jm, jp, _, _ = _pair(arch)
        leaves = jax.tree.leaves(jp)
        batch = _batch(jm.cfg, b)
        data = tmp / f"{name}.npz"
        np.savez(data, **{f"param_{i}": np.asarray(x)
                          for i, x in enumerate(leaves)},
                 **{f"batch_{k}": v for k, v in batch.items()})
        specs[name] = {"name": name, "arch": arch,
                       "knobs": {**F32, **knobs}, "mesh": list(mesh),
                       "data": str(data), "batch": sorted(batch),
                       "n_params": len(leaves)}
    ref_path = tmp / "reference.json"
    ref_path.write_text(json.dumps(list(specs.values())))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref_out = tmp / "reference.npz"
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_sharded_reference.py"),
         str(ref_path), str(ref_out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    errors, port = {}, {}

    def run(mesh):
        try:
            spec_path = tmp / f"cases-{_mesh_id(mesh)}.json"
            spec_path.write_text(json.dumps(
                [s for s in specs.values() if tuple(s["mesh"]) == mesh]))
            out = tmp / f"port-{_mesh_id(mesh)}.npz"
            spawn(worker.run_cases, mesh, (str(spec_path), str(out)),
                  device="cpu", timeout_s=SPAWN_TIMEOUT_S)
            with np.load(out) as z:
                port[mesh] = dict(z)
        except BaseException as e:     # noqa: BLE001 -- raised below
            errors[mesh] = e
    try:
        threads = [threading.Thread(target=run, args=(m,)) for m in MESHES]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for mesh, e in errors.items():
            raise RuntimeError(f"mesh {_mesh_id(mesh)}") from e
        _, err = proc.communicate(timeout=REFERENCE_TIMEOUT_S)
        assert proc.returncode == 0, err
        with np.load(ref_out) as z:
            ref = dict(z)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return specs, port, ref


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _one_process(spec):
    """The port's one-process loss and gradients on the global batch,
    cut into the reference's global microbatches."""
    model, rc, params, batch = worker.load_case(spec)
    loss, _, grads = ttl.step_grads(model, params, batch, rc,
                                    mesh={"data": spec["mesh"][0]})
    return float(loss), grads


@pytest.mark.parametrize("case", list(CASES))
def test_ep_step_matches_one_process(runs, case):
    specs, port, _ = runs
    got = port[CASES[case][2]]
    loss, grads = _one_process(specs[case])
    pairs = tree_flatten_with_path(grads)[0]
    np.testing.assert_allclose(got[f"{case}/met_loss"], loss, rtol=1e-6)
    total = float(torch.sqrt(sum(g.float().pow(2).sum() for _, g in pairs)))
    for i, (path, want) in enumerate(pairs):
        name = "/".join(map(str, path))
        g = got[f"{case}/grad_{i}"]
        assert np.isfinite(g).all(), name
        diff = np.linalg.norm(g - want.float().numpy())
        if name.endswith("k/b"):
            assert diff <= 1e-5 * total, (name, diff, total)
            continue
        rel = diff / max(float(want.float().norm()), 1e-30)
        assert rel <= 1e-5, (name, rel)


@pytest.mark.parametrize("case", list(CASES))
def test_ep_step_matches_reference(runs, case):
    specs, port, ref = runs
    got = port[CASES[case][2]]
    for k in ("loss", "grad_norm", "nll", "aux", "lr"):
        np.testing.assert_allclose(got[f"{case}/met_{k}"],
                                   ref[f"{case}/met_{k}"], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _, jp, _, _ = _pair(CASES[case][0])
    model, rc, _, _ = worker.load_case(specs[case])
    jstate = ttl.TrainState(jp, jopt.opt_init(jp, j_runconfig(
        specs[case]["knobs"])), jnp.zeros((), jnp.int32))
    jdef = jax.tree.structure(jstate)
    want = jax.tree.unflatten(jdef, [ref[f"{case}/state_{i}"]
                                     for i in range(jdef.num_leaves)])
    treedef = tree_flatten(ttl.state_shapes(model, rc, torch.float32))[1]
    have = tree_unflatten(treedef, [
        torch.from_numpy(got[f"{case}/state_{i}"])
        for i in range(jdef.num_leaves)])
    assert int(have.step) == int(want.step) == 1
    _assert_params_close(have.params, want.params, lr=1e-3)
    moments = ("m",) if rc.optimizer == "adamw" else ("vr", "vc", "v")
    for name in moments:
        _assert_tree_close(getattr(have.opt_state, name),
                           getattr(want.opt_state, name), atol=1e-6,
                           rtol=1e-3, zero_grad_atol=1e-6)


def test_rank_batch_cuts_the_global_microbatches():
    """Data rank r's rows are its block of each global microbatch: with a
    batch of 8 rows over 2 data ranks in 2 microbatches of 2 per replica,
    rank 0 holds rows 0, 1, 4, 5 and rank 1 rows 2, 3, 6, 7."""
    rc = runconfig_from_knobs({"microbatch": 2})
    batch = {"tokens": torch.arange(8)[:, None].expand(8, 3)}
    for rank, rows in ((0, [0, 1, 4, 5]), (1, [2, 3, 6, 7])):
        mesh = make_virtual_mesh((2, 1), (rank, 0), device="cpu")
        got = ttl.rank_batch(batch, rc, mesh)["tokens"][:, 0]
        assert got.tolist() == rows


# ---------------------------------------------------------------------------
# (c) the expert_parallel knob on the virtual chip
# ---------------------------------------------------------------------------

def _virtual_step(arch, knobs, mesh_shape):
    """(step-1 loss, collective bytes by kind) of one counted train step
    on chip (0, 0) of a virtual mesh of ``mesh_shape``."""
    cfg = get_smoke_config(arch)
    rc = runconfig_from_knobs(dict(microbatch=1, **knobs))
    model = Model(cfg, device="cpu")
    mesh = make_virtual_mesh(mesh_shape, device="cpu")
    lo, hi = compute_range(("vocab", "emb_embed"),
                           (cfg.vocab_size, cfg.d_model), 0, rc.shard,
                           mesh) or (0, cfg.vocab_size)
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(lo, hi, (1, S + 1), generator=gen,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with mesh:
        state = ttl.init_local_state(model, 0, rc)
        step = ttl.make_train_step(model, rc)
        counts, (_, mets) = roofline.count_step(lambda: step(state, batch))
    return float(mets["loss"]), counts.coll_by_kind


@pytest.mark.parametrize("arch", [QWEN, GROK])
def test_expert_parallel_is_one_layout_on_the_16x16_chip(arch):
    prod = make_production_mesh()
    cfg = get_smoke_config(arch)
    assert cfg.n_experts % prod["model"] != 0
    on = _virtual_step(arch, {"expert_parallel": True}, prod)
    off = _virtual_step(arch, {"expert_parallel": False}, prod)
    assert np.isfinite(on[0])
    assert on[0] == off[0]
    assert on[1] == off[1]
    small_on = _virtual_step(arch, {"expert_parallel": True}, (2, 2))
    small_off = _virtual_step(arch, {"expert_parallel": False}, (2, 2))
    assert small_on[1] != small_off[1]
    assert np.isfinite(small_on[0]) and np.isfinite(small_off[0])


# ---------------------------------------------------------------------------
# (d) the train launcher
# ---------------------------------------------------------------------------

def test_train_launcher_runs_qwen2_moe_on_a_2x2_mesh():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", QWEN,
         "--smoke", "--device", "cpu", "--steps", "2", "--global-batch",
         "4", "--seq-len", "16", "--mesh", "2x2", "--knob",
         "moe_impl=dropping"],
        capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("step")]
    assert lines and "done" in out.stdout
    loss = float(lines[0].split("loss")[1].split()[0])
    assert np.isfinite(loss)

"""Prefill and decode under a mesh: ``Model.prefill`` and
``Model.decode_step`` of every decoder-only family on gloo worlds on the
CPU (``launch.mesh.spawn`` running ``torch_sharded_worker.serve_cases``:
each rank's blocks of the parameters, its rows of the prompt, its blocks
of the decode state), float32 smoke configs, a global batch of 4 (or 1)
prompts of 8 tokens, a cache of 16 positions and 4 decode steps, on the
2 x 1, 1 x 2, 2 x 2 and 1 x 4 meshes (one spawn a world, all at once,
each running every family's case), against:

(a) the port's one process on the global batch: the last-token logits
    after the prefill, every gathered cache and state leaf after it, the
    4 decode steps' logits and every leaf after the last, each within
    1e-5 relative L2.  The SSM stacks amplify the mesh's other summation
    order (the model axis' partial sums, the gathered state, a stream
    split along the sequence) through their recurrences, as their
    training step does (``test_torch_ssm_parallel.py``): they are held
    at ``STACK_REL`` (measured up to 2.2e-4 for jamba, 2.0e-5 for the
    xLSTM), and in float64 the same runs agree to ~1e-13
    (``tools/serve_parallel_float64.py``).  The cases beyond the family
    defaults: ``kv_layout`` bhsd, the int8-sim cache, FSDP off (prefill
    and decode both gather FSDP's weights when it is on), prefill under
    ``sequence_parallel``, ``shard_kv_seq`` at B = 1 (the cache's
    sequence split over the data axis, decode's flash-decode combine)
    and at B = 4, where the guard gives the data axis to the batch: its
    results are bit-equal to the run without the knob.
(b) the reference's ``Model.prefill`` and ``decode_step`` jitted on the
    2 x 2 auto-axis mesh of forced CPU devices with its own shardings
    (``torch_serve_reference.py`` in a subprocess, as its ``lower_cell``
    places them), at ``test_torch_model.py``'s float32 serving tolerance
    (atol / rtol 1e-4).

One spawn a mesh and one reference subprocess run in a module-scoped
fixture; every join has a timeout.
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import spawn
from repro_torch.models.common import tree_flatten_with_path
from repro_torch.models.model import Model
import torch_sharded_worker as worker

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(param_dtype="float32", activation_dtype="float32",
           kv_cache_dtype="float32")
S, N, S_MAX = 8, 4, 16            # prompt, decode steps, cache length
Y, X, J = "yi-6b", "xlstm-1.3b", "jamba-1.5-large-398b"
# one case a family (its default knobs, batch 4)
FAMILIES = {"yi": Y, "qwen15": "qwen1.5-4b", "codeqwen": "codeqwen1.5-7b",
            "mistral": "mistral-nemo-12b", "qwen2vl": "qwen2-vl-72b",
            "qwen2moe": "qwen2-moe-a2.7b", "grok": "grok-1-314b",
            "jamba": J, "xlstm": X}
# name: (arch, knobs, global batch)
CASES = {name: (arch, {}, 4) for name, arch in FAMILIES.items()}
CASES.update({
    "yi-bhsd": (Y, {"kv_layout": "bhsd"}, 4),
    "yi-int8": (Y, {"kv_cache_dtype": "int8"}, 4),
    "yi-nofsdp": (Y, {"fsdp_shard_params": False}, 4),
    "yi-sp": (Y, {"sequence_parallel": True}, 4),
    "yi-kvseq-b1": (Y, {"shard_kv_seq": True}, 1),
    "yi-kvseq-b4": (Y, {"shard_kv_seq": True}, 4),
    "qwen2moe-drop": ("qwen2-moe-a2.7b", {"moe_impl": "dropping"}, 4),
    "jamba-sp": (J, {"sequence_parallel": True}, 4),
    "jamba-kvseq-b1": (J, {"shard_kv_seq": True}, 1),
    "xlstm-sp": (X, {"sequence_parallel": True}, 4),
})
KNOBS = tuple(c for c in CASES if c not in FAMILIES)
BY_MESH = {
    (2, 1): tuple(FAMILIES) + ("yi-kvseq-b1", "jamba-kvseq-b1"),
    (1, 2): tuple(FAMILIES) + ("yi-sp", "xlstm-sp", "qwen2moe-drop"),
    (2, 2): tuple(FAMILIES) + KNOBS,
    (1, 4): tuple(FAMILIES) + ("yi-sp", "jamba-sp", "xlstm-sp",
                               "yi-kvseq-b1"),
}
# the reference's sharded serving: (case, mesh)
REFERENCE = tuple((c, (2, 2)) for c in ("yi", "yi-kvseq-b1", "qwen2moe",
                                        "grok", "jamba-kvseq-b1", "xlstm"))
REL = 1e-5
# the SSM stacks' limit against one process (module docstring)
STACK_REL = {X: 1e-4, J: 1e-3}
SPAWN_TIMEOUT_S = 150
REFERENCE_TIMEOUT_S = 240


def _mesh_id(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def _key(case, mesh):
    return f"{case}@{_mesh_id(mesh)}"


ONE = [(m, c) for m, cs in BY_MESH.items() for c in cs]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(spec per case, the port's results per mesh, the reference's)."""
    tmp = tmp_path_factory.mktemp("serve")
    specs = {}
    for name, (arch, knobs, batch) in CASES.items():
        cfg = get_smoke_config(arch)
        leaves = [x for _, x in tree_flatten_with_path(
            Model(cfg, device="cpu").init(0, dtype=torch.float32))[0]]
        rng = np.random.default_rng(1)
        toks = rng.integers(1, cfg.vocab_size, size=(batch, S + N))
        data = tmp / f"{name}.npz"
        np.savez(data, batch_tokens=toks.astype(np.int32),
                 **{f"param_{i}": x.numpy() for i, x in enumerate(leaves)})
        specs[name] = {"name": name, "arch": arch, "knobs": {**F32, **knobs},
                       "data": str(data), "batch": ["tokens"],
                       "n_params": len(leaves), "global_batch": batch,
                       "prompt": S, "decode": N, "s_max": S_MAX}
    ref_path = tmp / "reference.json"
    ref_path.write_text(json.dumps([
        {**specs[c], "name": _key(c, m), "mesh": list(m)}
        for c, m in REFERENCE]))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref_out = tmp / "reference.npz"
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_serve_reference.py"),
         str(ref_path), str(ref_out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    errors, port = {}, {}

    def run(mesh):
        try:
            spec_path = tmp / f"cases-{_mesh_id(mesh)}.json"
            spec_path.write_text(json.dumps([specs[c]
                                             for c in BY_MESH[mesh]]))
            out = tmp / f"port-{_mesh_id(mesh)}.npz"
            spawn(worker.serve_cases, mesh, (str(spec_path), str(out)),
                  device="cpu", timeout_s=SPAWN_TIMEOUT_S)
            with np.load(out) as z:
                port[mesh] = dict(z)
        except BaseException as e:     # noqa: BLE001 -- raised below
            errors[mesh] = e
    try:
        threads = [threading.Thread(target=run, args=(m,)) for m in BY_MESH]
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


_ONE = {}


def _one_process(spec):
    """The port's one-process serving run of a case on the global batch:
    {key: array} with ``serve_cases``' keys."""
    name = spec["name"]
    if name not in _ONE:
        model, rc, params, batch = worker.load_case(spec)
        toks = batch["tokens"]
        out = {}
        with torch.no_grad():
            logits, state = model.prefill(params, {"tokens": toks[:, :S]},
                                          S_MAX, rc)
            out["logits_0"] = worker._np(logits)
            for i, (path, x) in enumerate(tree_flatten_with_path(state)[0]):
                out[f"prefill_{i}"] = worker._np(x)
            for t in range(N):
                logits, state = model.decode_step(
                    params, toks[:, S + t:S + t + 1], state, rc)
                out[f"logits_{t + 1}"] = worker._np(logits)
            paths, narrow = [], set()
            for i, (path, x) in enumerate(tree_flatten_with_path(state)[0]):
                out[f"decode_{i}"] = worker._np(x)
                paths.append("/".join(map(str, path)))
                if x.dtype == torch.bfloat16:
                    narrow.add(i)
        _ONE[name] = (out, paths, narrow)
    return _ONE[name]


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _keys(n_leaves):
    return ([f"logits_{t}" for t in range(N + 1)]
            + [f"{phase}_{i}" for phase in ("prefill", "decode")
               for i in range(n_leaves)])


@pytest.mark.parametrize("mesh,case", ONE, ids=[_key(c, m) for m, c in ONE])
def test_serving_matches_one_process(runs, mesh, case):
    specs, port, _ = runs
    got = port[mesh]
    want, paths, _ = _one_process(specs[case])
    limit = STACK_REL.get(specs[case]["arch"], REL)
    for k in _keys(len(paths)):
        g = got[f"{case}/{k}"]
        name = k if k.startswith("logits") else \
            f"{k.split('_')[0]} {paths[int(k.split('_')[1])]}"
        assert g.shape == want[k].shape, (name, g.shape, want[k].shape)
        assert np.isfinite(g).all(), name
        rel = _rel_l2(g, want[k])
        assert rel <= limit, (name, rel, limit)


@pytest.mark.parametrize("mesh", [(2, 2)], ids=_mesh_id)
def test_shard_kv_seq_at_a_divisible_batch_changes_nothing(runs, mesh):
    """B = 4 divides the data axis: the batch takes it and the cache's
    sequence stays whole (the guard), so the knob changes no bit."""
    specs, port, _ = runs
    got = port[mesh]
    for k in _keys(len(_one_process(specs["yi"])[1])):
        assert np.array_equal(got[f"yi-kvseq-b4/{k}"], got[f"yi/{k}"]), k


@pytest.mark.parametrize("case,mesh", REFERENCE,
                         ids=[_key(c, m) for c, m in REFERENCE])
def test_serving_matches_the_reference(runs, case, mesh):
    """A leaf both packages store in bf16 (mamba's conv tail) rounds an
    input that the two compute ~1e-7 apart, and may round it the other
    way: it is held to one bf16 step (2^-7 relative)."""
    specs, port, ref = runs
    got, key = port[mesh], _key(case, mesh)
    _, paths, narrow = _one_process(specs[case])
    for k in _keys(len(paths)):
        i = None if k.startswith("logits") else int(k.split("_")[1])
        rtol = 2.0 ** -7 if i in narrow else 1e-4
        np.testing.assert_allclose(got[f"{case}/{k}"], ref[f"{key}/{k}"],
                                   atol=1e-4, rtol=rtol, err_msg=k)

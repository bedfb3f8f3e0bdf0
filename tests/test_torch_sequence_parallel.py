"""Sequence parallelism on the port's mesh (``sequence_parallel=True``):
the residual stream between blocks is each model rank's block of the
sequence, the column-parallel projections read it gathered
(``collectives.gather_seq``) and the row-parallel ones reduce-scatter
their sums back to it (``collectives.reduce_scatter``), on gloo worlds on
the CPU (``launch.mesh.spawn`` running ``torch_sharded_worker.run_cases``)
against:

(a) the port's one-process step on the global batch: the loss within
    1e-6 relative and every gathered gradient leaf within 1e-5 relative
    L2 (the attention keys' bias, whose gradient is zero in exact
    arithmetic, within 1e-5 of the whole gradient's norm), float32, on
    the 1 x 2, 2 x 2 and 1 x 4 meshes; yi-6b (GQA; its kv columns split
    mid-head at model 4; with one kv head of 6 columns, which does not
    split over 4, its k and v weights whole) and qwen2-vl-72b (M-RoPE:
    its [3, B, S] positions stay whole), microbatch 1 and 2, remat none
    and block; a
    bf16 ``tp_reduce_dtype`` case (each projection's dgrad
    reduce-scattered in bf16) at ``test_torch_sharded_step.py``'s
    bf16-derived bounds (4U per leaf, U / 16 in the loss); tensor
    parallelism off (every weight replicated over the model axis and used
    under ``common.replicated``);
(b) the reference's ``sequence_parallel=True`` step on the 2 x 2
    auto-axis mesh of forced CPU devices (``torch_sharded_reference.py``
    in a subprocess) at ``test_torch_sharded_step.py``'s tolerances;
(c) itself with the knob released: a sequence of 7 does not split over
    the model axis (the divisibility guard of ``logical_to_spec``), and
    the step is the one without sequence parallelism bit for bit;
    ``shard_kv_seq`` on a train step changes nothing, bit for bit;
(d) the 16 x 16 mesh's chip (0, 0) at 32 layers (a virtual mesh, smoke
    width, one token a chip): the virtual collectives' values are not the
    mesh's, and the stream must stay finite through every layer.

The virtual 2 x 2 chip against rank 0 of a gloo world, and the per-chip
FLOPs against the reference's compiled HLO, under sequence parallelism,
are cases of ``test_torch_virtual_mesh.py``.  One spawn per mesh (three
at once) and one reference subprocess run everything (module-scoped
fixture); every join has a timeout.
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
from repro_torch.launch.mesh import (make_production_mesh,
                                     make_virtual_mesh, spawn)
from repro_torch.models.common import (tree_flatten, tree_flatten_with_path,
                                       tree_unflatten)
from repro_torch.models.model import Model
from repro_torch.parallel.sharding import compute_range, sequence_parallel_on
from repro_torch.runconfig import runconfig_from_knobs
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as ttl
from test_torch_sharded_step import U, _assert_params_close_bf16, _rel_l2
from test_torch_train import _pair
from test_torch_train_step import _assert_params_close, _assert_tree_close
import torch_sharded_worker as worker

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(param_dtype="float32", activation_dtype="float32",
           kv_cache_dtype="float32", learning_rate=1e-3)
SP = dict(sequence_parallel=True)
B, S, S_ODD = 4, 8, 7
# name: (arch, knobs, sequence length)
CASES = {
    "yi-mb1": ("yi-6b", dict(microbatch=1), S),
    "yi-kv-seq": ("yi-6b", dict(microbatch=1, shard_kv_seq=True), S),
    "yi-sp-mb1": ("yi-6b", dict(SP, microbatch=1), S),
    "yi-sp-mb2-block": ("yi-6b", dict(SP, microbatch=2,
                                      remat_policy="block"), S),
    "yi-sp-tp-bf16": ("yi-6b", dict(SP, tp_reduce_dtype="bfloat16"), S),
    "yi-sp-notp": ("yi-6b", dict(SP, microbatch=1, tensor_parallel=False),
                   S),
    "vl-sp-mb1-block": ("qwen2-vl-72b", dict(SP, microbatch=1,
                                             remat_policy="block"), S),
    "vl-sp-mb2": ("qwen2-vl-72b", dict(SP, microbatch=2), S),
    "yi-odd": ("yi-6b", dict(microbatch=2), S_ODD),
    "yi-odd-sp": ("yi-6b", dict(SP, microbatch=2), S_ODD),
    "yi-kv-whole-sp": ("yi-6b", dict(SP, microbatch=1), S),
}
# config fields a case replaces: one kv head of 6 columns does not split
# over a model axis of 4, so the k and v weights are whole on every rank
# (the reference has no such smoke config: the port's own init)
CFG = {"yi-kv-whole-sp": {"n_kv_heads": 1, "head_dim": 6}}
BF16 = ("yi-sp-tp-bf16",)
# the cases each mesh runs (the spawns run at once: each mesh's share of
# the cases keeps its world within the file's budget)
BY_MESH = {
    (1, 2): ("yi-sp-mb1", "vl-sp-mb2", "yi-sp-tp-bf16", "yi-odd",
             "yi-odd-sp"),
    (2, 2): ("yi-mb1", "yi-kv-seq", "yi-sp-mb1", "yi-sp-mb2-block",
             "vl-sp-mb1-block", "vl-sp-mb2", "yi-sp-tp-bf16"),
    (1, 4): ("yi-sp-mb2-block", "vl-sp-mb1-block", "yi-sp-notp", "yi-odd",
             "yi-odd-sp", "yi-kv-whole-sp"),
}
REFERENCE = ("yi-sp-mb1", "yi-sp-mb2-block", "vl-sp-mb1-block",
             "vl-sp-mb2", "yi-sp-tp-bf16")
SPAWN_TIMEOUT_S = 150
REFERENCE_TIMEOUT_S = 240


def _mesh_id(mesh):
    return f"{mesh[0]}x{mesh[1]}"


ONE = [(m, c) for m, cs in BY_MESH.items() for c in cs
       if CASES[c][1].get("sequence_parallel") and CASES[c][2] == S]
ONE_IDS = [f"{_mesh_id(m)}-{c}" for m, c in ONE]


def _batch(cfg, seq, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(B, seq + 1)) \
        .astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.mrope_sections is not None:        # (t, h, w) ids of a stub
        t = np.arange(seq, dtype=np.int32)
        batch["positions"] = np.stack(
            [np.broadcast_to(t, (B, seq)), np.broadcast_to(t // 4, (B, seq)),
             np.broadcast_to(t % 4, (B, seq))]).astype(np.int32)
    return batch


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(spec per case, the port's results per mesh, the reference's)."""
    tmp = tmp_path_factory.mktemp("sequence")
    specs = {}
    for name, (arch, knobs, seq) in CASES.items():
        spec = {"name": name, "arch": arch, "knobs": {**F32, **knobs},
                "cfg": CFG.get(name, {})}
        if name in CFG:
            cfg = worker.case_config(spec)
            leaves = [x.numpy() for x in tree_flatten(
                Model(cfg, device="cpu").init(0, dtype=torch.float32))[0]]
        else:
            jm, jp, _, _ = _pair(arch)
            cfg, leaves = jm.cfg, jax.tree.leaves(jp)
        batch = _batch(cfg, seq)
        data = tmp / f"{name}.npz"
        np.savez(data, **{f"param_{i}": np.asarray(x)
                          for i, x in enumerate(leaves)},
                 **{f"batch_{k}": v for k, v in batch.items()})
        specs[name] = {**spec, "data": str(data), "batch": sorted(batch),
                       "n_params": len(leaves)}
    ref_path = tmp / "reference.json"
    ref_path.write_text(json.dumps([{**specs[c], "mesh": [2, 2]}
                                    for c in REFERENCE]))
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
            spec_path.write_text(json.dumps([specs[c]
                                             for c in BY_MESH[mesh]]))
            out = tmp / f"port-{_mesh_id(mesh)}.npz"
            spawn(worker.run_cases, mesh, (str(spec_path), str(out)),
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


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_ONE = {}


def _one_process(spec):
    """The port's one-process loss and gradients on the global batch."""
    if spec["name"] not in _ONE:
        model, rc, params, batch = worker.load_case(spec)
        loss, _, grads = ttl.step_grads(model, params, batch, rc)
        _ONE[spec["name"]] = (float(loss), grads)
    return _ONE[spec["name"]]


def test_sequence_parallel_on_follows_the_guard():
    """True where the reference's spec gives ``seq`` the model axis: the
    knob on, a model axis of more than one rank, and a sequence that
    splits over it."""
    on = runconfig_from_knobs(SP).shard
    off = runconfig_from_knobs({}).shard
    mesh = make_virtual_mesh((2, 4), device="cpu")
    assert sequence_parallel_on(on, mesh, 8)
    assert not sequence_parallel_on(on, mesh, 6)          # 6 % 4
    assert not sequence_parallel_on(off, mesh, 8)
    assert not sequence_parallel_on(on, make_virtual_mesh((4, 1),
                                                          device="cpu"), 8)
    assert not sequence_parallel_on(on, None, 8)
    assert sequence_parallel_on(on, make_virtual_mesh(
        make_production_mesh(), device="cpu"), 4096)


@pytest.mark.parametrize("mesh,case", ONE, ids=ONE_IDS)
def test_sp_step_matches_one_process(runs, mesh, case):
    specs, port, _ = runs
    got = port[mesh]
    loss, grads = _one_process(specs[case])
    pairs = tree_flatten_with_path(grads)[0]
    bf16 = case in BF16
    np.testing.assert_allclose(got[f"{case}/met_loss"], loss,
                               rtol=U / 16 if bf16 else 1e-6)
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
        assert rel <= (4 * U if bf16 else 1e-5), (name, rel)


@pytest.mark.parametrize("case", REFERENCE)
def test_sp_step_matches_reference(runs, case):
    specs, port, ref = runs
    got, key = port[(2, 2)], case
    bf16 = case in BF16
    for k in ("loss", "grad_norm", "nll", "aux", "lr"):
        rtol = 1e-5 if not bf16 else U / 8 if k == "grad_norm" else U / 16
        np.testing.assert_allclose(got[f"{case}/met_{k}"],
                                   ref[f"{key}/met_{k}"], rtol=rtol,
                                   atol=1e-7, err_msg=k)
    _, jp, _, _ = _pair(CASES[case][0])
    model, rc, _, _ = worker.load_case(specs[case])
    jstate = ttl.TrainState(jp, jopt.opt_init(jp, j_runconfig(
        specs[case]["knobs"])), jnp.zeros((), jnp.int32))
    jdef = jax.tree.structure(jstate)
    want = jax.tree.unflatten(jdef, [ref[f"{key}/state_{i}"]
                                     for i in range(jdef.num_leaves)])
    treedef = tree_flatten(ttl.state_shapes(model, rc, torch.float32))[1]
    have = tree_unflatten(treedef, [
        torch.from_numpy(got[f"{case}/state_{i}"])
        for i in range(jdef.num_leaves)])
    assert int(have.step) == int(want.step) == 1
    if not bf16:
        _assert_params_close(have.params, want.params, lr=1e-3)
        _assert_tree_close(have.opt_state.m, want.opt_state.m, atol=1e-6,
                           rtol=1e-3, zero_grad_atol=1e-6)
        return
    _assert_params_close_bf16(have, want)
    for g, w in zip(tree_flatten(have.opt_state.m)[0],
                    jax.tree.leaves(want.opt_state.m)):
        assert _rel_l2(g.numpy(), w) <= 4 * U


def _same_run(got, a, b):
    keys = sorted(k.split("/", 1)[1] for k in got if k.startswith(a + "/"))
    assert keys and keys == sorted(k.split("/", 1)[1] for k in got
                                   if k.startswith(b + "/"))
    for k in keys:
        np.testing.assert_array_equal(got[f"{a}/{k}"], got[f"{b}/{k}"],
                                      err_msg=k)


@pytest.mark.parametrize("mesh", [(1, 2), (1, 4)], ids=_mesh_id)
def test_a_sequence_that_does_not_split_releases_the_knob(runs, mesh):
    """S = 7 on a model axis of 2 or 4: the guard releases the axis and
    the step is the one without sequence parallelism, bit for bit."""
    _, port, _ = runs
    shard = runconfig_from_knobs(SP).shard
    assert not sequence_parallel_on(
        shard, make_virtual_mesh(mesh, device="cpu"), S_ODD)
    _same_run(port[mesh], "yi-odd-sp", "yi-odd")


def test_shard_kv_seq_changes_nothing_in_a_train_step(runs):
    """No tensor of a train step has the ``kv_seq`` axis: the knob's step
    is the step without it, bit for bit (2 x 2: a data axis to split)."""
    _, port, _ = runs
    _same_run(port[(2, 2)], "yi-kv-seq", "yi-mb1")


def test_virtual_16x16_chip_stays_finite_at_32_layers():
    """The virtual collectives return ``n`` times a block (a
    reduce-scatter of the stream) or tile it (its gather): the values are
    not the mesh's, and nothing renorms the stream but the blocks' own
    norms.  At 16 x 16, 32 layers and one token a chip the loss and every
    gradient leaf stay finite over two steps and the loss drops."""
    cfg = get_smoke_config("yi-6b").scaled(n_layers=32)
    rc = runconfig_from_knobs(dict(SP, microbatch=1, remat_policy="block"))
    model = Model(cfg, device="cpu")
    mesh = make_virtual_mesh(make_production_mesh(), device="cpu")
    assert sequence_parallel_on(rc.shard, mesh, 16)
    # the chip's tokens from its own vocab rows (as ``dryrun.lower_cell``)
    lo, hi = compute_range(("vocab", "emb_embed"),
                           (cfg.vocab_size, cfg.d_model), 0, rc.shard, mesh)
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(lo, hi, (1, 17), generator=gen, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with mesh:
        state = ttl.init_local_state(model, 0, rc)
        pls = ttl.param_placements(model, rc)
        _, _, grads = ttl.step_grads(model, state.params, batch, rc,
                                     placements=pls)
        assert all(bool(torch.isfinite(g).all())
                   for g in tree_flatten(grads)[0])
        step = ttl.make_train_step(model, rc,
                                   topt.cosine_schedule(1e-2, 0, 100))
        losses = []
        for _ in range(3):
            state, mets = step(state, batch)
            losses.append(float(mets["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses

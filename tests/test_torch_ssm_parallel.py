"""The ``ssm_inner`` layout on the port's mesh: the mamba, mLSTM and sLSTM
blocks' sharded train step (``models/ssm.py``, ``models/xlstm.py`` under
a ``launch.mesh.ProcessMesh``) on gloo worlds on the CPU
(``launch.mesh.spawn`` running ``torch_sharded_worker.run_cases``),
float32 smoke configs of xlstm-1.3b and jamba-1.5-large-398b, on the
1 x 2, 2 x 2 and 1 x 4 meshes (1 x 4 cuts both families' heads: the
xLSTM's 2 heads of 64 and mamba's 2 heads of 64 over 4 ranks of 32
channels), under the default layout, ``sequence_parallel``,
``tensor_parallel`` off, ``fsdp_shard_params`` off, remat ``block``,
``tp_reduce_dtype=bfloat16`` and jamba's dropping MoE, against:

(a) the port's one-process step on the global batch
    (``step_grads(..., mesh={"data": D})``): the loss within 1e-6
    relative, and every gathered gradient leaf in relative L2 within
    1e-5 for each layer kind alone (a cut to one pattern position,
    ``keep``: the mLSTM, the sLSTM, mamba with the dense MLP and mamba
    with the MoE) under every knob, and within the family's limit for the
    smoke stacks: 2e-4 for jamba, as ``test_torch_train_jamba.py`` holds
    its one-device step against the reference, 1e-3 for the xLSTM's
    one-period cut, as ``test_torch_train_xlstm.py`` holds its, and 2e-3
    for the whole xLSTM stack.  A stack amplifies the model axis' other
    summation order as one process amplifies another chunk (PR 20: each
    layer alone agrees to 1e-6): measured up to 1.09e-3 (the xLSTM's
    input-gate bias) and 9.1e-5 (jamba's ``d_skip``); in float64 the
    smoke stacks (the port's own weights) agree to 5e-13 under every mesh
    and knob (``tools/ssm_parallel_float64.py``).  The bf16
    reduce cases (a layer alone) are held to
    ``test_torch_sharded_step.py``'s bf16-derived bounds (U / 16 in the
    loss, 4U a leaf);
(b) the reference's sharded step on the same auto-axis mesh of forced
    CPU devices (``torch_sharded_reference.py`` in a subprocess; the
    xLSTM at its one-period cut, as ``test_torch_train_xlstm.py`` runs
    its step): the metrics, the parameters after AdamW's first step
    (``_assert_params_close``) and each leaf's first moment (the
    gradient) within the family's limit in relative L2, 1e-3 and 2e-4;
    the bf16 cases at the bf16-derived bounds;
(c) the 16 x 16 mesh's chip (0, 0) (a virtual mesh): at full width
    jamba's 16 experts split one a chip over the model axis, the train
    cells of both families run at the chip share, and a smoke-width step
    of each family stays finite;
(d) the train launcher: ``launch.train --mesh`` at smoke width;
(e) the all-to-all primitive's routes and its virtual rule.

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
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh, make_virtual_mesh, \
    spawn
from repro_torch.models.common import (tree_flatten, tree_flatten_with_path,
                                       tree_unflatten)
from repro_torch.models.config import SHAPES_BY_NAME
from repro_torch.models.model import Model
from repro_torch.models.moe import EXPERT_AXES, _expert_ff
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import WHISPER_ITEM, compute_range
from repro_torch.runconfig import runconfig_from_knobs
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as ttl
from test_torch_sharded_step import U, _assert_params_close_bf16, _rel_l2
from test_torch_train import _pair
from test_torch_train_step import _assert_params_close
import torch_sharded_worker as worker

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(param_dtype="float32", activation_dtype="float32",
           kv_cache_dtype="float32", learning_rate=1e-3, microbatch=1)
X, J = "xlstm-1.3b", "jamba-1.5-large-398b"
# the family's limit per gradient leaf (test_torch_train_{xlstm,jamba}.py),
# and the whole smoke stack's against one process (module docstring)
GRAD_REL = {X: 1e-3, J: 2e-4}
STACK_REL = {X: 2e-3, J: 2e-4}
S, B = 16, 4
SP = dict(sequence_parallel=True)
# name: (arch, knobs, pattern positions kept (None: the whole smoke stack))
LAYER_KNOBS = {"": {}, "-sp": SP, "-notp": dict(tensor_parallel=False),
               "-nofsdp": dict(fsdp_shard_params=False),
               "-block": dict(remat_policy="block")}
LAYERS = {"x-mlstm": (X, (0,)), "x-slstm": (X, (7,)),
          "j-mamba-mlp": (J, (0,)), "j-mamba-moe": (J, (1,))}
CASES = {f"{name}{k}": (arch, knobs, keep)
         for name, (arch, keep) in LAYERS.items()
         for k, knobs in LAYER_KNOBS.items()}
CASES.update({
    "x-mlstm-bf16": (X, dict(tp_reduce_dtype="bfloat16"), (0,)),
    "j-mamba-moe-bf16": (J, dict(tp_reduce_dtype="bfloat16"), (1,)),
    "x-cut": (X, {}, (0, 7)),
    "x-mb1": (X, {}, None),
    "x-sp": (X, SP, None),
    "x-notp": (X, LAYER_KNOBS["-notp"], None),
    "x-nofsdp": (X, LAYER_KNOBS["-nofsdp"], None),
    "j-mb1": (J, {}, None),
    "j-sp": (J, SP, None),
    "j-notp": (J, LAYER_KNOBS["-notp"], None),
    "j-nofsdp": (J, LAYER_KNOBS["-nofsdp"], None),
    "j-drop": (J, dict(moe_impl="dropping", remat_policy="block"), None),
})
BF16 = ("x-mlstm-bf16", "j-mamba-moe-bf16")
# the cases each mesh runs (the spawns run at once)
BY_MESH = {
    (1, 2): tuple(f"{n}{k}" for n in LAYERS for k in ("", "-sp"))
    + BF16 + ("x-mb1", "j-mb1"),
    (2, 2): tuple(f"{n}{k}" for n in LAYERS
                  for k in ("", "-notp", "-nofsdp", "-block"))
    + BF16 + ("x-cut", "x-mb1", "x-notp", "x-nofsdp", "j-mb1", "j-notp",
              "j-nofsdp", "j-drop"),
    (1, 4): tuple(f"{n}{k}" for n in LAYERS for k in ("", "-sp"))
    + ("x-sp", "j-sp"),
}
# the reference's sharded step: (case, mesh)
REFERENCE = (("x-cut", (2, 2)), ("j-mb1", (2, 2)), ("j-drop", (2, 2)),
             ("x-mlstm-bf16", (1, 2)), ("j-mamba-moe-bf16", (2, 2)))
SPAWN_TIMEOUT_S = 150
REFERENCE_TIMEOUT_S = 180


def _mesh_id(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def _key(case, mesh):
    return f"{case}@{_mesh_id(mesh)}"


ONE = [(m, c) for m, cs in BY_MESH.items() for c in cs]
ONE_IDS = [_key(c, m) for m, c in ONE]


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(spec per case, the port's results per mesh, the reference's)."""
    tmp = tmp_path_factory.mktemp("ssm")
    specs = {}
    for name, (arch, knobs, keep) in CASES.items():
        jm, jp, _, _ = _pair(arch, keep=keep)
        leaves = jax.tree.leaves(jp)
        batch = _batch(jm.cfg)
        data = tmp / f"{name}.npz"
        np.savez(data, **{f"param_{i}": np.asarray(x)
                          for i, x in enumerate(leaves)},
                 **{f"batch_{k}": v for k, v in batch.items()})
        specs[name] = {"name": name, "arch": arch, "knobs": {**F32, **knobs},
                       "keep": list(keep or ()), "data": str(data),
                       "batch": sorted(batch), "n_params": len(leaves)}
    ref_path = tmp / "reference.json"
    ref_path.write_text(json.dumps([
        {**specs[c], "name": _key(c, m), "mesh": list(m)}
        for c, m in REFERENCE]))
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


def _one_process(spec, data_ranks):
    """The port's one-process loss and gradients on the global batch,
    cut into the reference's global microbatches."""
    key = (spec["name"], data_ranks)
    if key not in _ONE:
        model, rc, params, batch = worker.load_case(spec)
        loss, _, grads = ttl.step_grads(model, params, batch, rc,
                                        mesh={"data": data_ranks})
        _ONE[key] = (float(loss), grads)
    return _ONE[key]


def _leaf_limit(case):
    arch, _, keep = CASES[case]
    if case in BF16:
        return 4 * U
    if keep is not None and len(keep) == 1:
        return 1e-5
    return GRAD_REL[arch] if keep else STACK_REL[arch]


@pytest.mark.parametrize("mesh,case", ONE, ids=ONE_IDS)
def test_ssm_step_matches_one_process(runs, mesh, case):
    specs, port, _ = runs
    got = port[mesh]
    loss, grads = _one_process(specs[case], mesh[0])
    np.testing.assert_allclose(got[f"{case}/met_loss"], loss,
                               rtol=U / 16 if case in BF16 else 1e-6)
    assert got[f"{case}/host_equal"]
    limit = _leaf_limit(case)
    for i, (path, want) in enumerate(tree_flatten_with_path(grads)[0]):
        name = "/".join(map(str, path))
        g = got[f"{case}/grad_{i}"]
        assert np.isfinite(g).all(), name
        rel = _rel_l2(g, want.float().numpy())
        assert rel <= limit, (name, rel, limit)


@pytest.mark.parametrize("case,mesh", REFERENCE,
                         ids=[_key(c, m) for c, m in REFERENCE])
def test_ssm_step_matches_reference(runs, case, mesh):
    specs, port, ref = runs
    got, key = port[mesh], _key(case, mesh)
    arch, _, keep = CASES[case]
    bf16 = case in BF16
    for k in ("loss", "grad_norm", "nll", "aux", "lr"):
        if bf16:
            rtol = U / 8 if k == "grad_norm" else U / 16
        else:
            rtol = 1e-4 if k == "grad_norm" and arch == X else 1e-5
        np.testing.assert_allclose(got[f"{case}/met_{k}"],
                                   ref[f"{key}/met_{k}"], rtol=rtol,
                                   atol=1e-7, err_msg=k)
    _, jp, _, _ = _pair(arch, keep=keep)
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
    if bf16:
        _assert_params_close_bf16(have, want)
    else:
        _assert_params_close(have.params, want.params, lr=1e-3)
    limit = 4 * U if bf16 else GRAD_REL[arch]
    flat = jax.tree_util.tree_flatten_with_path(want.opt_state.m)[0]
    for g, (path, w) in zip(tree_flatten(have.opt_state.m)[0], flat):
        rel = _rel_l2(g.numpy(), np.asarray(w, np.float32))
        assert rel <= limit, (jax.tree_util.keystr(path), rel, limit)


# ---------------------------------------------------------------------------
# (c) the 16 x 16 mesh's chip
# ---------------------------------------------------------------------------

def test_ssm_train_cells_run_at_the_chip_share():
    """xlstm-1.3b's and jamba's train cells are covered on the chip (no
    ROADMAP item), their serving cells too (prefill and decode under the
    mesh), whisper's still are not, and at full width the chip holds one
    of jamba's 16 experts (``experts`` over the model axis of 16, the path
    of expert parallelism)."""
    cell = SHAPES_BY_NAME["train_4k"]
    for arch in (X, J):
        cfg = get_config(arch)
        rc = dryrun.default_runconfig(cfg, cell)
        assert dryrun.layout_covers(cfg, cell, rc) is None
        assert dryrun.resolve_share(cfg, cell) == "chip"
        for shape in ("prefill_32k", "long_500k"):
            serve = SHAPES_BY_NAME[shape]
            assert dryrun.layout_covers(cfg, serve, dryrun.default_runconfig(
                cfg, serve)) is None
            assert dryrun.resolve_share(cfg, serve) == "chip"
    whisper = get_config("whisper-tiny")
    assert dryrun.layout_covers(whisper, cell, dryrun.default_runconfig(
        whisper, cell)) == WHISPER_ITEM
    cfg = get_config(J)
    chip = make_virtual_mesh(make_production_mesh(), device="cpu")
    rc = dryrun.default_runconfig(cfg, cell)
    dims = (cfg.n_experts, cfg.d_model, _expert_ff(cfg))
    assert compute_range(EXPERT_AXES, dims, 0, rc.shard, chip) == (0, 1)
    assert compute_range(EXPERT_AXES, dims, 2, rc.shard, chip) is None
    assert compute_range(("ssm_inner",), (cfg.d_inner,), 0, rc.shard,
                         chip) == (0, cfg.d_inner // 16)


@pytest.mark.parametrize("arch", [X, J])
def test_virtual_16x16_ssm_step_is_finite(arch):
    """A smoke-width step on chip (0, 0) of 16 x 16 (a virtual mesh): every
    head is cut (8 channels a chip), and the loss is finite and the
    collectives are those of the layout (the ``[x | z]`` regroup's
    all-to-all among them)."""
    from repro_torch.launch import roofline
    cfg = get_smoke_config(arch)
    rc = runconfig_from_knobs({"microbatch": 1})
    model = Model(cfg, device="cpu")
    mesh = make_virtual_mesh(make_production_mesh(), device="cpu")
    lo, hi = compute_range(("vocab", "emb_embed"),
                           (cfg.vocab_size, cfg.d_model), 0, rc.shard, mesh)
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(lo, hi, (1, S + 1), generator=gen,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with mesh:
        state = ttl.init_local_state(model, 0, rc)
        step = ttl.make_train_step(model, rc,
                                   topt.cosine_schedule(1e-3, 0, 100))
        counts, (_, mets) = roofline.count_step(lambda: step(state, batch))
    assert np.isfinite(float(mets["loss"]))
    assert counts.coll_by_kind[collectives.ALL_TO_ALL] > 0


# ---------------------------------------------------------------------------
# (d) the train launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mesh", [(X, "1x2"), (J, "2x2")])
def test_train_launcher_runs_the_ssm_families_on_a_mesh(arch, mesh):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--smoke", "--device", "cpu", "--steps", "2", "--global-batch",
         "4", "--seq-len", "16", "--mesh", mesh],
        capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("step")]
    assert lines and "done" in out.stdout
    loss = float(lines[0].split("loss")[1].split()[0])
    assert np.isfinite(loss)


# ---------------------------------------------------------------------------
# (e) the all-to-all primitive
# ---------------------------------------------------------------------------

def test_all_to_all_virtual_rule_route_and_bytes():
    """On a virtual mesh each slot holds this chip's own chunk of the
    index its source chunk has on its rank; the result's bytes are counted
    as ``"all-to-all"``, a kind a tally has only once one is issued; a
    route that is not a permutation of whole chunks is refused; one rank
    moves nothing."""
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    mesh = make_virtual_mesh((1, 4), (0, 1), device="cpu")
    m = 4
    route = [(u % m) * 2 + u // m for u in range(2 * m)]   # [x | z]
    with collectives.counting_collectives() as tally:
        assert set(tally) == set(collectives.KINDS)
        y = collectives.all_to_all(x, 0, "model", mesh, route)
    # rank 1's slots: unit 1 (rank 0's chunk 1) and unit 5 (rank 2's
    # chunk 1)
    assert torch.equal(y, torch.cat([x[4:], x[4:]]))
    assert tally[collectives.ALL_TO_ALL] == x.numel() * 4
    with pytest.raises(ValueError, match="permutation"):
        collectives.all_to_all(x, 0, "model", mesh, [0, 0, 1, 2, 3, 4, 5, 6])
    one = make_virtual_mesh((2, 1), device="cpu")
    assert collectives.all_to_all(x, 0, "model", one, [0, 1]) is x
    # the backward moves the gradient back by the inverse route
    xg = x.clone().requires_grad_()
    collectives.all_to_all(xg, 0, "model", mesh, route).sum().backward()
    assert xg.grad.shape == x.shape and torch.isfinite(xg.grad).all()

"""The port's layout layer against the reference's, with no processes:
every family's logical-axes trees, ``ShardConfig.resolve`` and
``logical_to_spec`` for every leaf of every architecture's parameter and
train-state axes (meshes 16×16, 2×16×16, 2×2, 1×4 and 2×1, every
combination of the six layout knobs), and each rank's block of every
leaf (``Placement``) against ``NamedSharding.devices_indices_map`` on
the reference's auto-axis ``jax.sharding.Mesh`` of forced CPU devices,
in one subprocess (``XLA_FLAGS`` must be set before JAX is imported).
The refusals of what the sharded step does not implement close the
file.  The reference's ``logical_to_spec`` reads only ``mesh.axis_names``
and ``mesh.shape``, so a stand-in mesh serves both packages.
"""

import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import get_config as j_get_config
from repro.models import attention as jattention
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.models import whisper as jwhisper
from repro.models import xlstm as jxlstm
from repro.models.model import Model as JModel
from repro.parallel import sharding as jsh
from repro.runconfig import RunConfig as JRunConfig
from repro.train import train_loop as jtl
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch.mesh import make_virtual_mesh
from repro_torch.models import attention, common, mlp, moe, ssm, transformer
from repro_torch.models import whisper, xlstm
from repro_torch.models.common import tree_flatten
from repro_torch.models.model import Model, init_local_decode_state
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import (ShardConfig, flatten_axes,
                                           set_ambient_mesh,
                                           reset_ambient_mesh)
from repro_torch.runconfig import RunConfig
from repro_torch.train import train_loop as ttl

ROOT = Path(__file__).resolve().parents[1]
KNOBS = ("fsdp", "tensor_parallel", "expert_parallel", "sequence_parallel",
         "shard_kv_seq_for_decode", "pod_in_batch")
COMBOS = [dict(zip(KNOBS, bits))
          for bits in itertools.product((False, True), repeat=len(KNOBS))]
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4},
          "2x1": {"data": 2, "model": 1}}
OPTS = [dict(optimizer=o, master_weights_f32=m)
        for o in ("adamw", "adafactor") for m in (True, False)]


class StandIn:
    """A mesh for the pure functions: axis names and sizes (and a rank,
    for the ambient mesh of the refusals)."""

    def __init__(self, shape, rank=0):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.rank = rank


def _plain(tree):
    """A tree as nested builtins, NamedTuples tagged with their name."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree).__name__,) + tuple(_plain(v) for v in tree)
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    return tree


# ---------------------------------------------------------------------------
# axes trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axes_trees_match_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert _plain(Model(cfg, device="cpu").param_axes()) \
        == _plain(JModel(jcfg).param_axes())
    for layout in ("bshd", "bhsd"):
        assert _plain(Model(cfg, device="cpu").decode_state_axes(
            RunConfig(kv_layout=layout))) == _plain(
            JModel(jcfg).decode_state_axes(JRunConfig(kv_layout=layout)))
    for kw in OPTS:
        assert _plain(ttl.state_axes(Model(cfg, device="cpu"),
                                     RunConfig(**kw))) \
            == _plain(jtl.state_axes(JModel(jcfg), JRunConfig(**kw)))


def test_module_axes_match_reference():
    """Each module's own axes functions, and the common helpers."""
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), j_get_config(arch)
        pairs = [(attention.axes, jattention.axes), (mlp.axes, jmlp.axes)]
        if cfg.n_experts:
            pairs.append((moe.axes, jmoe.axes))
        if cfg.is_encoder_decoder:
            pairs.append((whisper.axes, jwhisper.axes))
        else:
            pairs.append((transformer.axes, jtransformer.axes))
        pairs += [(ssm.axes, jssm.axes), (ssm.state_axes, jssm.state_axes),
                  (xlstm.mlstm_axes, jxlstm.mlstm_axes),
                  (xlstm.slstm_axes, jxlstm.slstm_axes),
                  (xlstm.mlstm_state_axes, jxlstm.mlstm_state_axes),
                  (xlstm.slstm_state_axes, jxlstm.slstm_state_axes)]
        for port, ref in pairs:
            assert _plain(port(cfg)) == _plain(ref(jcfg)), (arch, port)
        for layout in ("bshd", "bhsd"):
            assert attention.cache_axes(RunConfig(kv_layout=layout)) \
                == jattention.cache_axes(JRunConfig(kv_layout=layout))
            assert _plain(transformer.decode_state_axes(
                cfg, RunConfig(kv_layout=layout))) == _plain(
                jtransformer.decode_state_axes(
                    jcfg, JRunConfig(kv_layout=layout)))
    for kind in ("rmsnorm", "layernorm"):
        assert common.norm_axes(kind) == jcommon.norm_axes(kind)
    for bias in (False, True):
        assert common.dense_axes("a", None, bias=bias) \
            == jcommon.dense_axes("a", None, bias=bias)
    tree = {"w": ("embed", "ff"), "l": [{"b": ("ff",)}], "s": ()}
    assert common.stack_axes(tree) == jcommon.stack_axes(tree)


# ---------------------------------------------------------------------------
# resolve and logical_to_spec
# ---------------------------------------------------------------------------

def _leaves(arch):
    """The distinct (logical axes, global shape) of every leaf of the
    architecture's parameters and train states (each optimizer, masters
    on and off)."""
    m = Model(get_config(arch), device="cpu")
    out = set()
    for kw in OPTS:
        rc = RunConfig(**kw)
        shapes = tree_flatten(ttl.state_shapes(m, rc))[0]
        axes = flatten_axes(ttl.state_axes(m, rc))
        assert len(shapes) == len(axes)
        out |= {(tuple(a), tuple(s.shape)) for a, s in zip(axes, shapes)}
    return sorted(out, key=repr)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(arch, mesh):
    stand_in = StandIn(MESHES[mesh])
    leaves = _leaves(arch)
    for combo in COMBOS:
        rules = ShardConfig(**combo).resolve(stand_in)
        jrules = jsh.ShardConfig(**combo).resolve(stand_in)
        assert rules.rules == jrules.rules, combo
        for axes, shape in leaves:
            padded = axes + (None,) * (len(shape) - len(axes))
            for s in (None, shape):
                want = tuple(jsh.logical_to_spec(padded, jrules, stand_in, s))
                got = sh.logical_to_spec(padded, rules, stand_in, s)
                assert got == want, (combo, axes, s)
        assert sh.divisible_or_replicate(48, "heads", rules, stand_in) \
            == jsh.divisible_or_replicate(48, "heads", jrules, stand_in)


def test_spec_tree_and_param_shardings_follow_the_tree():
    cfg = get_config("yi-6b")
    mesh = StandIn(MESHES["2x2"])
    rules = ShardConfig().resolve(mesh)
    axes = Model(cfg, device="cpu").param_axes()
    specs = sh.spec_tree(axes, rules, mesh)
    jspecs = jsh.spec_tree(axes, jsh.ShardConfig().resolve(mesh), mesh)
    assert flatten_axes(specs) == [tuple(p) for p in jax.tree.leaves(
        jspecs, is_leaf=lambda x: isinstance(x, PartitionSpec))]
    pls = sh.param_shardings(axes, rules, mesh)
    assert [p.spec for p in tree_flatten(pls)[0]] == flatten_axes(specs)


# ---------------------------------------------------------------------------
# each rank's block against NamedSharding, on forced CPU devices
# ---------------------------------------------------------------------------

_INDEX_PROBE = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.models.model import Model
from repro.parallel.sharding import ShardConfig, shardings_for
from repro.runconfig import RunConfig
from repro.train import optimizer as jopt, train_loop as jtl

out = {}
for case in json.loads(sys.argv[1]):
    shape, names = case["mesh"], case["names"]
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), tuple(names))
    m = Model(get_config(case["arch"]))
    rc = RunConfig(**case["rc"], shard=ShardConfig(**case["shard"]))
    state = jax.eval_shape(lambda: jtl.TrainState(
        m.init(jax.random.key(0)), jopt.opt_init(m.init(jax.random.key(0)),
                                                 rc), jax.numpy.zeros(())))
    shards = jax.tree.leaves(shardings_for(state, jtl.state_axes(m, rc),
                                           rc.shard.resolve(mesh), mesh))
    devs = list(mesh.devices.flat)
    leaves = []
    for s, leaf in zip(shards, jax.tree.leaves(state)):
        idx = s.devices_indices_map(leaf.shape)
        leaves.append([[list(sl.indices(dim))[:2]
                        for sl, dim in zip(idx[d], leaf.shape)]
                       for d in devs])
    out[case["name"]] = leaves
print(json.dumps(out))
"""

INDEX_CASES = [("yi-6b", (2, 2), {}), ("yi-6b", (1, 4), {}),
               ("yi-6b", (2, 1), {"fsdp": False}),
               ("qwen2-vl-72b", (2, 2, 2), {}),
               ("qwen2-vl-72b", (2, 2, 2), {"pod_in_batch": False}),
               ("qwen1.5-4b", (1, 4), {"tensor_parallel": False}),
               ("mistral-nemo-12b", (2, 2), {}),
               ("codeqwen1.5-7b", (2, 2, 2), {}),
               ("grok-1-314b", (2, 4), {}),
               ("qwen2-moe-a2.7b", (2, 2), {"expert_parallel": False}),
               ("jamba-1.5-large-398b", (2, 2), {}),
               ("xlstm-1.3b", (1, 4), {}), ("whisper-tiny", (2, 2), {})]


@pytest.fixture(scope="module")
def reference_indices():
    cases = []
    for i, (arch, shape, shard) in enumerate(INDEX_CASES):
        rc = OPTS[i % len(OPTS)]
        cases.append({"name": str(i), "arch": arch, "mesh": list(shape),
                      "names": list(sh_names(shape)), "rc": rc,
                      "shard": shard})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", _INDEX_PROBE,
                          json.dumps(cases)], capture_output=True, text=True,
                         env=env, timeout=240)
    assert out.returncode == 0, out.stderr
    return cases, json.loads(out.stdout.strip().splitlines()[-1])


def sh_names(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


@pytest.mark.parametrize("i", range(len(INDEX_CASES)),
                         ids=[f"{a}-{'x'.join(map(str, s))}-{i}"
                              for i, (a, s, _) in enumerate(INDEX_CASES)])
def test_rank_blocks_match_named_sharding(reference_indices, i):
    cases, ref = reference_indices
    case = cases[i]
    mesh = StandIn(dict(zip(case["names"], case["mesh"])))
    model = Model(get_config(case["arch"]), device="cpu")
    rc = RunConfig(**case["rc"], shard=ShardConfig(**case["shard"]))
    pls = tree_flatten(ttl.state_placements(model, rc, mesh))[0]
    shapes = tree_flatten(ttl.state_shapes(model, rc))[0]
    want = ref[case["name"]]
    assert len(pls) == len(want)
    for pl, s, w in zip(pls, shapes, want):
        shape = tuple(s.shape)
        got = [[[sl.start, sl.stop] for sl in pl.index(shape, r)]
               for r in range(len(w))]
        assert got == w, (pl.spec, shape)
        assert [tuple(b - a for a, b in dims) for dims in got][0] \
            == pl.local_shape(shape)


# ---------------------------------------------------------------------------
# what the sharded step refuses
# ---------------------------------------------------------------------------

def _refusals():
    dense, sp = "yi-6b", ShardConfig(sequence_parallel=True)
    kv = ShardConfig(shard_kv_seq_for_decode=True)
    return [("sequence-parallel", dense, {"data": 1, "model": 2}, sp, "runs"),
            ("shard-kv-seq", dense, {"data": 2, "model": 1}, kv, "runs"),
            ("moe", "qwen2-moe-a2.7b", {"data": 2, "model": 1},
             ShardConfig(), "runs"),
            ("grok-moe", "grok-1-314b", {"data": 1, "model": 2},
             ShardConfig(), "runs"),
            ("mamba", "jamba-1.5-large-398b", {"data": 2, "model": 1},
             ShardConfig(), "runs"),
            ("xlstm", "xlstm-1.3b", {"data": 1, "model": 2}, ShardConfig(),
             "runs"),
            ("whisper", "whisper-tiny", {"data": 2, "model": 1}, None,
             "loss"),
            ("prefill", dense, {"data": 2, "model": 1}, None, "prefill"),
            ("decode", dense, {"data": 1, "model": 2}, None, "decode")]


@pytest.mark.parametrize("what,arch,mesh,shard,call", _refusals(),
                         ids=[r[0] for r in _refusals()])
def test_unported_layouts_are_refused_on_a_mesh(what, arch, mesh, shard,
                                                call):
    """Each raises ValueError naming its ROADMAP item before any
    collective (the stand-in mesh has no process group).  The layout
    knobs ported since (``"runs"``: sequence parallelism, ``shard_kv_seq``
    on a train step), the MoE families (expert parallelism) and the SSM
    families (``ssm_inner``) take a train step on that mesh instead (its
    chip (0, 0) as a virtual mesh, whose collectives act locally), and
    prefill and decode serve there (the chip's blocks of the weights and
    of the decode state, its rows of the batch: finite logits over the
    whole vocab)."""
    cfg = get_smoke_config(arch)
    model = Model(cfg, device="cpu")
    rc = RunConfig(param_dtype="float32", activation_dtype="float32",
                   **({"shard": shard} if shard else {}))
    B, S = 2, 8
    toks = torch.ones((B, S), dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    if call == "runs":
        vm = make_virtual_mesh(tuple(mesh.values()), device="cpu")
        assert sh.sequence_parallel_on(rc.shard, vm, S) \
            == shard.sequence_parallel
        with vm:
            state = ttl.init_local_state(model, 0, rc)
            _, mets = ttl.make_train_step(model, rc)(state, batch)
        assert torch.isfinite(mets["loss"]) and torch.isfinite(
            mets["grad_norm"])
        return
    if call in ("prefill", "decode"):
        vm = make_virtual_mesh(tuple(mesh.values()), device="cpu")
        glob = B * vm.shape["data"]
        with vm:
            params = model.init_blocks(0, ttl.param_placements(model, rc),
                                       vm.rank, dtype=torch.float32)
            if call == "prefill":
                logits, _ = model.prefill(params, {"tokens": toks}, 16, rc,
                                          batch=glob)
            else:
                state = init_local_decode_state(model, glob, 16, rc)
                logits, _ = model.decode_step(params, toks[:, :1], state,
                                              rc)
        assert logits.shape == (B, 1, cfg.vocab_size)
        assert torch.isfinite(logits).all()
        return
    params = model.init(0, dtype=torch.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.zeros((B, cfg.encoder_seq, cfg.d_model))
    token = set_ambient_mesh(StandIn(mesh))
    try:
        with pytest.raises(ValueError, match="ROADMAP"):
            if call == "loss":
                model.loss(params, batch, rc)
            elif call == "prefill":
                model.prefill(params, {"tokens": toks}, 16, rc)
            else:
                state = model.init_decode_state(B, 16, rc)
                model.decode_step(params, toks[:, :1], state, rc)
    finally:
        reset_ambient_mesh(token)
    # off the mesh the same call runs
    if call == "loss":
        loss, _ = model.loss(params, batch, rc)
        assert torch.isfinite(loss)

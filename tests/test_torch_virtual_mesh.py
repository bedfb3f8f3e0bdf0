"""One chip of a mesh run alone in its process (``launch.mesh.VirtualMesh``,
the virtual backend of ``parallel/collectives.py``), on the CPU.

(a) The virtual 2 x 2 mesh's chip (0, 0) against rank 0 of a real gloo
    2 x 2 world (``launch.mesh.spawn`` running
    ``torch_sharded_worker.count_cases``): one counted
    ``make_train_step`` step (``roofline.count_step``) of yi-6b's smoke
    config from ``init_local_state``, FSDP + TP, FSDP only and TP only,
    microbatch 1 and 2, remat none and block, and FSDP + TP under
    sequence parallelism (flash attention: its wrapper's calls counted);
    the MoE families under expert parallelism: qwen2-moe's experts split
    over the model axis (dense, dropping with two microbatches, dense
    under sequence parallelism) and grok-1's expert columns
    (``expert_parallel`` off); the SSM families with ``ssm_inner`` over
    the model axis: xlstm-1.3b and jamba, with and without sequence
    parallelism (the mLSTM wrapper's calls counted).
    FLOPs, collective bytes by kind, every state leaf's shape, the
    state's bytes and the flash calls (their q / k shapes) and launch
    counters must be equal, exactly: they depend on shapes only, and the
    virtual collectives allocate the real results' shapes.
(a') The same for serving: one counted ``Model.prefill`` or
    ``decode_step`` of each decoder-only family's smoke config on the
    virtual 2 x 2 chip against gloo rank 0
    (``torch_sharded_worker.serve_count_cases``; the weights from
    ``init_blocks``, the decode state from ``init_local_decode_state``):
    flash prefill with and without sequence parallelism, decode with FSDP
    on and off and under ``shard_kv_seq`` at B = 1 (the flash-decode
    combine), the MoE families, the xLSTM's prefill (its mLSTM calls
    counted) and decode, jamba's prefill and long decode: the same exact
    equalities, and the logits' shape.
(b) A virtual 16 x 16 step at smoke width: the state is drawn block by
    block (no sharded leaf's global shape is ever allocated), every leaf
    is its ``Placement.local_shape``, and the step's loss is finite and
    drops.
(c) For every architecture and applicable shape (smoke configs, family
    default), ``dryrun.layout_covers`` names exactly the ROADMAP item
    that a virtual 2 x 2 step (train, prefill or decode) raises, and
    None where it runs (every decoder-only family's cells: their logits
    finite); ``compile_cell(share="chip")`` refuses the others (whisper's)
    with that item before anything is built.
(d) Against the reference: ``repro.launch.dryrun.lower_cell`` on a 2 x 2
    auto-axis mesh of forced CPU devices, compiled and read by
    ``analyze_hlo`` (``torch_virtual_reference.py`` in a subprocess;
    remat none, a 4 x 16 train cell; with and without sequence
    parallelism; the MoE families, dense and dropping, their experts or
    their expert columns split over the model axis; xlstm-1.3b and
    jamba).  The port's per-chip FLOPs are held to the reference's
    per-device FLOPs within 2e-3 relative (the SSM families' by a pinned
    gap beyond it, ``REF_GAP``): the reference takes the
    label's logit by a one-hot contraction (a dot of 2·B·S·V/M FLOPs
    over the chip's rows and vocab columns, or its sequence block and
    the whole vocab under sequence parallelism: the same count), the
    port by a gather (no FLOPs), and the gap is exactly that dot.  Both
    ``coll_by_kind`` are printed; they differ (XLA all-gathers the FSDP
    weights again for the backward and per microbatch, and all-reduces
    the gradients where the port reduce-scatters them: ROADMAP C).
(d') The serving cells against the reference's ``lower_cell`` HLO the
    same way (``REF_SERVE_CASES``, a 4 x 16 cell, 1 x 16 for B = 1).
    Decode meets the reference's FLOPs exactly where nothing is
    recurrent; every other gap is pinned (``REF_SERVE_GAP``) and is
    design, each term counted from the two programs' products: a
    prefill's cache fill projects k and v again (XLA computes the
    identical dot once); a mamba layer's final state projects ``in_proj``
    again and the chunked SSD's last carried-state product, dead in the
    sequence pass, is computed; the reference's mLSTM final state
    projects k, v and the gates again and forms both heads on every
    device, where the port shares the projections and forms its head's
    state and gathers it; in decode the port updates a recurrent state
    whole on every model rank (the reference's layout keeps it whole),
    where XLA splits the update's per-head products over the model axis.
(e) ``report_from_counts`` with collectives equals ``analyze_hlo`` on a
    synthetic HLO that holds each collective kind.
(f) The three primitives' virtual rules and the byte counter.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.core.costmodel import Hardware as JHardware
from repro.launch import roofline as jrl
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.costmodel import Hardware
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_virtual_mesh, spawn
from repro_torch.models.common import tree_flatten
from repro_torch.models.config import (SHAPES_BY_NAME, ShapeCell,
                                       applicable_shapes)
from repro_torch.models.model import Model
from repro_torch.parallel import collectives
from repro_torch.models import transformer
from repro_torch.models.model import init_local_decode_state
from repro_torch.parallel.sharding import WHISPER_ITEM
from repro_torch.runconfig import runconfig_from_knobs
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as ttl
import torch_sharded_worker as worker

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 8
LAYOUTS = {"fsdp-tp": {}, "fsdp": {"tensor_parallel": False},
           "tp": {"fsdp_shard_params": False}}
CASES = {f"{lay}-mb{mb}-{remat}": dict(LAYOUTS[lay], microbatch=mb,
                                       remat_policy=remat,
                                       attention_impl="reference")
         for lay in LAYOUTS for mb in (1, 2) for remat in ("none", "block")}
CASES.update({f"fsdp-tp-sp-mb{mb}-{remat}": dict(
    microbatch=mb, remat_policy=remat, attention_impl="flash",
    sequence_parallel=True) for mb, remat in ((1, "none"), (2, "block"))})
# case -> arch for the MoE families (expert parallelism) and, below, the
# SSM families (ssm_inner); the rest are yi-6b's
MOE_ARCH = {"moe-qwen-dense-mb1-none": "qwen2-moe-a2.7b",
            "moe-qwen-drop-mb2-block": "qwen2-moe-a2.7b",
            "moe-qwen-dense-sp-mb1-none": "qwen2-moe-a2.7b",
            "moe-grok-noep-mb1-block": "grok-1-314b"}
CASES.update({
    "moe-qwen-dense-mb1-none": dict(microbatch=1, remat_policy="none",
                                    attention_impl="reference"),
    "moe-qwen-drop-mb2-block": dict(microbatch=2, remat_policy="block",
                                    attention_impl="reference",
                                    moe_impl="dropping"),
    "moe-qwen-dense-sp-mb1-none": dict(microbatch=1, remat_policy="none",
                                       attention_impl="flash",
                                       sequence_parallel=True),
    "moe-grok-noep-mb1-block": dict(microbatch=1, remat_policy="block",
                                    attention_impl="reference",
                                    expert_parallel=False)})
# the SSM families (ssm_inner over the model axis)
MOE_ARCH.update({"ssm-xlstm-mb1-none": "xlstm-1.3b",
                 "ssm-xlstm-sp-mb2-block": "xlstm-1.3b",
                 "ssm-jamba-mb2-block": "jamba-1.5-large-398b",
                 "ssm-jamba-sp-mb1-none": "jamba-1.5-large-398b"})
CASES.update({
    "ssm-xlstm-mb1-none": dict(microbatch=1, remat_policy="none"),
    "ssm-xlstm-sp-mb2-block": dict(microbatch=2, remat_policy="block",
                                   sequence_parallel=True),
    "ssm-jamba-mb2-block": dict(microbatch=2, remat_policy="block",
                                attention_impl="reference"),
    "ssm-jamba-sp-mb1-none": dict(microbatch=1, remat_policy="none",
                                  attention_impl="flash",
                                  sequence_parallel=True)})
SPAWN_TIMEOUT_S = 120
REFERENCE_TIMEOUT_S = 240
# the reference's cells: (name, arch, knobs) at a 4 x 16 train cell
REF_CELL = (16, 4)                                 # seq, global batch
REF_CASES = (("yi-fsdp-tp", "yi-6b", {"microbatch": 1}),
             ("yi-fsdp", "yi-6b", {"microbatch": 1,
                                   "tensor_parallel": False}),
             ("yi-tp-whole", "yi-6b", {"microbatch": 0,
                                       "fsdp_shard_params": False}),
             ("qwen15", "qwen1.5-4b", {"microbatch": 1}),
             ("yi-sp", "yi-6b", {"microbatch": 1, "sequence_parallel": True}),
             ("qwen15-sp", "qwen1.5-4b", {"microbatch": 1,
                                          "sequence_parallel": True}),
             ("qwen-moe-dense", "qwen2-moe-a2.7b", {"microbatch": 1,
                                                    "moe_impl": "dense"}),
             ("qwen-moe-drop", "qwen2-moe-a2.7b", {"microbatch": 1,
                                                   "moe_impl": "dropping"}),
             ("qwen-moe-sp", "qwen2-moe-a2.7b", {"microbatch": 1,
                                                 "sequence_parallel": True}),
             ("grok-moe", "grok-1-314b", {"microbatch": 1}),
             ("grok-moe-noep", "grok-1-314b", {"microbatch": 1,
                                               "expert_parallel": False}),
             ("xlstm", "xlstm-1.3b", {"microbatch": 1}),
             ("jamba", "jamba-1.5-large-398b", {"microbatch": 1}))
FLOPS_REL = 2e-3
# FLOPs the reference's compiled HLO counts beyond the port's, less the
# one-hot dot, where the two differ by design (ROADMAP C): its chunk
# scans carry the gradient into their initial state (mamba: one
# 2·b·c·N·H·P product a layer and microbatch, 7 layers x 2 microbatches x
# 16,384; the mLSTM: 253,952 a layer, of which 2·b·c·H·P² = 262,144 is
# that product and -8,192 two [c, P] products the port counts and XLA
# does not), and XLA rewrites the sLSTM's per-step recurrent-weight
# gradient, a product over the microbatch's one row, as an elementwise
# product that counts no FLOPs (-262,144, with +16,384 for the gradient
# into the initial state): 7 x 253,952 - 245,760 for the xLSTM
REF_GAP = {"xlstm": 1531904, "jamba": 229376}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ---------------------------------------------------------------------------
# (a) the virtual chip against rank 0 of a real gloo world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gloo_rank0(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("virtual")
    specs = []
    for name, knobs in CASES.items():
        arch = MOE_ARCH.get(name, "yi-6b")
        data = tmp / f"{arch}.npz"
        batch = _batch(get_smoke_config(arch))
        np.savez(data, **{f"batch_{k}": v for k, v in batch.items()})
        specs.append({"name": name, "arch": arch, "knobs": knobs,
                      "data": str(data), "batch": sorted(batch)})
    spec_path = tmp / "cases.json"
    spec_path.write_text(json.dumps(specs))
    out = tmp / "rank0.json"
    spawn(worker.count_cases, (2, 2), (str(spec_path), str(out)),
          device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    return {s["name"]: s for s in specs}, json.loads(out.read_text())


@pytest.mark.parametrize("case", list(CASES))
def test_virtual_chip_counts_what_rank0_counts(gloo_rank0, case):
    specs, got = gloo_rank0
    spec = specs[case]
    with np.load(spec["data"]) as z:
        batch = {k: torch.from_numpy(z[f"batch_{k}"]) for k in spec["batch"]}
    with make_virtual_mesh((2, 2), device="cpu") as mesh:
        want, loss = worker.count_case(spec, ttl.rank_batch(
            batch, runconfig_from_knobs(spec["knobs"]), mesh))
    real = got[case]
    assert real["flops"] == want["flops"] > 0
    assert real["coll_by_kind"] == want["coll_by_kind"]
    assert real["shapes"] == want["shapes"]
    assert real["bytes"] == want["bytes"]
    assert real["flash_calls"] == want["flash_calls"]
    assert real["launches"] == want["launches"]
    assert real["mlstm_calls"] == want["mlstm_calls"]
    assert bool(want["flash_calls"]) == ("-sp-" in case
                                         and "xlstm" not in case)
    assert bool(want["mlstm_calls"]) == ("xlstm" in case)
    live = {k for k, v in want["coll_by_kind"].items() if v}
    kinds = set(collectives.KINDS)
    if case.startswith("ssm-"):         # the [x | z] regroup
        kinds.add(collectives.ALL_TO_ALL)
    assert live == ({"all-reduce"} if case.startswith("tp-") else kinds)
    assert np.isfinite(loss) and np.isfinite(real["loss"])


# the serving cases: name -> (arch, mode, knobs, global batch)
SERVE_CASES = {
    "serve-yi-prefill-flash": ("yi-6b", "prefill",
                               {"attention_impl": "flash"}, B),
    "serve-yi-prefill-sp": ("yi-6b", "prefill",
                            {"attention_impl": "flash",
                             "sequence_parallel": True}, B),
    "serve-yi-decode": ("yi-6b", "decode", {"fsdp_shard_params": False}, B),
    "serve-yi-decode-fsdp": ("yi-6b", "decode", {}, B),
    "serve-yi-decode-kvseq-b1": ("yi-6b", "decode", {"shard_kv_seq": True},
                                 1),
    "serve-qwen-moe-prefill": ("qwen2-moe-a2.7b", "prefill", {}, B),
    "serve-grok-decode": ("grok-1-314b", "decode", {}, B),
    "serve-xlstm-prefill": ("xlstm-1.3b", "prefill", {}, B),
    "serve-xlstm-decode": ("xlstm-1.3b", "decode", {}, B),
    "serve-jamba-prefill": ("jamba-1.5-large-398b", "prefill", {}, B),
    "serve-jamba-decode-kvseq-b1": ("jamba-1.5-large-398b", "decode",
                                    {"shard_kv_seq": True}, 1),
}


@pytest.fixture(scope="module")
def gloo_rank0_serving(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("virtual-serve")
    specs = []
    for name, (arch, mode, knobs, batch) in SERVE_CASES.items():
        data = tmp / f"{name}.npz"
        np.savez(data, batch_tokens=_batch(get_smoke_config(arch))
                 ["tokens"][:batch])
        specs.append({"name": name, "arch": arch, "mode": mode,
                      "knobs": knobs, "global_batch": batch, "s_max": S,
                      "data": str(data)})
    spec_path = tmp / "cases.json"
    spec_path.write_text(json.dumps(specs))
    out = tmp / "rank0.json"
    spawn(worker.serve_count_cases, (2, 2), (str(spec_path), str(out)),
          device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    return {s["name"]: s for s in specs}, json.loads(out.read_text())


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_virtual_chip_serves_what_rank0_serves(gloo_rank0_serving, case):
    specs, got = gloo_rank0_serving
    with make_virtual_mesh((2, 2), device="cpu") as mesh:
        want, _ = worker.serve_count_case(specs[case], mesh)
    real = got[case]
    assert real["flops"] == want["flops"] > 0
    for k in ("coll_by_kind", "shapes", "bytes", "flash_calls",
              "mlstm_calls", "logits_shape"):
        assert real[k] == want[k], k
    arch, mode, knobs, batch = SERVE_CASES[case]
    rows = batch // 2 if batch % 2 == 0 else batch
    assert want["logits_shape"] == [rows, 1,
                                    get_smoke_config(arch).vocab_size]
    assert bool(want["flash_calls"]) == (knobs.get("attention_impl")
                                         == "flash")
    assert bool(want["mlstm_calls"]) == (arch == "xlstm-1.3b"
                                         and mode == "prefill")
    assert real["finite"]


# ---------------------------------------------------------------------------
# (b) the production mesh's chip at smoke width
# ---------------------------------------------------------------------------

class _Allocations(TorchDispatchMode):
    """The shapes of every tensor an op makes off the meta device."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and not t.is_meta:
                self.shapes.add(tuple(t.shape))
        return out


def test_virtual_16x16_state_is_drawn_block_by_block():
    cfg = get_smoke_config("yi-6b")
    rc = runconfig_from_knobs({"microbatch": 1, "remat_policy": "block"})
    model = Model(cfg, device="cpu")
    mesh = make_virtual_mesh(dryrun.make_production_mesh(), device="cpu")
    pls = tree_flatten(ttl.state_placements(model, rc, mesh))[0]
    shapes = tree_flatten(ttl.state_shapes(model, rc))[0]
    sharded = {tuple(sh.shape) for sh, pl in zip(shapes, pls)
               if pl.local_shape(tuple(sh.shape)) != tuple(sh.shape)}
    assert sharded
    with _Allocations() as made:
        state = ttl.init_local_state(model, 0, rc, mesh)
    assert not made.shapes & sharded, made.shapes & sharded
    for leaf, sh, pl in zip(tree_flatten(state)[0], shapes, pls):
        assert tuple(leaf.shape) == pl.local_shape(tuple(sh.shape))
    # the same seed draws the same blocks; another rank's differ
    again = ttl.init_local_state(model, 0, rc, mesh)
    other = ttl.init_local_state(model, 0, rc, make_virtual_mesh(
        dryrun.make_production_mesh(), (0, 3), device="cpu"))
    p0, p1, p3 = (tree_flatten(s.params)[0] for s in (state, again, other))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert any(a.shape == b.shape and not torch.equal(a, b)
               for a, b in zip(p0, p3))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    step = ttl.make_train_step(model, rc, topt.cosine_schedule(1e-2, 0, 100),
                               donate=True)
    losses = []
    with mesh:
        for _ in range(3):
            state, mets = step(state, batch)
            losses.append(float(mets["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_init_blocks_keeps_the_global_scale():
    """A block of a truncated-normal leaf has the global leaf's scale:
    1 / sqrt(global fan-in), not its own rows' (yi-6b's MLP up
    projection at full width, one layer: a [1, 256, 688] block of
    [1, 4096, 11008])."""
    cfg = get_config("yi-6b").scaled(n_layers=1)
    model = Model(cfg, device="cpu")
    mesh = make_virtual_mesh(dryrun.make_production_mesh(), device="cpu")
    pls = ttl.param_placements(model, runconfig_from_knobs({}), mesh)
    blocks = model.init_blocks(0, pls, mesh.rank, dtype=torch.float32)
    w = blocks["layers"][0]["mlp"]["up"]["w"]
    assert tuple(w.shape) == (1, 4096 // 16, 11008 // 16)
    want = 0.87962 / 4096 ** 0.5    # a ±2-truncated unit normal's std
    assert abs(float(w.std()) - want) < 0.02 * want, (float(w.std()), want)
    assert float(w.abs().max()) <= 2 * 4096 ** -0.5


# ---------------------------------------------------------------------------
# (c) layout_covers against the refusals
# ---------------------------------------------------------------------------

def _virtual_refusal(cfg, cell):
    """The ROADMAP item a virtual 2 x 2 step of the cell raises, or None
    when it runs (its loss, or its logits, finite): a serving cell's
    prefill of its rows, or one decode step against an empty state of
    the cell's blocks."""
    rc = dryrun.default_runconfig(cfg, cell)
    model = Model(cfg, device="cpu")
    toks = torch.from_numpy(_batch(cfg)["tokens"])
    try:
        with make_virtual_mesh((2, 2), device="cpu") as mesh:
            if cell.mode == "train":
                batch = {"tokens": toks[:2], "labels": toks[:2]}
                if cfg.is_encoder_decoder:
                    batch["frames"] = torch.zeros(
                        (2, cfg.encoder_seq, cfg.d_model),
                        dtype=torch.bfloat16)
                state = ttl.init_local_state(model, 0, rc, mesh)
                _, mets = ttl.make_train_step(model, rc)(state, batch)
                assert np.isfinite(float(mets["loss"]))
                return None
            rows = toks[transformer.serve_rows(B, rc, mesh)]
            inputs = {"tokens": rows}
            params = None
            if cfg.is_encoder_decoder:
                inputs["frames"] = torch.zeros(
                    (2, cfg.encoder_seq, cfg.d_model), dtype=torch.bfloat16)
            else:
                params = model.init_blocks(
                    0, ttl.param_placements(model, rc, mesh), mesh.rank)
            if cell.mode == "prefill":
                logits, _ = model.prefill(params, inputs, S, rc, batch=B)
            else:
                state = None if cfg.is_encoder_decoder else \
                    init_local_decode_state(model, B, S, rc, mesh)
                logits, _ = model.decode_step(params, rows[:, :1], state,
                                              rc)
            assert torch.isfinite(logits).all()
            assert logits.shape == (rows.shape[0], 1, cfg.vocab_size)
            return None
    except ValueError as e:
        assert str(e).endswith(WHISPER_ITEM), str(e)
        return WHISPER_ITEM


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_layout_covers_agrees_with_the_refusals(arch):
    cfg = get_smoke_config(arch)
    for cell in applicable_shapes(get_config(arch)):
        rc = dryrun.default_runconfig(cfg, cell)
        item = dryrun.layout_covers(cfg, cell, rc)
        assert item == _virtual_refusal(cfg, cell), (arch, cell.name)
        full = get_config(arch)
        want = "replica" if item else "chip"
        assert dryrun.resolve_share(full, cell) == want
        if item is not None:
            with pytest.raises(ValueError, match=item.split(" (")[0]):
                dryrun.compile_cell(full, cell, device="cpu", share="chip")


def test_a_refused_layout_knob_is_refused_on_the_chip():
    """The layout knobs the chip refused before sequence parallelism was
    ported (``sequence_parallel``, ``shard_kv_seq``) are covered on a
    train cell: ``layout_covers`` is None and ``compile_cell`` builds and
    runs the chip's step (yi-6b at smoke width, its batch and sequence
    cut), sequence-parallel where the knob asks for it."""
    cfg, cell = get_smoke_config("yi-6b"), SHAPES_BY_NAME["train_4k"]
    for knobs, sp in (({"sequence_parallel": True}, True),
                      ({"shard_kv_seq": True}, False)):
        assert dryrun.layout_covers(
            cfg, cell, dryrun.default_runconfig(cfg, cell, knobs)) is None
        rec = dryrun.compile_cell(cfg, cell, knobs, device="cpu",
                                  n_layers=2, steps=1,
                                  reduce={"batch": 2, "seq": 32})
        assert rec["share"] == "chip" and rec["sequence_parallel"] == sp
        assert rec["outputs_finite"] and rec["n_layers"] == 2
    # the replica's share is there all the same
    assert dryrun.resolve_share(cfg, cell, "replica") == "replica"
    with pytest.raises(ValueError, match="share must be"):
        dryrun.resolve_share(cfg, cell, "pod")


# ---------------------------------------------------------------------------
# (d) the reference's compiled per-device FLOPs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_counts(tmp_path_factory):
    spec = tmp_path_factory.mktemp("reference") / "runs.json"
    seq, batch = REF_CELL
    spec.write_text(json.dumps([
        {"name": name, "arch": arch,
         "knobs": dict(knobs, remat_policy="none"), "seq": seq,
         "batch": batch} for name, arch, knobs in REF_CASES]))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_virtual_reference.py"),
         str(spec)], capture_output=True, text=True, env=env,
        timeout=REFERENCE_TIMEOUT_S, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name,arch,knobs", REF_CASES,
                         ids=[c[0] for c in REF_CASES])
def test_chip_flops_meet_the_reference(reference_counts, name, arch, knobs):
    cfg = get_smoke_config(arch)
    seq, batch = REF_CELL
    cell = ShapeCell("tiny", seq_len=seq, global_batch=batch, mode="train")
    rc = dryrun.default_runconfig(cfg, cell, dict(knobs,
                                                  remat_policy="none"))
    mesh = make_virtual_mesh((2, 2), device="cpu")
    low = dryrun.lower_cell(cfg, cell, rc, mesh, device="cpu",
                            n_layers=cfg.n_layers)
    counts, loss = roofline.count_step(low.step)
    ref = reference_counts[name]
    print(f"{name}: port coll_by_kind {counts.coll_by_kind}, reference "
          f"{ref['coll_by_kind']}")
    vocab = cfg.vocab_size // (2 if rc.shard.tensor_parallel else 1)
    one_hot = 2 * low.batch * seq * vocab
    assert ref["flops"] - counts.flops == one_hot + REF_GAP.get(name, 0)
    if name not in REF_GAP:
        assert abs(counts.flops - ref["flops"]) <= FLOPS_REL * ref["flops"]
    assert np.isfinite(float(loss))


# the serving cells against the reference's compiled HLO: (name, arch,
# mode, knobs, global batch) at a cell of REF_CELL's sequence length
REF_SERVE_CASES = (
    ("yi-prefill", "yi-6b", "prefill", {}, 4),
    ("yi-prefill-flash-sp", "yi-6b", "prefill",
     {"attention_impl": "flash", "sequence_parallel": True}, 4),
    ("yi-decode", "yi-6b", "decode", {}, 4),
    ("yi-decode-kvseq-b1", "yi-6b", "decode", {"shard_kv_seq": True}, 1),
    ("qwen-moe-prefill", "qwen2-moe-a2.7b", "prefill", {}, 4),
    ("qwen-moe-decode", "qwen2-moe-a2.7b", "decode", {}, 4),
    ("grok-decode", "grok-1-314b", "decode", {}, 4),
    ("xlstm-prefill", "xlstm-1.3b", "prefill", {}, 4),
    ("xlstm-decode", "xlstm-1.3b", "decode", {}, 4),
    ("jamba-prefill", "jamba-1.5-large-398b", "prefill", {}, 4),
    ("jamba-decode", "jamba-1.5-large-398b", "decode", {}, 4),
)
# reference minus port FLOPs by design (module docstring (d')), at the
# smoke configs' widths, 2 rows of 16 tokens a chip (B = 4 over data 2):
# an attention layer's cache fill projects k and v again, 2 x 2·B·S·d x
# kv_dim / 2 = 131,072 (yi-6b, 2 layers) or 262,144 (qwen2-moe's 4 kv
# heads, 2 layers) a layer; a mamba layer's final state projects in_proj
# again (2·B·S·d x 2·d_inner / 2 = 524,288) and the SSD's last carried
# state (2·B·S·N x d_inner / 2 = 32,768) is dead in the sequence pass:
# 557,056 a layer, 7 layers, with jamba's attention layer's 131,072; the
# reference's mLSTM final state projects k and v (2 x 524,288) and the
# gates (16,384) again and forms the other head's C and n (262,144 +
# 4,096), less the chunkwise's dead last carried state (262,144) and an
# n product (4,096) of the port's: +1,064,960 a layer, 7 layers; in
# decode the port updates the whole recurrent state on each model rank,
# XLA half of its per-head products: the mLSTM's other head's C q and
# n q, 2·B·P·(P + 1) = 16,640 a layer (7), mamba's C s, 2·B·N·d_inner / 2
# = 2,048 a layer (7)
REF_SERVE_GAP = {"yi-prefill": -262144, "yi-prefill-flash-sp": -262144,
                 "qwen-moe-prefill": -524288,
                 "xlstm-prefill": 7 * 1064960, "xlstm-decode": -7 * 16640,
                 "jamba-prefill": -7 * 557056 - 131072,
                 "jamba-decode": -7 * 2048}


@pytest.fixture(scope="module")
def reference_serve_counts(tmp_path_factory):
    spec = tmp_path_factory.mktemp("reference-serve") / "runs.json"
    seq, _ = REF_CELL
    spec.write_text(json.dumps([
        {"name": name, "arch": arch, "knobs": knobs, "seq": seq,
         "batch": batch, "mode": mode}
        for name, arch, mode, knobs, batch in REF_SERVE_CASES]))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_virtual_reference.py"),
         str(spec)], capture_output=True, text=True, env=env,
        timeout=REFERENCE_TIMEOUT_S, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name,arch,mode,knobs,batch", REF_SERVE_CASES,
                         ids=[c[0] for c in REF_SERVE_CASES])
def test_chip_serving_flops_meet_the_reference(reference_serve_counts, name,
                                               arch, mode, knobs, batch):
    cfg = get_smoke_config(arch)
    seq, _ = REF_CELL
    cell = ShapeCell("tiny", seq_len=seq, global_batch=batch, mode=mode)
    rc = dryrun.default_runconfig(cfg, cell, knobs)
    mesh = make_virtual_mesh((2, 2), device="cpu")
    low = dryrun.lower_cell(cfg, cell, rc, mesh, device="cpu",
                            n_layers=cfg.n_layers)
    counts, logits = roofline.count_step(low.step)
    ref = reference_serve_counts[name]
    print(f"{name}: port coll_by_kind {counts.coll_by_kind}, reference "
          f"{ref['coll_by_kind']}")
    gap = REF_SERVE_GAP.get(name, 0)
    assert ref["flops"] - counts.flops == gap
    if not gap:
        assert abs(counts.flops - ref["flops"]) <= FLOPS_REL * ref["flops"]
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# (e) the collective term against analyze_hlo
# ---------------------------------------------------------------------------

COLL_HLO = """\
HloModule collectives

%cond (p: (s32[], bf16[64,32])) -> pred[] {
  %p = (s32[], bf16[64,32]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %c = s32[] constant(6)
  ROOT %lt = pred[] compare(%i, %c), direction=LT
}

%body (p: (s32[], bf16[64,32])) -> (s32[], bf16[64,32]) {
  %p = (s32[], bf16[64,32]) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %x = bf16[64,32] get-tuple-element(%p), index=1
  %one = s32[] constant(1)
  %ni = s32[] add(%i, %one)
  %g = bf16[256,32] all-gather(%x), dimensions={0}, replica_groups={}
  %d = f32[64,64] dot(%x, %x), lhs_contracting_dims={1}, rhs_contracting_dims={1}
  %rs = f32[16,64] reduce-scatter(%d), dimensions={0}, to_apply=%sum
  %ar = f32[64,64] all-reduce(%d), replica_groups={}, to_apply=%sum
  %arp = f32[64,32] all-reduce(%x), replica_groups={}, to_apply=%sum.promoted
  ROOT %t = (s32[], bf16[64,32]) tuple(%ni, %x)
}

%sum (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(%a, %b)
}

%sum.promoted (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(%a, %b)
}

ENTRY %main (arg: bf16[64,32]) -> bf16[64,32] {
  %arg = bf16[64,32] parameter(0)
  %zero = s32[] constant(0)
  %t0 = (s32[], bf16[64,32]) tuple(%zero, %arg)
  %w = (s32[], bf16[64,32]) while(%t0), condition=%cond, body=%body
  ROOT %out = bf16[64,32] get-tuple-element(%w), index=1
}
"""
HARDWARE = {"v5e": {}, "memory-bound": {"hbm_bw": 1e3},
            "compute-bound": {"peak_flops": 1e3}}


@pytest.mark.parametrize("hw", list(HARDWARE))
def test_report_from_counts_prices_each_kind_as_analyze_hlo(hw):
    want = jrl.analyze_hlo(COLL_HLO, JHardware(**HARDWARE[hw]))
    assert set(want.coll_by_kind) == {"all-gather", "reduce-scatter",
                                      "all-reduce"}
    assert want.coll_by_kind["all-reduce"] == 6 * (64 * 64 * 4
                                                   + 64 * 32 * 4 / 2)
    got = roofline.report_from_counts(want.flops, want.bytes_proxy,
                                      want.coll_by_kind,
                                      Hardware(**HARDWARE[hw]))
    for k in ("collective_bytes", "coll_by_kind", "compute_s", "memory_s",
              "collective_s", "step_s", "dominant"):
        assert getattr(got, k) == getattr(want, k), k


# ---------------------------------------------------------------------------
# (f) the virtual rules and the counter
# ---------------------------------------------------------------------------

def test_virtual_primitives_and_their_bytes():
    mesh = make_virtual_mesh((4, 2), (1, 1), device="cpu")
    assert (mesh.rank, mesh.coords, mesh.backend) == \
        (3, {"data": 1, "model": 1}, "virtual")
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.group("data")
    x = torch.arange(24, dtype=torch.bfloat16).reshape(2, 4, 3)
    with collectives.counting_collectives() as tally:
        g = collectives.gather(x, 1, ("data",), mesh)
        s = collectives._scatter_axis(x, 1, "data", mesh, summed=True)
        r = collectives.all_reduce(x, ("data", "model"), mesh,
                                   dtype=torch.float32)
        m = collectives.all_reduce(x, "data", mesh, op="max")
    assert torch.equal(g, torch.cat([x] * 4, dim=1))
    assert torch.equal(s, 4 * x[:, 1:2])
    assert torch.equal(r, 8 * x) and r.dtype == torch.bfloat16
    assert torch.equal(m, x)
    n = x.numel()
    assert tally == {"all-gather": 4 * n * 2, "reduce-scatter": n // 4 * 2,
                     # float32 over data then model, bf16 once for max
                     "all-reduce": 2 * n * 4 + n * 2}
    with pytest.raises(RuntimeError, match="already being counted"):
        with collectives.counting_collectives():
            with collectives.counting_collectives():
                pass
    with pytest.raises(ValueError, match="virtual mesh"):
        collectives.gather_to_host(x, None, mesh)
    with pytest.raises(ValueError, match="not on a mesh"):
        make_virtual_mesh((2, 2), (2, 0), device="cpu")
    assert make_virtual_mesh({"pod": 2, "data": 16, "model": 16},
                             {"pod": 1}, device="cpu").rank == 256

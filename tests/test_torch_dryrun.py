"""The port's product-cluster launch layer against the reference's, on
the CPU: ``launch/dryrun.py`` (``default_runconfig``, ``compile_cell``),
``launch/mesh.py`` (``make_production_mesh``) and ``launch/roofline.py``
(``report_from_counts``, ``model_flops``, ``count_step``).

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices
for the whole process, so the reference's side of the run-config and
mesh checks runs in one subprocess of its own.  The roofline terms are
held to the reference's HLO analysis of ``SYNTH_HLO``
(``tests/test_tuner_integration.py``) exactly; ``count_step`` to a hand
count of the step's matrix products from the smoke config's shapes.
``compile_cell(device="cpu")`` runs each mode at smoke width under
``reduce`` and returns the reference's record keys (read from the
reference's source, where ``compile_cell`` builds its record).
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.costmodel import Hardware as JHardware
from repro.launch import roofline as jrl
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.costmodel import Hardware
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import SHAPES_BY_NAME, applicable_shapes
from repro_torch.models.model import Model
from repro_torch.runconfig import RunConfig
from repro_torch.train import train_loop as ttl
from test_tuner_integration import SYNTH_HLO

ROOT = Path(__file__).resolve().parents[1]
KNOBS = {"microbatch": 2, "remat_policy": "dots", "attention_impl": "flash",
         "fsdp_shard_params": False, "optimizer": "adafactor",
         "grad_allreduce_dtype": "bfloat16", "tensor_parallel": False,
         "shard_kv_seq": False, "log_verbosity": 3}
REDUCE = {"batch": 2, "seq": 16}

# the reference's side, in a process of its own (its dryrun sets XLA_FLAGS)
_REFERENCE = r"""
import dataclasses, json, sys
from repro.launch import dryrun
from repro.configs import ARCH_IDS, get_config
from repro.launch.mesh import make_production_mesh
from repro.models.config import applicable_shapes
knobs = json.loads(sys.argv[1])
rcs = {}
for a in ARCH_IDS:
    cfg = get_config(a)
    for cell in applicable_shapes(cfg):
        for tag, kn in (("none", None), ("knobs", knobs)):
            rc = dryrun.default_runconfig(cfg, cell, kn)
            rcs[f"{a}|{cell.name}|{tag}"] = json.dumps(
                dataclasses.asdict(rc), sort_keys=True, default=str)
meshes = {str(mp): list(make_production_mesh(multi_pod=mp).shape.items())
          for mp in (False, True)}
print(json.dumps({"rcs": rcs, "meshes": meshes}))
"""


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE, json.dumps(KNOBS)],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_default_runconfig_matches_reference(reference, arch):
    cfg = get_config(arch)
    for cell in applicable_shapes(cfg):
        for tag, kn in (("none", None), ("knobs", KNOBS)):
            rc = dryrun.default_runconfig(cfg, cell, kn)
            got = json.dumps(dataclasses.asdict(rc), sort_keys=True,
                             default=str)
            assert got == reference["rcs"][f"{arch}|{cell.name}|{tag}"], \
                (arch, cell.name, tag)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_matches_reference(reference, multi_pod):
    want = [tuple(kv) for kv in reference["meshes"][str(multi_pod)]]
    assert list(make_production_mesh(multi_pod=multi_pod).items()) == want


# V5E; a card whose memory term leads; one whose compute term leads
HARDWARE = {"v5e": {}, "memory-bound": {"hbm_bw": 1e3},
            "compute-bound": {"peak_flops": 1e3}}


@pytest.mark.parametrize("hw", list(HARDWARE))
def test_report_from_counts_matches_analyze_hlo(hw):
    want = jrl.analyze_hlo(SYNTH_HLO, JHardware(**HARDWARE[hw]))
    got = roofline.report_from_counts(
        want.flops, want.bytes_proxy, want.coll_by_kind,
        Hardware(**HARDWARE[hw]))
    for k in ("collective_bytes", "coll_by_kind", "compute_s", "memory_s",
              "collective_s", "step_s", "dominant"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.terms() == want.terms()
    assert got.dominant == {"v5e": "collective", "memory-bound": "memory",
                            "compute-bound": "compute"}[hw]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_matches_reference(arch):
    n = get_config(arch).active_param_count()
    for cell in applicable_shapes(get_config(arch)):
        tokens = cell.global_batch * (1 if cell.mode == "decode"
                                      else cell.seq_len)
        train = cell.mode == "train"
        assert roofline.model_flops(n, tokens, train) == \
            jrl.model_flops(n, tokens, train)


def _hand_count(cfg, B, S, recompute: bool) -> int:
    """The smoke step's matrix products from the shapes: each forward
    product's 2mnk, its backward's two of the same size (both operands
    need a gradient), and under ``full`` the layers' forward once more
    (the head is outside the remat groups) but for each layer's MLP down
    projection: nothing in the backward reads its output, and torch's
    non-reentrant checkpoint stops recomputing once every saved tensor
    is back."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    per_token = 2 * (d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
                     + 3 * d * cfg.d_ff)
    attn = 2 * 2 * cfg.n_heads * S * S * hd      # QK^T and PV, all pairs
    layers = cfg.n_layers * (B * S * per_token + B * attn)
    head = B * S * 2 * d * cfg.vocab_size
    down = cfg.n_layers * B * S * 2 * cfg.d_ff * d
    return 3 * (layers + head) + (layers - down if recompute else 0)


@pytest.mark.parametrize("remat", ["none", "full", "block"])
def test_count_step_equals_hand_count(remat):
    cfg = get_smoke_config("yi-6b")
    B, S = 2, 24
    rc = RunConfig(attention_impl="reference", remat_policy=remat)
    model = Model(cfg, device="cpu")
    state = ttl.init_state(model, 0, rc)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = ttl.make_train_step(model, rc)
    counts, (_, metrics) = roofline.count_step(lambda: step(state, batch))
    assert counts.flops == _hand_count(cfg, B, S, remat != "none")
    assert counts.kernel_flops == counts.kernel_bytes == 0
    assert set(counts.bytes_by_device) == {"cpu"}
    assert counts.hbm_bytes > 0 and np.isfinite(float(metrics["loss"]))


@pytest.mark.parametrize("remat", ["none", "block"])
def test_count_step_changes_no_number(remat):
    """The counted step computes what the uncounted one does, bit for bit
    (``FlopCounterMode`` itself would run ``silu_backward`` decomposed and
    move the gradient), and counts the FLOPs that mode counts."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = get_smoke_config("yi-6b")
    cell = SHAPES_BY_NAME["train_4k"]
    rc = dryrun.default_runconfig(cfg, cell, {"remat_policy": remat})

    def low():
        return dryrun.lower_cell(cfg, cell, rc, make_production_mesh(),
                                 device="cpu", n_layers=cfg.n_layers,
                                 reduce=REDUCE)
    counted, plain, mode = low(), low(), low()
    counts, loss = roofline.count_step(counted.step)
    assert float(loss) == float(plain.step())
    assert float(counted.grad_norms[0]) == float(plain.grad_norms[0])
    with FlopCounterMode(display=False) as m:
        mode.step()
    assert counts.flops - counts.kernel_flops == m.get_total_flops()


def test_count_step_adds_the_kernels_work():
    from repro_torch import kernels

    def step():
        kernels.add_work(lambda a, b: (a, b), 7, 40)
        kernels.add_work(lambda: (5, 2))
        return torch.ones(3)

    counts, out = roofline.count_step(step)
    assert (counts.kernel_flops, counts.kernel_bytes) == (12, 42)
    assert counts.flops == 12 and counts.hbm_bytes == 42 + 12  # + ones(3)
    kernels.add_work(lambda: 1 / 0)        # no tally open: not evaluated


def _reference_record_keys():
    """Keys of the record the reference's ``compile_cell`` builds, and of
    its ``roofline`` entry, read from its source."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "compile_cell")
    rec = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "record")
    keys = [k.value for k in rec.keys]
    roof = rec.values[keys.index("roofline")]
    return set(keys), {k.value for k in roof.keys}


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_compile_cell_cpu_record(shape):
    cfg = get_smoke_config("yi-6b")
    cell = SHAPES_BY_NAME[shape]
    rec = dryrun.compile_cell(cfg, cell, device="cpu", reduce=REDUCE,
                              share="replica")
    keys, roof_keys = _reference_record_keys()
    assert keys <= set(rec) and roof_keys <= set(rec["roofline"])
    assert "measured_step_s" in rec and "tokens_per_s" in rec
    assert rec["mesh"] == "1xCPU" and rec["chips"] == 1
    assert rec["share"] == "replica" and rec["chip"] is None
    assert rec["scored_step_s"] == rec["measured_step_s"]
    assert rec["mfu"] is None and rec["card"] == "cpu"  # no card, no mfu
    assert rec["mode"] == cell.mode and rec["outputs_finite"]
    assert rec["measured_step_s"] > 0 and len(rec["step_times_s"]) == 2
    assert rec["roofline"]["flops_per_device"] > 0
    assert rec["roofline"]["collective_s"] == 0.0
    B = REDUCE["batch"]
    assert rec["batch"] == B and rec["seq_len"] == REDUCE["seq"]
    assert any(r.startswith("seq_len") for r in rec["reduced"])
    if shape == "train_4k":
        rc = dryrun.default_runconfig(cfg, cell)
        assert rec["runconfig"]["remat_policy"] == "block"
        # the same step run directly: weights, state and batch from seed 0
        model = Model(cfg, device="cpu")
        gen = torch.Generator().manual_seed(0)
        toks = torch.randint(0, cfg.vocab_size, (B, REDUCE["seq"] + 1),
                             generator=gen, dtype=torch.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        step = ttl.make_train_step(model, rc, donate=True)
        state, metrics = step(ttl.init_state(model, 0, rc), batch)
        assert rec["step1_loss"] == float(metrics["loss"])
        assert rec["step1_grad_norm"] == float(metrics["grad_norm"])
        # every step runs on the same batch: step 2 is the same step again
        _, again = step(state, batch)
        assert rec["step_losses"][:2] == [float(metrics["loss"]),
                                          float(again["loss"])]
        assert len(rec["step_losses"]) == 3
        assert rec["model_flops_6nd"] == roofline.model_flops(
            cfg.active_param_count(), B * REDUCE["seq"], True)
    else:
        assert rec["step1_loss"] is None and rec["step_losses"] is None
        assert rec["step1_grad_norm"] is None
    assert rec["memory"]["estimated_gb"] > rec["memory"]["state_size_gb"]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_compile_cell_cpu_record_chip_share(multi_pod):
    """train_4k defaults to one chip's share: the reference's record keys,
    the mesh and chip, counted collectives priced at ``ici_bw``, and the
    score by the reference's combine rule over the measured step; the
    6ND FLOPs are the whole mesh's, spread over its chips."""
    cfg = get_smoke_config("yi-6b")
    cell = SHAPES_BY_NAME["train_4k"]
    assert dryrun.resolve_share(cfg, cell) == "chip"
    rec = dryrun.compile_cell(cfg, cell, device="cpu", reduce=REDUCE,
                              multi_pod=multi_pod)
    keys, roof_keys = _reference_record_keys()
    assert keys <= set(rec) and roof_keys <= set(rec["roofline"])
    chips = 512 if multi_pod else 256
    assert (rec["share"], rec["mesh"], rec["chips"]) == (
        "chip", "2x16x16" if multi_pod else "16x16", chips)
    assert rec["chip"] == ({"pod": 0, "data": 0, "model": 0} if multi_pod
                           else {"data": 0, "model": 0})
    roof = rec["roofline"]
    assert set(roof["coll_by_kind"]) == {"all-reduce", "all-gather",
                                         "reduce-scatter"}
    assert roof["collective_bytes_per_device"] == sum(
        roof["coll_by_kind"].values())
    assert roof["collective_s"] == roof["collective_bytes_per_device"] \
        / roofline.H100.ici_bw > 0
    m, x = rec["measured_step_s"], roof["collective_s"]
    assert rec["scored_step_s"] == max(m, x) + 0.15 * min(m, x)
    # a chip's rows are its data rank's; 6ND counts every data rank's
    assert rec["batch"] == REDUCE["batch"] and rec["n_layers"] == 2
    dp = 32 if multi_pod else 16
    assert rec["model_flops_6nd"] == roofline.model_flops(
        cfg.active_param_count(), dp * REDUCE["batch"] * REDUCE["seq"], True)
    assert rec["useful_flops_ratio"] == rec["model_flops_6nd"] / (
        roof["flops_per_device"] * chips)
    assert rec["mfu"] is None and rec["outputs_finite"]
    assert rec["memory"]["estimated_gb"] > rec["memory"]["state_size_gb"]
    assert np.isfinite(rec["step1_loss"])


@pytest.mark.parametrize("share,multi_pod", [("chip", False),
                                             ("chip", True),
                                             ("replica", False)])
def test_artifacts_never_collide_with_the_reference(share, multi_pod):
    out = dryrun._artifact("yi-6b", "train_4k", multi_pod, share,
                           torch.device("cpu"))
    pod = ".multi-pod" if multi_pod else ""
    want = {"chip": f"yi_6b.train_4k{pod}."
                    f"{'2x16x16' if multi_pod else '16x16'}-chip.1xCPU.json",
            "replica": "yi_6b.train_4k.1xCPU.json"}[share]
    assert out.name == want and out.parent == dryrun.ARTIFACTS
    assert not out.name.endswith(("16x16.json", "2x16x16.json"))


def test_chip_estimate_counts_the_chips_blocks():
    """At one chip's share the state is the placements' local blocks
    (yi-6b under the family default: ~54 M parameters a chip, 5.5 B
    layer parameters over 256 chips and the embedding and head over the
    model axis' 16), and the whole model fits the card."""
    cfg, cell = get_config("yi-6b"), SHAPES_BY_NAME["train_4k"]
    rc = dryrun.default_runconfig(cfg, cell)
    mesh = dryrun.production_chip()
    state, n, largest = dryrun._chip_state(cfg, rc, mesh, True)
    d, emb = cfg.d_model, cfg.vocab_size * cfg.d_model
    matrices = cfg.n_layers * (2 * d * cfg.q_dim + 2 * d * cfg.kv_dim
                               + 3 * d * cfg.d_ff)
    norms = (2 * cfg.n_layers + 1) * d                   # replicated
    assert n == matrices // 256 + norms + 2 * emb // 16 == 54_661_120
    assert largest == emb // 16
    # 20 B a parameter (bf16 weight, float32 master and moments, the
    # gradients) and the scalar step counters
    assert 0 < state - n * dryrun._state_bytes_per_param(rc, True) <= 16
    chip = dryrun.estimate_bytes(cfg, rc, "train", 16, 4096, mesh)
    assert chip < dryrun.estimate_bytes(cfg, rc, "train", 16, 4096) / 8
    assert dryrun.fit_depth(cfg, rc, roofline.H100.hbm_bytes, batch=16,
                            seq=4096, mesh=mesh) == cfg.n_layers


def test_serving_estimate_counts_the_build_the_stream_and_the_reads(
        monkeypatch):
    """A serving cell's estimate at one chip's share is at least its build
    (the largest leaf drawn in float32 beside the state: jamba's
    long_500k chip peaks there), a prefill's counts the layer's stream
    copies, and decode's reads only the kv heads the chip's q heads
    read (yi-6b's 2 q heads read 1 of the cache's 4)."""
    mesh = dryrun.production_chip()
    jamba, long = get_config("jamba-1.5-large-398b"), SHAPES_BY_NAME[
        "long_500k"]
    rc = dryrun.default_runconfig(jamba, long)
    state, _, largest = dryrun._chip_state(jamba, rc, mesh, False)
    est = dryrun.estimate_bytes(jamba, rc, "decode", 1, long.seq_len, mesh,
                                1)
    assert est == state + dryrun.INIT_TEMPORARIES * largest
    yi = get_config("yi-6b").scaled(n_layers=1)
    cell = SHAPES_BY_NAME["prefill_32k"]
    rc = dryrun.default_runconfig(yi, cell, {"attention_impl": "flash"})
    B, S = 2, cell.seq_len
    est = dryrun.estimate_bytes(yi, rc, "prefill", B, S, mesh, 32)
    monkeypatch.setattr(dryrun, "SERVE_STREAM_COPIES",
                        {"activation": 0, "float32": 0})
    assert est - dryrun.estimate_bytes(yi, rc, "prefill", B, S, mesh, 32) \
        == B * S * yi.d_model * (4 * 2 + 4 * 4)
    monkeypatch.undo()
    cell = SHAPES_BY_NAME["decode_32k"]
    rc = dryrun.default_runconfig(yi, cell)
    bf16, int8 = (dryrun.estimate_bytes(yi, r, "decode", 8, cell.seq_len,
                                        mesh, 128)
                  for r in (rc, rc.replace(kv_cache_dtype="int8")))
    cache = 2 * 8 * cell.seq_len * yi.kv_dim           # whole over model
    # an int8 cache holds a byte an element, and decode dequantizes the
    # one kv head it reads to bf16 (2 x 8 x S x 128 x 2 bytes)
    assert bf16 - int8 == cache - 2 * 8 * cell.seq_len * 128 * 2


def test_compile_cell_cuts_depth_and_records_it():
    cfg = get_smoke_config("yi-6b").scaled(n_layers=4)
    rec = dryrun.compile_cell(cfg, SHAPES_BY_NAME["prefill_32k"],
                              device="cpu", n_layers=2, reduce=REDUCE,
                              steps=1)
    assert rec["n_layers"] == 2 and "n_layers 4 -> 2" in rec["reduced"]


def test_fit_depth_whole_periods():
    cfg = get_config("yi-6b")
    cell = SHAPES_BY_NAME["train_4k"]
    rc = dryrun.default_runconfig(cfg, cell)
    shape = dict(mode="train", batch=16, seq=4096)
    n = dryrun.fit_depth(cfg, rc, 80e9, **shape)
    room = dryrun.FIT_FRACTION * 80e9

    def est(layers):
        return dryrun.estimate_bytes(cfg.scaled(n_layers=layers), rc,
                                     **shape)
    assert 1 <= n < cfg.n_layers
    assert est(n) <= room < est(n + 1)
    # the estimate counts the gradients and activations beside the state
    state = cfg.scaled(n_layers=n).param_count() * 14    # bf16, master, AdamW
    assert est(n) > state + cfg.scaled(n_layers=n).param_count() * 6
    assert dryrun.estimate_bytes(
        cfg, rc.replace(remat_policy="none"), **shape) > est(cfg.n_layers)
    assert dryrun.fit_depth(cfg, rc, 80e9, mode="decode", batch=1,
                            seq=16) == cfg.n_layers
    with pytest.raises(dryrun.DoesNotFit) as refused:     # not even one
        dryrun.fit_depth(cfg, rc, 1e9, **shape)
    assert refused.value.need_bytes == est(1) > refused.value.room_bytes \
        == dryrun.FIT_FRACTION * 1e9
    assert f"{est(1) / 1e9:.2f} GB" in str(refused.value)
    xl = get_config("xlstm-1.3b")                        # period of 8
    assert dryrun.fit_depth(xl, rc, 80e9, **shape) % len(xl.pattern) == 0


class _Depth(Exception):
    pass


@pytest.mark.parametrize("arch", ["yi-6b", "qwen1.5-4b"])
def test_cell_depth_does_not_follow_the_knobs(arch, monkeypatch):
    """Every config of a cell runs the same model: with no depth given,
    compile_cell cuts to the family default's depth, whatever the
    optimizer, master weights, remat or microbatch, although their state
    and activations alone would fit different depths."""
    cfg = get_config(arch)
    cell = SHAPES_BY_NAME["train_4k"]

    def depth(cfg, cell, rc, mesh, dev, n_layers, steps, reduce):
        raise _Depth(n_layers)
    monkeypatch.setattr(dryrun, "_measure", depth)
    variants = [None, {"optimizer": "adafactor"},
                {"master_weights_f32": False},
                {"optimizer": "adafactor", "master_weights_f32": False},
                {"remat_policy": "none", "microbatch": 1},
                {"remat_policy": "full", "microbatch": 16}]
    got, alone = set(), set()
    for knobs in variants:
        with pytest.raises(_Depth) as e:
            dryrun.compile_cell(cfg, cell, knobs, device="cpu")
        got.add(e.value.args[0])
        rc = dryrun.default_runconfig(cfg, cell, knobs)
        try:
            alone.add(dryrun.fit_depth(cfg, rc, roofline.H100.hbm_bytes,
                                       mode="train", batch=16, seq=4096))
        except dryrun.DoesNotFit:        # not even one period fits alone
            alone.add(0)
    assert got == {dryrun.cell_depth(cfg, cell)}
    assert len(alone) > 1          # the knobs' own fits would differ


def test_run_cell_keeps_the_long_500k_skip():
    rec = dryrun.run_cell("yi-6b", "long_500k", device="cpu", save=False)
    assert rec["skipped"] and rec["shape"] == "long_500k"


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the device is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.compile_cell(get_smoke_config("yi-6b"),
                            SHAPES_BY_NAME["train_4k"], reduce=REDUCE)


_HYGIENE = r"""
import json, os, sys
before = os.environ.get("XLA_FLAGS")
import repro_torch.launch.dryrun, repro_torch.launch.roofline
import repro_torch.launch.mesh, repro_torch.core.evaluators
bad = sorted(m for m in sys.modules if m in ("jax", "jaxlib", "repro")
             or m.startswith(("jax.", "jaxlib.", "repro.")))
print(json.dumps({"bad": bad, "xla": os.environ.get("XLA_FLAGS") == before}))
"""


def test_new_modules_import_no_jax_and_set_no_xla_flags():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _HYGIENE],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "xla": True}

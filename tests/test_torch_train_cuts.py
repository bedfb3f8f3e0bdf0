"""The MoE and hybrid train steps that ``chip_smoke.py`` phase 13 runs on
the card, on the CPU: how their depth is chosen and how a cell that
cannot fit is refused (``launch.dryrun.fit_depth``), the two cuts built
from the full configs (``chip_smoke.family_train_cut``), and one
``make_train_step`` step of each under the phase's RunConfig at smoke
width against the reference's jitted step.

``fit_depth`` raises ``DoesNotFit`` (with the one-period estimate and the
room it was held to) when not even one layer period fits the card: jamba's
period is ~376 GB under its family default at train_4k's replica share
(since ``ssm_inner`` was ported its default share is one chip's, where
all 72 layers fit).  ``cell_depth`` and ``compile_cell`` /
``CompiledEvaluator`` at that share pass it on before anything is
allocated: a failed evaluation, as a config that does not compile is in
the reference.  yi-6b's cells keep their depths (train_4k 7, decode_32k
32).

``estimate_bytes`` counts a train step's update beside its backward: the
state and the optimizer's float32 temporaries of the largest leaf (six
for AdamW, eight for Adafactor, read off the card's allocator by
``tools/train_memory_stages.py``).  qwen2-moe-a2.7b's 4-layer step peaked
at 69.64 GiB in its update (its 60 experts' stacked leaves are 2.77 GB in
float32), above the 0.9 of the card the depth may take, so the phase's
depth is 3.

The smoke-width steps use the tolerances of ``test_torch_train_step.py``
(loss, its parts and the gradient norm within 1e-5; parameters within
atol 1e-5 but 0.1 % of each leaf, every element within 2 lr; the
optimizer's moments within 1e-3 relative).  The sequence (8 tokens) is one
SSD chunk, where the reference's gradient is finite; at a chunk of 256
over 512 tokens the reference's chunked SSD passes 0 * inf to its
gradient (``src/repro/models/ssm.py:155``) and the port's does not: the
last test holds the port's gradient there against the reference's at a
chunk of 16, the same function.
"""

import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.runconfig import RunConfig as JRunConfig
from repro_torch.configs import get_config
from repro_torch.core.evaluators import CompiledEvaluator
from repro_torch.core.service import EvalRequest, as_service
from repro_torch.launch import dryrun, roofline
from repro_torch.models.config import SHAPES_BY_NAME
from repro_torch.runconfig import RunConfig
from repro_torch.train.train_loop import loss_and_grads
from test_torch_train import (F32, _batch, _compare_grads, _pair,
                              _value_and_grad)
from test_torch_train_step import check_train_step

ROOT = Path(__file__).resolve().parents[1]
HBM = roofline.H100.hbm_bytes
JAMBA = "jamba-1.5-large-398b"
QWEN = "qwen2-moe-a2.7b"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# fit_depth's refusal, cell_depth, compile_cell and CompiledEvaluator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [(JAMBA, "train_4k"),
                                        ("grok-1-314b", "train_4k"),
                                        ("yi-6b", "prefill_32k")])
def test_a_period_that_does_not_fit_is_refused(arch, shape):
    cfg, cell = get_config(arch), SHAPES_BY_NAME[shape]
    rc = dryrun.default_runconfig(cfg, cell)
    B, S, _ = dryrun.replica_shape(cell, rc, dryrun.make_production_mesh())
    one = dryrun.estimate_bytes(cfg.scaled(n_layers=len(cfg.pattern)), rc,
                                cell.mode, B, S)
    with pytest.raises(dryrun.DoesNotFit) as e:
        dryrun.fit_depth(cfg, rc, HBM, mode=cell.mode, batch=B, seq=S)
    assert e.value.need_bytes == one > e.value.room_bytes \
        == dryrun.FIT_FRACTION * HBM
    assert f"{one / 1e9:.2f} GB" in str(e.value)
    with pytest.raises(dryrun.DoesNotFit):
        dryrun.cell_depth(cfg, cell, share="replica")


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "grok-1-314b"])
def test_moe_train_cells_fit_whole_at_the_chip_share(arch):
    """Expert parallelism put the MoE train cells on one chip of the
    16 x 16 mesh (their default share), where the whole model fits
    (grok-1's one period does not fit one card whole: above)."""
    cfg, cell = get_config(arch), SHAPES_BY_NAME["train_4k"]
    assert dryrun.resolve_share(cfg, cell) == "chip"
    assert dryrun.cell_depth(cfg, cell) == cfg.n_layers


def test_yi_cells_keep_their_depths():
    cfg = get_config("yi-6b")
    assert dryrun.cell_depth(cfg, SHAPES_BY_NAME["train_4k"],
                             share="replica") == 7
    # one chip's share of the 16 x 16 mesh, train_4k's default share,
    # fits the whole model
    assert dryrun.cell_depth(cfg, SHAPES_BY_NAME["train_4k"]) == 32
    assert dryrun.cell_depth(cfg, SHAPES_BY_NAME["decode_32k"]) == 32


def _nothing_allocated(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the cell was built")
    monkeypatch.setattr(dryrun, "_measure", refuse)
    monkeypatch.setattr(dryrun, "lower_cell", refuse)


def test_compile_cell_refuses_before_building(monkeypatch):
    _nothing_allocated(monkeypatch)
    with pytest.raises(dryrun.DoesNotFit) as e:
        dryrun.compile_cell(get_config(JAMBA), SHAPES_BY_NAME["train_4k"],
                            device="cpu", share="replica")
    assert e.value.need_bytes > e.value.room_bytes


def test_compiled_evaluator_reports_a_failed_evaluation(monkeypatch):
    _nothing_allocated(monkeypatch)
    ev = CompiledEvaluator(get_config(JAMBA), SHAPES_BY_NAME["train_4k"],
                           device="cpu", share="replica")
    svc = as_service(ev)
    try:
        (res,) = svc.gather(svc.submit([EvalRequest({})]))
    finally:
        svc.close()
    assert not res.ok and isinstance(res.exception, dryrun.DoesNotFit)
    assert "GB (estimate_bytes)" in res.error
    assert ev.calls == 0 and not ev._cache and not ev.records


# ---------------------------------------------------------------------------
# the phase's two cuts, from the full configs
# ---------------------------------------------------------------------------

def test_qwen2_moe_cut_is_fit_depths():
    cfg, rc, reduced = CS.family_train_cut(QWEN)
    full = get_config(QWEN)
    assert (rc.microbatch, rc.remat_policy, rc.attention_impl,
            rc.optimizer, rc.master_weights_f32, rc.moe_impl) == \
        (1, "block", "flash", "adamw", True, "dense")
    shape = dict(mode="train", batch=CS.TRAIN_B, seq=CS.TRAIN_S)
    assert cfg.n_layers == dryrun.fit_depth(full, rc, HBM, **shape) == 3
    assert reduced == ["depth 24 -> 3"]
    assert all((s.kind, s.mlp) == ("attn", "moe") for s in cfg.pattern)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.n_experts,
            cfg.vocab_size) == (2048, 16, 16, 60, 151936)
    # one layer ~0.570 B parameters, embedding and head 0.62 B
    layer = full.scaled(n_layers=2).param_count() \
        - full.scaled(n_layers=1).param_count()
    assert layer == pytest.approx(0.570e9, rel=1e-2)
    assert cfg.param_count() == pytest.approx(0.62e9 + 3 * 0.570e9,
                                              rel=1e-2)
    room = dryrun.FIT_FRACTION * HBM
    est = [dryrun.estimate_bytes(full.scaled(n_layers=n), rc, **shape)
           for n in (3, 4)]
    assert est[0] <= room < est[1]
    # 4 layers fit the backward's estimate but not the update's
    four = full.scaled(n_layers=4)
    temps = dryrun.UPDATE_TEMPORARIES["adamw"] * 4 \
        * dryrun._largest_leaf(four)
    assert dryrun._largest_leaf(four) == 4 * 60 * 2048 * 1408
    assert est[1] == four.param_count() \
        * dryrun._state_bytes_per_param(rc, True) + temps


def test_jamba_cut_holds_no_moe_layer():
    cfg, rc, reduced = CS.family_train_cut(JAMBA)
    assert [(s.kind, s.mlp) for s in cfg.pattern] == [("mamba", "dense"),
                                                      ("attn", "dense")]
    assert cfg.n_layers == 2 and cfg.n_groups == 1
    assert reduced == ["depth 72 -> 2", "MoE layers cut"]
    assert (rc.optimizer, rc.master_weights_f32, rc.remat_policy,
            rc.microbatch, rc.attention_impl) == \
        ("adafactor", False, "full", 1, "flash")
    assert cfg.d_model == 8192 and cfg.d_ff == 24576
    assert cfg.param_count() == pytest.approx(2.84e9, rel=1e-2)
    # ~8 B a parameter (bf16 weight, float32 and bf16 gradients)
    assert dryrun._state_bytes_per_param(rc, True) == 8
    est = dryrun.estimate_bytes(cfg, rc, "train", CS.TRAIN_B, CS.TRAIN_S)
    assert est <= dryrun.FIT_FRACTION * HBM
    assert CS.TRAIN_S % rc.ssm_chunk == 0


# ---------------------------------------------------------------------------
# one step of each at smoke width against the reference
# ---------------------------------------------------------------------------

def _phase_knobs(arch):
    _, rc, _ = CS.family_train_cut(arch)
    return {k: getattr(rc, k) for k in ("remat_policy", "attention_impl",
                                        "optimizer", "master_weights_f32")}


@pytest.mark.parametrize("arch,keep", [(QWEN, None),
                                       (JAMBA, CS.JAMBA_TRAIN_KEEP)],
                         ids=["qwen2-moe", "jamba-0-4"])
def test_phase_step_matches_reference(arch, keep):
    """The phase's RunConfig (microbatch 1: two microbatches) in float32
    at smoke width; on CPU tensors flash runs its plain version, the
    reference its chunked stand-in."""
    check_train_step(arch, "mb1", keep=keep, extra=_phase_knobs(arch))


def test_ssd_gradient_is_finite_at_a_long_chunk():
    """At 512 tokens in chunks of 256 the reference's gradient is NaN in
    the mamba leaves; the port's equals the reference's at chunks of 16
    (the same function: jamba's loss and gradient tolerances)."""
    jm, jp, tm, tp = _pair(JAMBA, keep=CS.JAMBA_TRAIN_KEEP)
    batch = _batch(jm.cfg, B=1, S=512)
    (_, _), j256 = _value_and_grad(jm, jp, batch, JRunConfig(**F32))
    assert not all(np.isfinite(np.asarray(x)).all()
                   for x in jax.tree.leaves(j256))
    (jloss, _), j16 = _value_and_grad(jm, jp, batch,
                                      JRunConfig(**F32, ssm_chunk=16))
    loss, _, grads = loss_and_grads(tm, tp, batch, RunConfig(**F32))
    assert RunConfig(**F32).ssm_chunk == 256
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _compare_grads(grads, j16, 2e-4)

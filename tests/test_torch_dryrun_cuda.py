"""The product cluster's run of a cell on the card
(``launch.dryrun.compile_cell``).  Needs an NVIDIA GPU (``cuda`` marker);
skips without one.  Imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_dryrun_cuda.py

yi-6b at full width, one layer, a train step cut to 2 x 2048 tokens with
the flash kernels, at one replica's share and at one chip's share of the
16 x 16 mesh: every aten op of the counted step writes on the card (none
on the CPU), the flash launches add their own work (at the chip's 2 q
heads over 1 kv head), and the model FLOP utilisation and each roofline
term over the measured step lie in (0, 1.05): no bound may exceed the
time the card took.  The chip's collectives are counted and priced, and
its score is the measured step combined with them.  With no depth given,
the family default of yi-6b's train_4k replica share (16 x 4096 tokens)
runs at ``dryrun.cell_depth``'s depth within the card's memory and
within the estimate that chose it, and the chip's share at full depth
within 0.9 of the card.  So do serving cells at the chip's share
(``SERVE_CELLS``), each at the depth ``cell_depth`` chose from the
estimate: the peak and the estimate are printed side by side.
"""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops
from repro_torch.launch import dryrun
from repro_torch.models.config import SHAPES_BY_NAME

REDUCE = {"batch": 2, "seq": 2048}
KNOBS = {"attention_impl": "flash", "microbatch": 1}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the step runs on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_compile_cell_on_the_card(cuda):
    ops.reset_launch_counts()
    rec = dryrun.compile_cell(get_config("yi-6b"), SHAPES_BY_NAME["train_4k"],
                              KNOBS, device=cuda, n_layers=1, reduce=REDUCE,
                              share="replica")
    roof = rec["roofline"]
    assert set(roof["hbm_bytes_by_device"]) == {"cuda"}
    assert rec["mesh"] == "1xH100" and rec["card"]
    # warm-up + 2 timed steps, 2 microbatches of one layer (remat block)
    assert ops.launches == ops.launches_wgmma == 3 * 2 * 1 * 2
    assert ops.launches_bwd == 3 * 2 * 1
    assert roof["kernel_flops"] > 0 and roof["kernel_bytes"] > 0
    measured = rec["measured_step_s"]
    assert 0 < rec["mfu"] < 1.05
    for term in ("compute_s", "memory_s"):
        assert 0 < roof[term] / measured < 1.05, (term, roof[term], measured)
    assert roof["collective_s"] == 0.0
    assert rec["outputs_finite"] and rec["step1_loss"] > 0
    assert rec["memory"]["max_memory_allocated_gb"] > \
        rec["memory"]["state_size_gb"]
    assert "n_layers 32 -> 1" in rec["reduced"]


@pytest.mark.cuda
def test_cell_depth_fits_the_card(cuda):
    cfg, cell = get_config("yi-6b"), SHAPES_BY_NAME["train_4k"]
    rec = dryrun.compile_cell(cfg, cell, device=cuda, steps=1,
                              share="replica")
    mem = rec["memory"]
    assert rec["n_layers"] == dryrun.cell_depth(
        cfg, cell, share="replica") < cfg.n_layers
    assert rec["batch"] == 16 and rec["seq_len"] == 4096
    assert mem["max_memory_allocated_gb"] <= mem["estimated_gb"]
    assert rec["outputs_finite"]


@pytest.mark.cuda
def test_chip_share_on_the_card(cuda):
    ops.reset_launch_counts()
    shapes, fn = set(), ops.flash_attention

    def recording(q, k, v, **kw):
        shapes.add((tuple(q.shape), tuple(k.shape)))
        return fn(q, k, v, **kw)
    ops.flash_attention = recording
    try:
        rec = dryrun.compile_cell(get_config("yi-6b"),
                                  SHAPES_BY_NAME["train_4k"], KNOBS,
                                  device=cuda, n_layers=1, reduce=REDUCE)
    finally:
        ops.flash_attention = fn
    roof = rec["roofline"]
    assert (rec["share"], rec["mesh"], rec["chips"]) == ("chip", "16x16", 256)
    assert rec["chip"] == {"data": 0, "model": 0}
    assert set(roof["hbm_bytes_by_device"]) == {"cuda"}
    assert ops.launches == ops.launches_wgmma == 3 * 2 * 1 * 2
    assert ops.launches_bwd == 3 * 2 * 1
    assert shapes == {((1, 2048, 2, 128), (1, 2048, 1, 128))}
    assert set(roof["coll_by_kind"]) == {"all-reduce", "all-gather",
                                         "reduce-scatter"}
    assert roof["collective_s"] == roof["collective_bytes_per_device"] \
        / 900e9 > 0
    measured = rec["measured_step_s"]
    assert rec["scored_step_s"] >= measured
    assert 0 < rec["mfu"] < 1.05
    for term in ("compute_s", "memory_s"):
        assert 0 < roof[term] / measured < 1.05, (term, roof[term], measured)
    assert rec["outputs_finite"] and rec["step1_loss"] > 0


@pytest.mark.cuda
def test_chip_share_cell_depth_fits_the_card(cuda):
    cfg, cell = get_config("yi-6b"), SHAPES_BY_NAME["train_4k"]
    rec = dryrun.compile_cell(cfg, cell, device=cuda, steps=1)
    assert rec["share"] == "chip" and rec["reduced"] == []
    assert rec["n_layers"] == dryrun.cell_depth(cfg, cell) == cfg.n_layers
    assert rec["batch"] == 16 and rec["seq_len"] == 4096
    assert rec["memory"]["max_memory_allocated_gb"] * 2**30 \
        <= dryrun.FIT_FRACTION * 80e9
    assert rec["outputs_finite"]


# serving cells at one chip's share, each run at the depth the estimate
# chose: dense prefill (chunked and flash), GQA decode over a cache whole
# over the model axis, MoE prefill, mLSTM decode, and the hybrid's long
# decode with the cache's sequence over the data axis
SERVE_CELLS = [("yi-6b", "prefill_32k", None),
               ("yi-6b", "prefill_32k", {"attention_impl": "flash"}),
               ("yi-6b", "decode_32k", None),
               ("mistral-nemo-12b", "decode_32k", None),
               ("qwen2-moe-a2.7b", "prefill_32k", None),
               ("xlstm-1.3b", "decode_32k", None),
               ("jamba-1.5-large-398b", "long_500k", None)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,shape,knobs", SERVE_CELLS,
                         ids=[f"{a}-{s}" + ("-flash" if k else "")
                              for a, s, k in SERVE_CELLS])
def test_serving_chip_share_depth_fits_within_its_estimate(cuda, arch,
                                                          shape, knobs):
    cfg, cell = get_config(arch), SHAPES_BY_NAME[shape]
    # what the card holds before the cell (cuBLAS's workspace, once a
    # product ran) is not the cell's
    before = torch.cuda.memory_allocated(cuda) / 2**30
    rec = dryrun.compile_cell(cfg, cell, knobs, device=cuda, steps=1)
    mem = rec["memory"]
    print(f"{arch} {shape} {knobs or ''}: {rec['n_layers']} of "
          f"{cfg.n_layers} layers, peak {mem['max_memory_allocated_gb']:.6f}"
          f" GiB ({before:.6f} of it before the cell), estimated "
          f"{mem['estimated_gb']:.6f} GiB, step "
          f"{rec['measured_step_s']:.6f} s on {rec['card']}")
    assert rec["share"] == "chip" and rec["reduced"] == []
    assert rec["n_layers"] == dryrun.cell_depth(cfg, cell)
    assert mem["max_memory_allocated_gb"] - before <= mem["estimated_gb"]
    assert mem["max_memory_allocated_gb"] * 2**30 \
        <= dryrun.FIT_FRACTION * 80e9
    assert rec["outputs_finite"]

"""The product cluster's run of a cell on the card
(``launch.dryrun.compile_cell``).  Needs an NVIDIA GPU (``cuda`` marker);
skips without one.  Imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_dryrun_cuda.py

yi-6b at full width, one layer, a train step cut to 2 x 2048 tokens with
the flash kernels: every aten op of the counted step writes on the card
(none on the CPU), the flash launches add their own work, and the model
FLOP utilisation and each roofline term over the measured step lie in
(0, 1.05): no bound may exceed the time the card took.  With no depth
given, the family default of yi-6b's train_4k replica share (16 x 4096
tokens) runs at ``dryrun.cell_depth``'s depth within the card's memory
and within the estimate that chose it.
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
                              KNOBS, device=cuda, n_layers=1, reduce=REDUCE)
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
    rec = dryrun.compile_cell(cfg, cell, device=cuda, steps=1)
    mem = rec["memory"]
    assert rec["n_layers"] == dryrun.cell_depth(cfg, cell) < cfg.n_layers
    assert rec["batch"] == 16 and rec["seq_len"] == 4096
    assert mem["max_memory_allocated_gb"] <= mem["estimated_gb"]
    assert rec["outputs_finite"]

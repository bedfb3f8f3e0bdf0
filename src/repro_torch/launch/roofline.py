"""Roofline terms of one step, counted while it runs (from
``repro.launch.roofline``).

The reference parses compiled HLO text for the step's FLOPs, an HBM
traffic proxy and collective bytes.  PyTorch lowers no HLO, so the port
counts the same three quantities over one eager run of the step
(:func:`count_step`):

* FLOPs: ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s
  registry) over the aten ops (the products: mm, bmm, convolutions,
  attention), forward, backward and every recompute.  The mode itself is
  not used: it runs an op its registry lacks as that op's decomposition
  where there is one (``silu_backward`` in the train step), which changes
  the step's gradient in its last bits; the counter here runs every op as
  called;
* HBM bytes: the output bytes of each aten op that writes memory (views
  and fresh allocations move nothing), as the HLO proxy counts each
  top-level op's result;
* the hand-written kernels run from ``ctypes`` inside their
  ``autograd.Function``\\ s, where no dispatch mode sees them: each launch
  adds its own operations and its inputs' and outputs' bytes, from the
  formulas its bound uses (``fwd_work`` / ``bwd_work`` of the kernel's
  ``ops.py``, through ``kernels.add_work``);
* collective bytes: 0 on one card.

:func:`report_from_counts` combines the terms by the reference's rule:
each term is its count over the card's peak rate, the step is the
largest term plus 0.15 x the others, and ``dominant`` names the largest.
``H100`` is the card's record beside the analytic model's ``V5E``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import kernels
from repro_torch.core.costmodel import Hardware

# NVIDIA's data sheet, H100 SXM at its 700 W limit: dense bf16, HBM3 rate
# and size; NVLink 4 (900 GB/s a card) and one 400 Gb/s NDR port between
# hosts; 227 KiB of shared memory a block (sm_90)
H100 = Hardware(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=900e9,
                dci_bw=50e9, hbm_bytes=80e9, vmem_bytes=232448)


@dataclass
class RooflineReport:
    flops: float                 # per-device
    bytes_proxy: float           # per-device HBM traffic proxy
    collective_bytes: float      # per-device
    coll_by_kind: Dict[str, float]
    compute_s: float
    memory_s: float
    collective_s: float
    step_s: float
    dominant: str
    raw_cost_analysis: Dict[str, float]
    trip_counts: Dict[str, int]

    def terms(self) -> Dict[str, float]:
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s, "step_s": self.step_s,
                "dominant": self.dominant}


def report_from_counts(flops: float, hbm_bytes: float,
                       collective_bytes: float,
                       hw: Hardware = H100) -> RooflineReport:
    """The three terms of these per-device counts on ``hw``, combined by
    the reference's rule (``repro.launch.roofline.analyze_hlo``)."""
    compute_s = flops / hw.peak_flops
    memory_s = hbm_bytes / hw.hbm_bw
    collective_s = collective_bytes / hw.ici_bw
    step = max(compute_s, memory_s, collective_s)
    dominant = ("compute" if step == compute_s else
                "memory" if step == memory_s else "collective")
    step += 0.15 * (compute_s + memory_s + collective_s - step)
    return RooflineReport(
        flops=flops, bytes_proxy=hbm_bytes,
        collective_bytes=collective_bytes, coll_by_kind={},
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        step_s=step, dominant=dominant, raw_cost_analysis={},
        trip_counts={},
    )


def model_flops(n_params_active: int, tokens: int, train: bool) -> float:
    """The 6·N·D (train) / 2·N·D (inference) reference quantity."""
    return (6.0 if train else 2.0) * n_params_active * tokens


# ops that allocate without writing, or hand back their input's storage
_NO_WRITE = frozenset((
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "detach", "lift_fresh", "_local_scalar_dense",
    "set_", "resize_", "alias"))


class _StepCounter(TorchDispatchMode):
    """Runs each aten op as called and counts it: its FLOPs by
    ``FlopCounterMode``'s formula where the registry has one, and the
    bytes of its tensor outputs by device type, skipping views (their
    output is their input's storage) and bare allocations."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.by_device: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = self.registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not (func.is_view
                or func.overloadpacket.__name__ in _NO_WRITE):
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    kind = t.device.type
                    self.by_device[kind] = (self.by_device.get(kind, 0)
                                            + t.numel() * t.element_size())
        return out


@dataclass(frozen=True)
class StepCounts:
    """What one run of a step did: totals, and the kernels' part of them."""
    flops: int
    hbm_bytes: int
    kernel_flops: int
    kernel_bytes: int
    # the aten ops' output bytes by device type ("cuda", "cpu")
    bytes_by_device: Dict[str, int]


def count_step(fn: Callable[[], object]) -> Tuple[StepCounts, object]:
    """Run ``fn()`` once under the counters; ``(StepCounts, fn's
    result)``.  The counting changes no number ``fn`` computes."""
    counter = _StepCounter()
    with kernels.counting_work() as work:
        with counter:
            out = fn()
    return StepCounts(
        flops=int(counter.flops) + int(work[0]),
        hbm_bytes=sum(counter.by_device.values()) + int(work[1]),
        kernel_flops=int(work[0]), kernel_bytes=int(work[1]),
        bytes_by_device=dict(counter.by_device)), out

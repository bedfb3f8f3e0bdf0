"""Kernel autotune: Sapphire tuning its own Hopper kernels (the dogfood).

The tuner's premise, that a search driven by measurements beats
hand-picked defaults when evaluations are cheap enough, applies to its
own compute: the three CUDA kernels of the port run hand-picked tiles.
This module closes the loop on the card:

* :class:`KernelSpace`: a kernel's tunable tiling/scheduling space
  (``block_q``/``block_k``/``block_n``/``block_m``/``chunk``/
  ``num_warps``/``pipeline``), built from each ops module's
  ``autotune_space()``: the reference's spaces, knob for knob;
* :class:`KernelEvaluator`: an ``EvaluationService`` backend
  (``service_kind="pool"``) that times a kernel config's device time
  with CUDA events on the current stream, the stream held busy while the
  host queues the call, best of repeats after warmup (``perf_counter``
  on the CPU, where the plain versions run).  A config that fails
  validation, or one the card's kernel has no instantiation of (the ops
  wrapper raises ``ValueError`` naming its set), raises, which the
  service layer turns into a *failed* EvalResult: the async controller
  prices it as infeasible instead of stopping the run;
* :func:`tune_kernel`: the whole loop, BO over the kernel space through
  ``Controller.run_async``, seeded with the space's default (and the
  card's own default launch, where the space's TPU-sized default is not
  one of its instantiations) so the result is compared head to head.

The tuner's own GP runs the gp_gram kernels on the same card: the
strategy's ``ask`` (the GP fit and the q-EI selection) and a timed
window never overlap, so no measurement includes the tuner's launches.
"""

from __future__ import annotations

import importlib
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from repro_torch.core.space import Config, Space
from repro_torch.core.strategy import BOStrategy

SCREEN_FIDELITY = "screen"
# GPU cycles of the hold kernel queued before each timed call (~2 ms at the
# H100's 1.98 GHz): longer than the host takes to queue one call (~0.15 ms
# at the mLSTM bench, with spikes), so that the events bracket the call's
# kernels on the device and none of the host's dispatch
HOLD_CYCLES = 4_000_000


@dataclass(frozen=True)
class KernelSpace:
    """A tunable kernel: its name, knob :class:`Space` (with validity
    constraints), benchmark factory ``bench(**shape) -> build`` where
    ``build(cfg) -> run`` closes over the input tensors and ``run()``
    executes one kernel call, and ``native(**shape)``, the card's default
    launch as a point of the space."""
    kernel: str
    space: Space
    bench: Callable[..., Callable[[Config], Callable[[], Any]]]
    native: Callable[..., Config]

    def default_config(self) -> Config:
        return self.space.project(self.space.default_config())


_OPS = {
    "gp_gram": "repro_torch.kernels.gp_gram.ops",
    "flash_attention": "repro_torch.kernels.flash_attention.ops",
    "mlstm_chunk": "repro_torch.kernels.mlstm_chunk.ops",
}
_REGISTRY: Dict[str, KernelSpace] = {}


def tunable_kernels() -> tuple:
    return tuple(sorted(_OPS))


def kernel_spec(kernel: str) -> KernelSpace:
    spec = _REGISTRY.get(kernel)
    if spec is None:
        try:
            mod = importlib.import_module(_OPS[kernel])
        except KeyError:
            raise KeyError(f"unknown kernel {kernel!r}; "
                           f"tunable: {tunable_kernels()}") from None
        spec = KernelSpace(kernel, mod.autotune_space(), mod.autotune_bench,
                           mod.autotune_native)
        _REGISTRY[kernel] = spec
    return spec


def kernel_space(kernel: str) -> Space:
    """The tunable knob space of ``kernel`` (validity constraints
    included)."""
    return kernel_spec(kernel).space


def kernel_bench(kernel: str, **shape):
    """``build(cfg) -> run()`` benchmark factory for ``kernel`` at
    ``shape`` (kernel-specific keywords, e.g. ``n=136`` for gp_gram;
    ``device="cpu"`` for the plain versions)."""
    return kernel_spec(kernel).bench(**shape)


@dataclass
class KernelEvaluator:
    """Kernel timer behind the EvaluationService contract.

    ``service_kind = "pool"`` routes it through a worker pool at the
    Controller boundary (``as_service``); ``max_workers = 1`` keeps
    timing runs serialized: overlapped measurements would contend for
    the card and time each other.  ``wants_request = True`` lets the
    service hand the :class:`EvalRequest` through, so a
    ``fidelity="screen"`` request is timed with fewer repeats (the
    successive-halving screen tier).  ``timing_lock`` is held for the
    whole warmup-and-timing window; :func:`tune_kernel` holds it around
    every ``ask`` of its strategy.

    On CUDA inputs each repeat is one call between two CUDA events on the
    current stream, queued behind a hold kernel (``torch.cuda._sleep`` of
    ``HOLD_CYCLES``) after a synchronize: the host has queued the whole
    call before the device reaches the first event, so the reading is the
    call's device time, not the host's dispatch (at a host-bound shape
    the host's time spreads by a quarter between readings of one config,
    and the best of them was the luckiest).  The reference times a
    jitted call's wall clock (ROADMAP C).  On CPU inputs ``perf_counter``
    around one call.  A config off
    the space (validation failure) or one the card's kernel refuses
    raises; the service layer converts that into a failed EvalResult,
    which ``run_async`` records as infeasible and prices past the worst
    observed value.
    """
    kernel: str = "gp_gram"
    shape: Optional[Dict[str, Any]] = None
    repeats: int = 5
    warmup: int = 2
    screen_repeats: int = 2
    device: str = "cuda"
    max_workers: int = 1                 # read by as_service
    service_kind = "pool"                # read by as_service
    wants_request = True                 # read by _score_one
    spec: KernelSpace = field(init=False)
    space: Space = field(init=False)
    timing_lock: Any = field(init=False, repr=False)

    def __post_init__(self):
        self.spec = kernel_spec(self.kernel)
        self.space = self.spec.space
        self.timing_lock = threading.Lock()
        self._build = self.spec.bench(**{"device": self.device,
                                         **(self.shape or {})})

    def __call__(self, cfg: Config, request=None) -> float:
        errs = self.space.validate(cfg)
        if errs:
            raise ValueError(f"{self.kernel}: invalid config {cfg!r}: "
                             + "; ".join(errs))
        run = self._build(cfg)           # a refused tiling raises on the
        reps = self.repeats              # first call
        if request is not None and request.fidelity == SCREEN_FIDELITY:
            reps = self.screen_repeats
        return self.time(run, reps)

    def time(self, run: Callable[[], Any], reps: int) -> float:
        """Best of ``reps`` timed calls of ``run`` after ``warmup`` calls,
        in ms, holding ``timing_lock``."""
        import torch
        with self.timing_lock:
            out = None
            for _ in range(max(self.warmup, 1)):
                out = run()
            best = math.inf
            if isinstance(out, torch.Tensor) and out.is_cuda:
                with torch.cuda.device(out.device):
                    torch.cuda.synchronize()
                    for _ in range(max(reps, 1)):
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        torch.cuda._sleep(HOLD_CYCLES)
                        start.record()
                        run()
                        end.record()
                        end.synchronize()
                        best = min(best, start.elapsed_time(end))
                return best                  # milliseconds (minimized)
            for _ in range(max(reps, 1)):
                t0 = time.perf_counter()
                run()
                best = min(best, time.perf_counter() - t0)
            return best * 1e3


class ExclusiveBO(BOStrategy):
    """A BOStrategy whose ``ask`` (the GP fit and the q-EI selection, on
    the card) holds ``lock``: it never runs inside a timed window, and no
    timing starts while it runs."""

    def __init__(self, space, cfg, init_configs=None, *, lock):
        super().__init__(space, cfg, init_configs)
        self._lock = lock

    def ask(self, n=None):
        with self._lock:
            return super().ask(n)


def tune_kernel(kernel: str = "gp_gram", shape: Optional[Dict] = None,
                budget: int = 20, batch_size: int = 2, seed: int = 0,
                repeats: int = 5, warmup: int = 2, fit_steps: int = 60,
                max_in_flight: Optional[int] = None,
                db_path: Optional[str] = None,
                device: str = "cuda") -> Dict[str, Any]:
    """Tune ``kernel``'s tiling with BO through the async experiment loop,
    timing on ``device`` (the GP runs there too).

    The initial design is seeded with the space's projected default
    config first (``init_design`` puts caller configs first), so every
    run measures the baseline it is trying to beat under identical
    conditions: the returned ``default_value`` is that measurement, not a
    separate run (``None`` when the card's kernel refused that config;
    the space's defaults are the reference's TPU-sized tiles).  The card's
    own default launch (``KernelSpace.native`` at ``shape``) is seeded
    second when it differs, so the search has a point the kernel takes.

    Returns ``{"best_config", "best_value", "default_config",
    "default_value", "trace", "db"}`` (values in ms).
    """
    from repro_torch.core.controller import Controller, EvalDB
    from repro_torch.core.strategy import BOConfig, _config_key

    ev = KernelEvaluator(kernel, shape=shape, repeats=repeats, warmup=warmup,
                         device=device)
    space = ev.space
    default = space.project(space.default_config())
    native = space.project(ev.spec.native(**(shape or {})))
    seeds = [default]
    if _config_key(native) != _config_key(default):
        seeds.append(native)
    n_init = min(max(budget // 3, 4), budget)
    cfg = BOConfig(n_init=n_init, n_iter=max(budget - n_init, 0),
                   batch_size=batch_size, n_candidates=256, n_local=64,
                   fit_steps=fit_steps, warm_start=True,
                   dynamic_boundary=False, seed=seed, device=device)
    strat = ExclusiveBO(space, cfg, init_configs=seeds, lock=ev.timing_lock)
    ctl = Controller(ev, EvalDB(db_path), tag="autotune",
                     workload=f"kernel:{kernel}")
    try:
        trace = ctl.run_async(strat, max_in_flight=max_in_flight)
    finally:
        ctl.service.close()
    best_cfg, best_val = strat.best()

    dkey = _config_key(default)
    default_value = None
    for rec in ctl.db.records:
        if rec.status == "ok" and _config_key(rec.config) == dkey:
            default_value = float(rec.value)
            break
    return {"best_config": dict(best_cfg), "best_value": float(best_val),
            "default_config": dict(default), "default_value": default_value,
            "trace": trace, "db": ctl.db}

"""Experiment Unit backends (paper §3.1/§3.4).

* :class:`AnalyticEvaluator` — the *test cluster*: the closed-form cost
  model corrupted with multiplicative log-normal noise (σ = 2.5 %, the
  paper's measured benchmark deviation).  Milliseconds per call; used for
  the 300-sample ranking phase and every optimizer comparison.
* :class:`CompiledEvaluator` — the *product cluster*: applies the config
  to the real step and runs it on the card (``launch.dryrun.compile_cell``:
  one replica's share of the cell, a warm-up step, then timed steps),
  scoring the measured step's median.  Seconds per call; validates
  recommendations (the paper's Fig. 5 transfer).  The reference compiles
  the step on a forced 512-device CPU mesh and scores the roofline terms
  of its HLO instead; PyTorch has no HLO, and the port has a card.

Both return *step seconds* (lower is better).

The analytic noise is host work, like the cost model it corrupts, and
reproduces the JAX reference's stream: one standard normal per
evaluation, drawn by ``jax.random.normal`` from raw threefry key words
built from a blake2s digest of (config, salt).  :func:`threefry_bits` and :func:`std_normal`
rebuild that draw in numpy (threefry2x32 with 20 rounds, the
bits→uniform→normal transform), so every seeded ``(config, seed)`` probe
matches the reference to float32 rounding.

Batch protocol: ``evaluate_batch(configs) -> np.ndarray`` scores n configs
at once; the analytic evaluator with per-row noise keys, reproducing n
sequential ``__call__``\\ s, the compiled one measuring what its cache
lacks one config after another (one card times one step at a time:
every measurement holds :data:`CARD_LOCK`).
"""

from __future__ import annotations

import hashlib
import json
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.special import erfinv

from repro_torch.core.costmodel import (SINGLE_POD, CostBreakdown, Hardware,
                                        MeshShape, V5E, estimate)
from repro_torch.core.space import Config
from repro_torch.models.config import ModelConfig, ShapeCell


def _trim_history(history: list, cap: Optional[int]):
    """Ring-buffer semantics on a plain list: keep the newest ``cap``
    records.  ``cap=None`` keeps everything."""
    if cap is not None and len(history) > cap:
        del history[:len(history) - cap]


def _stable_seed(cfg: Config, salt) -> int:
    """Noise is i.i.d. per *evaluation*, not per config.  ``salt`` is the
    call-indexed int for unseeded evaluations, or the ``"seed:<n>"`` tag
    for request-seeded ones (the two streams stay disjoint)."""
    s = json.dumps({k: str(v) for k, v in sorted(cfg.items())}, sort_keys=True)
    h = hashlib.blake2s(f"{s}|{salt}".encode()).digest()[:8]
    return int.from_bytes(h, "little") >> 1      # 63-bit


def _noise_salt(seed: Optional[int], call_salt: int):
    """A seeded request draws from the seed-pinned stream; an unseeded one
    keeps the call-indexed stream."""
    return call_salt if seed is None else f"seed:{seed}"


def _key_data(seed: int) -> np.ndarray:
    """Raw threefry key words ``[hi, lo]`` for a 63-bit seed."""
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """threefry2x32 (20 rounds) of the counters (x0, x1) under the key
    (k0, k1): uint32 words held in int64 numpy arrays or torch tensors
    (or Python ints for the key), masked to 32 bits, so the same code
    serves the evaluator's host draws and the data stream's on a
    device."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def threefry_bits(keys: np.ndarray) -> np.ndarray:
    """uint32 [n] — the 32 random bits ``jax.random.bits`` draws for a
    scalar from each raw key ``keys[i] = [k0, k1]`` (threefry2x32, 20
    rounds, counter (0, 0) under partitionable threefry; the two output
    words are xor-folded)."""
    keys = np.asarray(keys, np.uint32).reshape(-1, 2).astype(np.int64)
    zero = np.zeros(len(keys), np.int64)
    x0, x1 = threefry2x32(keys[:, 0], keys[:, 1], zero, zero)
    return (x0 ^ x1).astype(np.uint32)


_NORMAL_LO = np.nextafter(np.float32(-1.0), np.float32(0.0))


def std_normal(keys: np.ndarray) -> np.ndarray:
    """float32 [n] — ``jax.random.normal(key)`` for each raw key row: the
    mantissa-fill uniform on [nextafter(-1, 0), 1), then √2·erfinv.
    erfinv is taken in float64 and rounded, which agrees with XLA's
    float32 polynomial to ~2e-5."""
    bits = threefry_bits(keys)
    one = np.float32(1.0)
    u = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) \
        - one
    span = one - _NORMAL_LO                    # rounds to 2.0 in float32
    u = np.maximum(_NORMAL_LO, u * span + _NORMAL_LO)
    z = erfinv(u.astype(np.float64)).astype(np.float32)
    return np.float32(np.sqrt(2.0)) * z


def _lognoise(keys: np.ndarray, sigma: float) -> np.ndarray:
    """exp(σ·z) in float32 with one independent standard normal per row."""
    return np.exp(np.float32(sigma) * std_normal(keys))


@dataclass
class AnalyticEvaluator:
    model_cfg: ModelConfig
    cell: ShapeCell
    mesh: MeshShape = SINGLE_POD
    hw: Hardware = V5E
    noise_sigma: float = 0.025          # paper: ±2.5 % benchmark deviation
    seed: int = 0
    history_cap: Optional[int] = None   # keep-all by default (tests); async
                                        # runs cap the record ring buffer
    calls: int = 0
    history: list = field(default_factory=list)

    def breakdown(self, knobs: Config) -> CostBreakdown:
        return estimate(self.model_cfg, self.cell, self.mesh, knobs, self.hw)

    def true_step(self, knobs: Config) -> float:
        """Noise-free objective (tests / regret reporting only)."""
        return self.breakdown(knobs).step_s

    def _record(self, knobs: Config, bd: CostBreakdown, step: float):
        self.history.append({"knobs": dict(knobs), "step_s": step,
                             "true_step_s": bd.step_s,
                             "feasible": bd.feasible})
        _trim_history(self.history, self.history_cap)

    # the evaluation-service layer passes per-request seeds through the
    # batched path when this attribute is set (see service._score_batch)
    accepts_seeds = True

    def __call__(self, knobs: Config, seed: Optional[int] = None) -> float:
        bd = self.breakdown(knobs)
        self.calls += 1
        noise = 1.0
        if self.noise_sigma > 0:
            salt = _noise_salt(seed, self.seed + self.calls)
            keys = _key_data(_stable_seed(knobs, salt))
            noise = float(_lognoise(keys[None], self.noise_sigma)[0])
        step = bd.step_s * noise
        self._record(knobs, bd, step)
        return step

    def evaluate_batch_detailed(
            self, configs: Sequence[Config],
            seeds: Optional[Sequence[Optional[int]]] = None,
    ) -> Tuple[np.ndarray, List[CostBreakdown]]:
        """Score n configs in one shot, returning the per-config cost
        breakdowns alongside the noisy step times.  Same noise stream as n
        sequential ``__call__``\\ s; a per-row entry in ``seeds`` pins that
        row to the seed's noise stream instead."""
        cfgs = list(configs)
        if seeds is None:
            seeds = [None] * len(cfgs)
        if not cfgs:
            return np.zeros(0, np.float64), []
        bds = [self.breakdown(c) for c in cfgs]
        base = self.calls
        self.calls += len(cfgs)
        steps = np.asarray([bd.step_s for bd in bds], np.float64)
        if self.noise_sigma > 0:
            keys = np.stack([
                _key_data(_stable_seed(
                    c, _noise_salt(s, self.seed + base + i + 1)))
                for i, (c, s) in enumerate(zip(cfgs, seeds))])
            steps = steps * _lognoise(keys, self.noise_sigma).astype(
                np.float64)
        for c, bd, s in zip(cfgs, bds, steps):
            self._record(c, bd, float(s))
        return steps, bds

    def evaluate_batch(self, configs: Sequence[Config]) -> np.ndarray:
        return self.evaluate_batch_detailed(configs)[0]


# One card times one step at a time: every CompiledEvaluator measurement
# in the process runs under this lock, whichever thread or service worker
# asks for it.
CARD_LOCK = threading.Lock()


@dataclass
class CompiledEvaluator:
    """Scores a config by running the real step on the card.

    Lazy-imports the launch layer so ``repro_torch.core`` stays light.
    Thread-safe: every ``calls``/``history``/``_cache`` update happens
    under ``_lock``; the measurement itself holds the module's
    :data:`CARD_LOCK` (one step on the card at a time, so the threads of
    a ``max_workers`` worker pool queue for it).  ``service_kind =
    "pool"`` tells :func:`repro_torch.core.service.as_service` to wrap
    this evaluator in a persistent worker pool.

    A measured step is not deterministic: repeated probes of a config are
    equal only through the cache (first writer wins).  A config that runs
    out of the card's memory raises ``torch.cuda.OutOfMemoryError`` (a
    failed evaluation for the service layer); it is not cached, never
    retried smaller and never moved to the CPU.  ``records`` keeps each
    measured config's full ``compile_cell`` record by cache key.
    """
    model_cfg: ModelConfig
    cell: ShapeCell
    multi_pod: bool = False
    max_workers: int = 4               # worker-pool width (as_service)
    history_cap: Optional[int] = None  # keep-all by default; see Analytic
    device: str = "cuda"
    n_layers: Optional[int] = None     # depth cut (None: the cell's
                                       # dryrun.cell_depth, knob-free)
    steps: int = 2                     # timed steps after the warm-up
    calls: int = 0
    history: list = field(default_factory=list)
    records: Dict[str, dict] = field(default_factory=dict)
    _cache: Dict[str, float] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    service_kind = "pool"

    def __post_init__(self):
        from repro_torch.device import resolve_device
        resolve_device(self.device)         # raises without CUDA

    @staticmethod
    def _key(knobs: Config) -> str:
        return json.dumps({k: str(v) for k, v in sorted(knobs.items())},
                          sort_keys=True)

    def _compile(self, knobs: Config) -> float:
        from repro_torch.launch.dryrun import compile_cell  # lazy
        rec = compile_cell(self.model_cfg, self.cell, knobs,
                           multi_pod=self.multi_pod, device=self.device,
                           n_layers=self.n_layers, steps=self.steps)
        with self._lock:
            self.records[self._key(knobs)] = rec
        return rec["measured_step_s"]

    def _measure(self, knobs: Config) -> float:
        with CARD_LOCK:
            return self._compile(knobs)

    def _store(self, key: str, knobs: Config, step: float) -> float:
        """Record a finished measurement; first writer wins on a
        duplicate (two workers may race to measure the same config — the
        cache keeps one value, so the duplicate is dropped, not
        double-counted)."""
        with self._lock:
            if key not in self._cache:
                self.calls += 1
                self.history.append({"knobs": dict(knobs), "step_s": step})
                _trim_history(self.history, self.history_cap)
                self._cache[key] = step
            return self._cache[key]

    def __call__(self, knobs: Config) -> float:
        key = self._key(knobs)
        with self._lock:
            if key in self._cache:
                return self._cache[key]
        step = self._measure(knobs)      # slow path: outside the lock
        return self._store(key, knobs, step)

    def true_step(self, knobs: Config) -> float:
        """The product cluster's objective: ``__call__`` (cache-served on
        repeats).  Exists so both fidelities expose the same validation
        interface."""
        return self(knobs)

    def evaluate_batch(self, configs: Sequence[Config]) -> np.ndarray:
        """Cache hits and duplicate configs within the batch are measured
        once; the rest one after another, since the card times one step
        at a time.  Every finished measurement is stored; the first
        failure is raised after all have ended."""
        cfgs = list(configs)
        keys = [self._key(c) for c in cfgs]
        with self._lock:
            missing: Dict[str, Config] = {}
            for k, c in zip(keys, cfgs):
                if k not in self._cache and k not in missing:
                    missing[k] = c
        failed = []
        for k, c in missing.items():
            try:
                self._store(k, c, self._measure(c))
            except Exception as e:          # noqa: BLE001 -- raised below
                failed.append(e)
        if failed:
            raise failed[0]
        with self._lock:
            return np.asarray([self._cache[k] for k in keys], np.float64)


def evaluate_many(evaluate, configs: Sequence[Config]) -> List[float]:
    """Batch-or-loop shim, delegated through the evaluation-service layer
    (:class:`repro_torch.core.service.CallableServiceAdapter`).  A failed
    evaluation raises instead of returning a failed result."""
    from repro_torch.core.service import CallableServiceAdapter, EvalRequest

    svc = CallableServiceAdapter(evaluate)
    results = svc.gather(svc.submit([EvalRequest(c) for c in configs]))
    failed = [r for r in results if not r.ok]
    if failed:
        raise RuntimeError(
            f"{len(failed)}/{len(results)} evaluations failed; first: "
            f"{failed[0].error}") from failed[0].exception
    return [float(r.value) for r in results]

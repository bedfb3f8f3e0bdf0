"""The port's product-cluster evaluator (``CompiledEvaluator``) on the CPU.

The reference's ``test_compiled_thread_safe_and_capped``
(``tests/test_service_async.py``) runs against the port's class.  One
card times one step at a time, so a measurement never overlaps another,
whether ``evaluate_batch`` or a ``WorkerPoolEvaluationService`` asks for
it (a stubbed measurement records how many run at once).  A
config that runs out of the card's memory is a failed evaluation: the
service returns a failed ``EvalResult``, nothing is cached, and
``evaluate_many`` raises.  ``_compile`` passes the evaluator's device,
depth and step count to ``launch.dryrun.compile_cell`` and keeps its
record; a CPU evaluator runs the smoke config's cell through it.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.costmodel import SINGLE_POD
from repro_torch.core.evaluators import CompiledEvaluator, evaluate_many
from repro_torch.core.knobs import clean_space
from repro_torch.core.sampling import latin_hypercube
from repro_torch.core.service import (EvalRequest, WorkerPoolEvaluationService,
                                      as_service)
from repro_torch.launch import dryrun
from repro_torch.models.config import SHAPES_BY_NAME

CELL = SHAPES_BY_NAME["train_4k"]


def _bare(**fields):
    """An evaluator built as the reference's test builds one: no card
    asked for, ``_compile`` to be stubbed."""
    ev = CompiledEvaluator.__new__(CompiledEvaluator)
    ev.multi_pod = False
    ev.max_workers = 4
    ev.history_cap = None
    ev.calls = 0
    ev.history = []
    ev._cache = {}
    ev._lock = threading.Lock()
    for k, v in fields.items():
        setattr(ev, k, v)
    return ev


class _OneAtATime:
    """A stubbed measurement that records the most running at once."""

    def __init__(self, fail_on=()):
        self.lock = threading.Lock()
        self.running = self.most = self.count = 0
        self.fail_on = set(fail_on)

    def __call__(self, knobs):
        with self.lock:
            self.running += 1
            self.count += 1
            self.most = max(self.most, self.running)
        try:
            time.sleep(0.005)
            if knobs["i"] in self.fail_on:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory (stub)")
            return 0.001 * knobs["i"]
        finally:
            with self.lock:
                self.running -= 1


def test_compiled_thread_safe_and_capped():
    """The reference's test, against the port's class."""
    ev = _bare(history_cap=8)
    ev._compile = lambda knobs: 0.001 * knobs["i"]   # stub the dry-run

    def work(base):
        for i in range(25):
            ev({"i": base * 25 + i})

    threads = [threading.Thread(target=work, args=(b,)) for b in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert ev.calls == 100 and len(ev._cache) == 100
    assert len(ev.history) == 8                # capped
    # cache hits are lock-protected and stable
    assert ev({"i": 42}) == pytest.approx(0.042)
    assert ev.calls == 100


def test_measurements_never_overlap_in_evaluate_batch():
    stub = _OneAtATime()
    ev = _bare(_compile=stub)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        cfgs = [{"i": i % 24} for i in range(40)]     # 24 distinct
        vals = ev.evaluate_batch(cfgs)
    finally:
        sys.setswitchinterval(switch)
    assert stub.most == 1 and stub.count == 24 and ev.calls == 24
    np.testing.assert_allclose(vals, [0.001 * c["i"] for c in cfgs])


def test_measurements_never_overlap_behind_a_service():
    stub = _OneAtATime()
    ev = _bare(_compile=stub)
    svc = as_service(ev)
    assert isinstance(svc, WorkerPoolEvaluationService)
    assert svc.max_workers == 4
    try:
        results = svc.gather(svc.submit(
            [EvalRequest({"i": i}) for i in range(16)]))
    finally:
        svc.close()
    assert all(r.ok for r in results)
    assert stub.most == 1 and stub.count == 16
    assert sorted(r.value for r in results) == pytest.approx(
        [0.001 * i for i in range(16)])


def test_out_of_memory_is_a_failed_evaluation():
    stub = _OneAtATime(fail_on={3})
    ev = _bare(_compile=stub)
    svc = as_service(ev)
    try:
        results = svc.gather(svc.submit(
            [EvalRequest({"i": i}) for i in range(6)]))
    finally:
        svc.close()
    by_i = {r.ticket.request.config["i"]: r for r in results}
    assert not by_i[3].ok
    assert isinstance(by_i[3].exception, torch.cuda.OutOfMemoryError)
    assert all(by_i[i].ok for i in (0, 1, 2, 4, 5))
    # not cached: the failed config is measured again when asked again
    assert ev._key({"i": 3}) not in ev._cache and ev.calls == 5
    with pytest.raises(torch.cuda.OutOfMemoryError):
        ev({"i": 3})
    assert ev.calls == 5
    # the batch path stores what finished, then raises the failure
    ev2 = _bare(_compile=_OneAtATime(fail_on={3}))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        ev2.evaluate_batch([{"i": i} for i in range(6)])
    assert ev2.calls == 5 and ev2._key({"i": 3}) not in ev2._cache
    with pytest.raises(RuntimeError, match="1/6 evaluations failed"):
        evaluate_many(_bare(_compile=_OneAtATime(fail_on={3})),
                      [{"i": i} for i in range(6)])


def test_compile_passes_the_evaluators_settings(monkeypatch):
    seen = []

    def fake(cfg, cell, knobs, **kw):
        seen.append((cfg.name, cell.name, dict(knobs), kw))
        return {"measured_step_s": 0.25, "arch": cfg.name}

    monkeypatch.setattr(dryrun, "compile_cell", fake)
    ev = CompiledEvaluator(get_smoke_config("yi-6b"), CELL, device="cpu",
                           n_layers=2, steps=3)
    assert ev({"microbatch": 2}) == 0.25
    assert ev({"microbatch": 2}) == 0.25 and ev.calls == 1   # cache hit
    assert ev.true_step({"microbatch": 2}) == 0.25
    assert seen == [("yi-6b", "train_4k", {"microbatch": 2},
                     {"multi_pod": False, "device": "cpu", "n_layers": 2,
                      "steps": 3})]
    assert ev.records[ev._key({"microbatch": 2})]["arch"] == "yi-6b"
    assert ev.service_kind == "pool"


def test_cpu_evaluator_runs_the_cell(monkeypatch):
    """A CPU evaluator through the real ``compile_cell`` at smoke width
    (the cell's sequence cut, as ``reduce`` does)."""
    real = dryrun.compile_cell

    def cut(cfg, cell, knobs, **kw):
        return real(cfg, cell, knobs, reduce={"batch": 2, "seq": 16}, **kw)

    monkeypatch.setattr(dryrun, "compile_cell", cut)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ev = CompiledEvaluator(get_smoke_config("yi-6b"), CELL,
                               device="cpu", steps=1)
        v = ev({"remat_policy": "none", "microbatch": 1})
    finally:
        torch.set_num_threads(n)
    rec = ev.records[ev._key({"remat_policy": "none", "microbatch": 1})]
    assert v == rec["measured_step_s"] > 0
    assert rec["runconfig"]["remat_policy"] == "none"
    assert rec["runconfig"]["microbatch"] == 1
    assert np.isfinite(rec["step1_loss"]) and rec["mesh"] == "1xCPU"


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the device is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CompiledEvaluator(get_smoke_config("yi-6b"), CELL)


def test_space_configs_are_keyed_like_the_reference():
    """Two equal configs share a cache key whatever their order; the
    product cluster's probes are the cleaned space's configs."""
    space, _, _ = clean_space(get_config("yi-6b"), CELL, SINGLE_POD)
    cfg = latin_hypercube(space, 1, seed=0)[0]
    flipped = dict(reversed(list(cfg.items())))
    assert CompiledEvaluator._key(cfg) == CompiledEvaluator._key(flipped)

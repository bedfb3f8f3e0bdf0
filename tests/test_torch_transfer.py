"""``repro_torch.transfer`` on the CPU: the reference's transfer cases
run through the port (corpus assembly over evaluation logs,
``TransferBOStrategy``'s warm-start prongs, the ``load_state`` guards the
snapshot/resume path leans on), then the port against the reference.

In the port: an empty corpus is trace-identical to the port's
``BOStrategy`` at equal seed (configs, values and running best, bit for
bit).  Across packages: ``space_signature`` gives the same string for
every catalog space, a corpus file or sharded log written by either
package is read by the other into the same stacked arrays, and the
corpus-best seeds planted in the initial design are identical.  The
multi-task GP under the prior has its own file, ``test_torch_mtgp.py``.

The objectives are deterministic: the trace-identity contract is about
the *strategy's* draws.  Every GP here runs on ``device="cpu"``."""

import warnings
from functools import partial

import numpy as np
import pytest
import torch

from repro_torch.core.controller import EvalDB, EvalRecord
from repro_torch.core.space import Knob, Space
from repro_torch.core.strategy import (BOConfig, BOStrategy, make_strategy,
                                       strategy_names)
from repro_torch.service.shardlog import ShardedEvalLog
from repro_torch.transfer import (CorpusMismatch, TaskData,
                                  TransferBOStrategy, TransferCorpus,
                                  build_corpus, corpus_from_log,
                                  space_signature)

_bo = partial(BOConfig, device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _space():
    return Space((Knob("x", "float", 0.5, lo=0.0, hi=1.0),
                  Knob("y", "float", 0.5, lo=0.0, hi=1.0)))


def _f(c, shift=0.0):
    return (c["x"] - 0.3) ** 2 + (c["y"] - 0.7) ** 2 + 0.05 + shift


def _records(workload, pts, shift=0.0, variance=0.0, status="ok"):
    return [EvalRecord({"x": float(px), "y": float(py)},
                       _f({"x": px, "y": py}, shift), 0.0, "t", workload,
                       "final", status, 1, variance)
            for px, py in pts]


def _grid(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.05, 0.95, size=(n, 2))


def _drive(strategy, f):
    while not strategy.finished:
        cfgs = strategy.ask()
        if not cfgs:
            break
        strategy.tell(cfgs, [float(f(c)) for c in cfgs])
    return strategy


SMALL_BO = dict(n_init=3, n_iter=3, n_candidates=32, fit_steps=10, seed=5)


# ---------------------------------------------------------------------------
# corpus assembly
# ---------------------------------------------------------------------------

class TestCorpusBuild:
    def test_groups_by_workload(self):
        recs = (_records("a", _grid(4)) + _records("b", _grid(3), shift=1.0))
        corpus = build_corpus(_space(), [recs])
        assert corpus.workloads == ("a", "b")
        assert len(corpus) == 7 and bool(corpus)
        a = corpus.tasks[0]
        assert isinstance(a, TaskData) and len(a) == 4
        cfg, val = a.best
        assert val == min(a.values) and _f(cfg) == val

    def test_exclude_and_unstamped(self):
        recs = (_records("a", _grid(4)) + _records("b", _grid(4))
                + _records("", _grid(2)))
        corpus = build_corpus(_space(), [recs], exclude=("b",))
        assert corpus.workloads == ("a",)

    def test_signature_mismatch_skips_loudly(self):
        other = Space((Knob("x", "float", 0.5, lo=0.0, hi=2.0),
                       Knob("y", "float", 0.5, lo=0.0, hi=1.0)))
        assert space_signature(other) != space_signature(_space())
        recs = _records("a", _grid(4)) + _records("b", _grid(4))
        with pytest.warns(CorpusMismatch, match="incompatible space"):
            corpus = build_corpus(_space(), [recs],
                                  spaces={"a": other})
        assert corpus.workloads == ("b",)

    def test_declared_matching_space_keeps_task(self):
        recs = _records("a", _grid(4))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            corpus = build_corpus(_space(), [recs],
                                  spaces={"a": _space()})
        assert corpus.workloads == ("a",)

    def test_bad_rows_dropped_with_warning(self):
        good = _records("a", _grid(4))
        bad = [EvalRecord({"x": 0.5, "z": 0.5}, 1.0, 0.0, "t", "a"),
               EvalRecord({"x": 5.0, "y": 0.5}, 1.0, 0.0, "t", "a"),
               EvalRecord({"x": 0.5, "y": 0.5}, float("nan"), 0.0,
                          "t", "a"),
               EvalRecord({"x": 0.5, "y": 0.5}, 1.0, 0.0, "t", "a",
                          status="failed")]
        with pytest.warns(CorpusMismatch, match="dropped 2"):
            corpus = build_corpus(_space(), [good + bad])
        assert len(corpus.tasks[0]) == 4     # nan/failed skip silently,
                                             # misfit configs warn

    def test_min_points_drops_thin_tasks(self):
        recs = _records("a", _grid(4)) + _records("thin", _grid(1))
        with pytest.warns(CorpusMismatch, match="thin"):
            corpus = build_corpus(_space(), [recs], min_points=2)
        assert corpus.workloads == ("a",)

    def test_sources_files_dirs_missing(self, tmp_path):
        db_a = tmp_path / "a.jsonl"
        db_b = tmp_path / "sub" / "b.jsonl"
        db_b.parent.mkdir()
        EvalDB(str(db_a)).append_batch(_records("a", _grid(3)))
        EvalDB(str(db_b)).append_batch(_records("b", _grid(3)))
        corpus = build_corpus(_space(), [str(db_a), db_b.parent])
        assert corpus.workloads == ("a", "b")
        with pytest.warns(CorpusMismatch, match="does not exist"):
            empty = build_corpus(_space(), [tmp_path / "nope.jsonl"])
        assert not empty and empty.n_tasks == 0

    def test_corpus_from_log_object(self):
        class _Log:
            records = _records("a", _grid(3))
        assert corpus_from_log(_space(), _Log()).workloads == ("a",)

    def test_best_configs_interleaves_best_first(self):
        corpus = build_corpus(_space(), [
            _records("worse", _grid(3), shift=1.0)
            + _records("better", _grid(3))])
        seeds = corpus.best_configs(per_task=2)
        assert len(seeds) == 4
        better, worse = corpus.tasks      # sorted: "better" < "worse"
        assert better.best[1] < worse.best[1]
        assert seeds[0] == better.best[0]     # overall best leads
        assert seeds[1] == worse.best[0]      # then the other task's best
        assert seeds[2] == better.top(2)[1]   # round 2: each task's 2nd

    def test_stacked_log_transform_and_tasks(self):
        corpus = build_corpus(_space(), [
            _records("a", _grid(3), variance=0.01)
            + _records("b", _grid(2), shift=1.0)])
        x, y, var, t = corpus.stacked(log_objective=True)
        assert x.shape == (5, 2) and t.tolist() == [0, 0, 0, 1, 1]
        raw = np.concatenate([corpus.tasks[0].values,
                              corpus.tasks[1].values])
        assert np.allclose(y, np.log(raw))
        assert np.allclose(var[:3], 0.01 / raw[:3] ** 2)   # delta method
        x2, y2, _, _ = corpus.stacked(log_objective=False)
        assert np.allclose(y2, raw) and np.allclose(x, x2)

    def test_stacked_max_per_task_keeps_best(self):
        corpus = build_corpus(_space(), [_records("a", _grid(32))])
        x, y, _, _ = corpus.stacked(max_per_task=8, seed=1)
        assert x.shape[0] == 8
        assert min(y) == pytest.approx(np.log(min(corpus.tasks[0].values)))

    def test_stacked_empty(self):
        corpus = TransferCorpus(_space(), [])
        x, y, var, t = corpus.stacked()
        assert x.shape == (0, 2) and len(y) == len(var) == len(t) == 0


# ---------------------------------------------------------------------------
# TransferBOStrategy
# ---------------------------------------------------------------------------

class TestTransferBO:
    def _corpus(self, n_tasks=2, n=10):
        recs = []
        for i in range(n_tasks):
            recs += _records(f"wl{i}", _grid(n, seed=i), shift=0.1 * i)
        return build_corpus(_space(), [recs])

    def test_empty_corpus_identical_to_plain_bo(self):
        cfg = _bo(**SMALL_BO)
        plain = _drive(BOStrategy(_space(), cfg), _f)
        empty = TransferCorpus(_space(), [])
        xfer = _drive(TransferBOStrategy(_space(), cfg, corpus=empty), _f)
        assert xfer.trace.configs == plain.trace.configs
        assert np.allclose(xfer.trace.values, plain.trace.values)
        none = _drive(TransferBOStrategy(_space(), _bo(**SMALL_BO)),
                      _f)
        assert none.trace.configs == plain.trace.configs

    def test_corpus_bests_seed_the_design(self):
        corpus = self._corpus()
        strat = TransferBOStrategy(_space(), _bo(**SMALL_BO),
                                   corpus=corpus, corpus_fit_steps=20)
        first = strat.ask()
        bests = [corpus.tasks[0].best[0], corpus.tasks[1].best[0]]
        planted = [c for c in first
                   if any(np.isclose(c["x"], b["x"])
                          and np.isclose(c["y"], b["y"]) for b in bests)]
        assert len(planted) >= 1

    def test_pseudo_rows_never_reach_the_trace(self):
        corpus = self._corpus()
        strat = TransferBOStrategy(_space(), _bo(**SMALL_BO),
                                   corpus=corpus, corpus_fit_steps=20)
        assert strat._pseudo_configs          # prior active
        _drive(strat, _f)
        budget = SMALL_BO["n_init"] + SMALL_BO["n_iter"]
        assert len(strat.trace.values) == budget
        cfgs, vals, vrs = strat._training_data()
        assert len(cfgs) == budget + len(strat._pseudo_configs)
        cfg, val = strat.best()
        assert val == pytest.approx(_f(cfg))  # a real measurement

    def test_pseudo_variance_decays_with_evidence(self):
        corpus = self._corpus()
        strat = TransferBOStrategy(_space(), _bo(**SMALL_BO),
                                   corpus=corpus, corpus_fit_steps=20,
                                   decay_tau=2.0)
        _, _, before = strat._training_data()
        cfgs = strat.ask()
        strat.tell(cfgs, [float(_f(c)) for c in cfgs])
        _, _, after = strat._training_data()
        assert after[-1] / before[-1] == pytest.approx(
            np.exp(len(cfgs) / 2.0))

    def test_prior_params_warm_start_without_cfg_flag(self):
        corpus = self._corpus()
        cfg = _bo(**SMALL_BO)
        assert not cfg.warm_start
        strat = TransferBOStrategy(_space(), cfg, corpus=corpus,
                                   corpus_fit_steps=20)
        warm, steps = strat._fit_args()
        assert warm is strat._params and warm is not None
        assert steps == cfg.fit_steps

    def test_space_mismatch_raises(self):
        other = Space((Knob("x", "float", 0.5, lo=0.0, hi=1.0),
                       Knob("z", "float", 0.5, lo=0.0, hi=1.0)))
        corpus = self._corpus()
        with pytest.raises(ValueError, match="knob set"):
            TransferBOStrategy(other, _bo(**SMALL_BO), corpus=corpus)

    def test_registry(self):
        assert "transfer_bo" in strategy_names()
        corpus = self._corpus()
        strat = make_strategy("transfer_bo", _space(), budget=6, seed=5,
                              cfg=_bo(**SMALL_BO), corpus=corpus,
                              corpus_fit_steps=20)
        assert isinstance(strat, TransferBOStrategy)
        assert strat.cfg.n_init + strat.cfg.n_iter == 6

    def test_single_task_corpus_prior(self):
        corpus = self._corpus(n_tasks=1)
        strat = TransferBOStrategy(_space(), _bo(**SMALL_BO),
                                   corpus=corpus, corpus_fit_steps=20)
        assert strat._prior is not None and not strat._prior.multitask
        assert strat._pseudo_configs
        _drive(strat, _f)
        assert strat.best()[1] <= _f(strat.trace.configs[0]) + 1e-9

    def test_transfer_finds_optimum_faster_in_design(self):
        # siblings share the optimum at (0.3, 0.7): the seeded design's
        # very first wave should already be near it
        corpus = self._corpus(n_tasks=3, n=24)
        strat = TransferBOStrategy(_space(), _bo(**SMALL_BO),
                                   corpus=corpus, corpus_fit_steps=20)
        first = strat.ask()
        best_seed = min(_f(c) for c in first)
        corpus_best = min(t.best[1] for t in corpus.tasks)
        assert best_seed <= corpus_best + 1e-9


# ---------------------------------------------------------------------------
# load_state space-identity guards
# ---------------------------------------------------------------------------

def _dyn_space():
    return Space((Knob("x", "float", 0.5, lo=0.0, hi=1.0),
                  Knob("y", "float", 0.5, lo=0.0, hi=1.0,
                       dynamic_bound=True)))


class TestLoadStateGuards:
    def _snapshot(self, space=None, cfg=None):
        strat = BOStrategy(space or _space(), cfg or _bo(**SMALL_BO))
        cfgs = strat.ask()
        strat.tell(cfgs, [float(_f(c)) for c in cfgs])
        return strat, strat.state_dict()

    def test_roundtrip_restores(self):
        strat, sd = self._snapshot()
        twin = BOStrategy(_space(), _bo(**SMALL_BO))
        twin.load_state(sd)
        assert twin.trace.configs == strat.trace.configs
        assert np.allclose(twin.trace.values, strat.trace.values)

    def test_knob_renamed_raises(self):
        _, sd = self._snapshot()
        renamed = Space((Knob("x", "float", 0.5, lo=0.0, hi=1.0),
                         Knob("y2", "float", 0.5, lo=0.0, hi=1.0)))
        with pytest.raises(ValueError, match="space mismatch"):
            BOStrategy(renamed, _bo(**SMALL_BO)).load_state(sd)

    def test_base_bounds_widened_raises(self):
        _, sd = self._snapshot()
        widened = Space((Knob("x", "float", 0.5, lo=0.0, hi=2.0),
                         Knob("y", "float", 0.5, lo=0.0, hi=1.0)))
        with pytest.raises(ValueError, match="base bounds differ"):
            BOStrategy(widened, _bo(**SMALL_BO)).load_state(sd)

    def test_kernel_changed_raises(self):
        _, sd = self._snapshot()
        other = BOStrategy(_space(), _bo(kernel="rbf", **SMALL_BO))
        with pytest.raises(ValueError, match="kernel"):
            other.load_state(sd)

    def test_dynamic_bound_restore_still_works(self):
        strat = BOStrategy(_dyn_space(), _bo(**SMALL_BO))
        cfgs = strat.ask()
        strat.tell(cfgs, [float(_f(c)) for c in cfgs])
        # simulate a boundary expansion having happened
        k = strat.space.knob("y")
        from dataclasses import replace as _rp
        strat.space = strat.space.with_knob(_rp(k, hi=2.0))
        sd = strat.state_dict()
        twin = BOStrategy(_dyn_space(), _bo(**SMALL_BO))
        twin.load_state(sd)
        assert twin.space.knob("y").hi == 2.0     # dynamic state restored
        assert twin._base_bounds["y"] == (0.0, 1.0)

    def test_legacy_state_without_guards_loads(self):
        strat, sd = self._snapshot()
        sd.pop("knobs")
        sd.pop("base_bounds")
        twin = BOStrategy(_space(), _bo(**SMALL_BO))
        twin.load_state(sd)                       # backward compatible
        assert twin.trace.configs == strat.trace.configs


# ---------------------------------------------------------------------------
# in the port, and across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch_size", [None, 3])
def test_empty_corpus_is_trace_identical_to_port_bo(batch_size):
    kw = dict(budget=8, seed=5, batch_size=batch_size,
              cfg=_bo(n_init=4, n_iter=4, n_candidates=64, fit_steps=15,
                      seed=5))
    plain = _drive(make_strategy("bo", _space(), **kw), _f)
    for corpus in (None, TransferCorpus(_space(), [])):
        xfer = _drive(make_strategy("transfer_bo", _space(), corpus=corpus,
                                    **kw), _f)
        assert xfer._prior is None
        assert xfer.trace.configs == plain.trace.configs
        assert xfer.trace.values == plain.trace.values
        assert xfer.trace.best_values == plain.trace.best_values


def _ref_space():
    from repro.core.space import Knob as RKnob
    from repro.core.space import Space as RSpace
    return RSpace((RKnob("x", "float", 0.5, lo=0.0, hi=1.0),
                   RKnob("y", "float", 0.5, lo=0.0, hi=1.0)))


def _ref_records(recs):
    from repro.core.controller import EvalRecord as REvalRecord
    return [REvalRecord(**r.__dict__) for r in recs]


def test_corpus_seeds_identical_across_packages():
    from repro.core.strategy import BOConfig as RBOConfig
    from repro.transfer import TransferBOStrategy as RTransfer
    from repro.transfer import build_corpus as rbuild
    recs = []
    for i in range(3):
        recs += _records(f"wl{i}", _grid(10, seed=i), shift=0.1 * i)
    corpus = build_corpus(_space(), [recs])
    rcorpus = rbuild(_ref_space(), [_ref_records(recs)])
    strat = TransferBOStrategy(_space(), _bo(**SMALL_BO), corpus=corpus,
                               corpus_fit_steps=20)
    rstrat = RTransfer(_ref_space(), RBOConfig(**SMALL_BO), corpus=rcorpus,
                       corpus_fit_steps=20)
    assert strat._prior.multitask and rstrat._prior.multitask
    assert corpus.best_configs(per_task=2) == rcorpus.best_configs(
        per_task=2)
    assert strat._pseudo_configs == rstrat._pseudo_configs
    assert strat.ask() == rstrat.ask()      # the seeded initial design


@pytest.mark.parametrize("workload", [
    f"{a}:{s}" for a in ("yi-6b", "qwen1.5-4b", "xlstm-1.3b")
    for s in ("train_4k", "decode_32k")])
def test_space_signature_equal_for_every_catalog_space(workload):
    from repro.configs import get_smoke_config
    from repro.core.costmodel import SINGLE_POD
    from repro.core.knobs import clean_space
    from repro.models.config import SHAPES_BY_NAME
    from repro.transfer import space_signature as rsignature
    from repro_torch.service import default_catalog
    space, _ = default_catalog()[workload].materialize()
    arch, shape = workload.split(":")
    rspace, _, _ = clean_space(get_smoke_config(arch),
                               SHAPES_BY_NAME[shape], SINGLE_POD)
    assert len(space) == len(rspace) >= 327
    assert space_signature(space) == rsignature(rspace)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_corpus_files_are_read_by_both_packages(tmp_path, writer):
    """An EvalDB file and a sharded log root written by one package are
    mined into the same corpus by both."""
    from repro.service.shardlog import ShardedEvalLog as RShardedEvalLog
    from repro.core.controller import EvalDB as REvalDB
    from repro.transfer import build_corpus as rbuild
    a = _records("a", _grid(5), variance=0.01)
    b = _records("b", _grid(4, seed=1), shift=1.0)
    if writer == "port":
        EvalDB(str(tmp_path / "a.jsonl")).append_batch(a)
        ShardedEvalLog(str(tmp_path / "log"), n_shards=2).namespace(
            "s0001").append_batch(b)
    else:
        REvalDB(str(tmp_path / "a.jsonl")).append_batch(_ref_records(a))
        RShardedEvalLog(str(tmp_path / "log"), n_shards=2).namespace(
            "s0001").append_batch(_ref_records(b))
    sources = [str(tmp_path / "a.jsonl"), tmp_path / "log"]
    mine = build_corpus(_space(), sources)
    ref = rbuild(_ref_space(), sources)
    assert mine.workloads == ref.workloads == ("a", "b")
    for got, want in zip(mine.stacked(), ref.stacked()):
        np.testing.assert_array_equal(got, want)

"""Sharded q-EI candidate scoring in the port (``gp.select_batch_sharded``)
against its one-device path and the JAX reference, mirroring
``tests/test_shard_select.py``:

* the proposer's device helpers (``parallel.sharding``): a deterministic
  prefix of the host's cards (part of the pick-reproducibility contract)
  and the spare card for background refits, on a stubbed card count;
* sharded picks equal ``gp.select_batch``'s and the reference's
  ``select_batch``'s at a state carried across (``gp.state_from_numpy``),
  at 1, 2 and 3 shards (a tuple naming the CPU once per shard), across
  fantasy x acquisition, q 1 at an even pool, odd pools (pad rows, never
  picked), the kernel route and the tuner's 16 knobs;
* ``BOConfig.shard_candidates`` never changes a trace, and a one-device
  host falls back to ``select_batch``; ``_refit_device`` takes the spare
  card of a two-card host.
"""

import numpy as np
import pytest
import torch

from repro.core import gp as rgp
from repro_torch.core import gp
from repro_torch.core import strategy as ps
from repro_torch.core.space import Knob, Space
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import (POOL_AXIS, pool_devices,
                                           spare_device)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(n=26, d=3, q=3, seed=0, steps=30):
    """The reference's fitted state, carried to torch on the CPU."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, d))
    y = (np.sin(3 * x[:, 0]) + (x[:, 1] - 0.4) ** 2
         + 0.1 * rng.normal(size=n))
    st = rgp.fit(x, y, steps=steps, pad_to=rgp._bucket(n + q))
    y_raw = np.zeros(int(st.x.shape[0]), np.float32)
    y_raw[:n] = y
    pst = gp.state_from_numpy(
        {k: np.asarray(v) for k, v in st.params._asdict().items()},
        *(np.asarray(f) for f in st[1:]), device="cpu")
    return st, pst, y_raw, n, float(np.min(y))


def _all_picks(rst, pst, cand, y_raw, n, best_y, q, shards=(1, 2, 3),
               **kw):
    """(reference picks, port select_batch picks, {k: sharded picks})."""
    rkw = dict(kw)
    if "use_kernel" in rkw:
        rkw["use_pallas"] = rkw.pop("use_kernel")
    want = np.asarray(rgp.select_batch(rst, cand, y_raw, n, best_y, q,
                                       **rkw))
    base = gp.select_batch(pst, cand, y_raw, n, best_y, q, **kw).numpy()
    sharded = {k: gp.select_batch_sharded(pst, cand, y_raw, n, best_y, q,
                                          devices=(CPU,) * k, **kw).numpy()
               for k in shards}
    return want, base, sharded


class TestPoolDevices:
    def test_cpu_strategy_pools_over_the_host(self):
        assert POOL_AXIS == "pool"
        assert pool_devices(device="cpu") == (CPU,)
        assert pool_devices(1, "cpu") == (CPU,)
        assert pool_devices(99, "cpu") == (CPU,)
        assert spare_device(device="cpu") is None

    def test_deterministic_prefix_of_the_cards(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
        cards = tuple(torch.device("cuda", i) for i in range(3))
        assert pool_devices() == cards
        assert pool_devices(2) == cards[:2]
        assert pool_devices(1) == cards[:1]
        assert pool_devices(0) == cards[:1]       # at least one
        assert pool_devices(99) == cards          # clamped to the host

    @pytest.mark.parametrize("count, avoid, want", [
        (1, 0, None), (2, 0, 1), (3, 0, 2), (3, 2, 1)])
    def test_spare_device(self, monkeypatch, count, avoid, want):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        got = spare_device(avoid_index=avoid)
        assert got == (None if want is None else torch.device("cuda", want))


class TestShardedIdentity:
    """1-3 shards == select_batch == the reference, on one pool."""

    @pytest.mark.parametrize("fantasy", ["liar", "believer"])
    @pytest.mark.parametrize("acq", ["ei", "ucb"])
    def test_matches_select_batch(self, fantasy, acq):
        rst, pst, y_raw, n, best_y = _problem(seed=1)
        cand = np.random.default_rng(2).random((37, 3)).astype(np.float32)
        want, base, sharded = _all_picks(rst, pst, cand, y_raw, n, best_y,
                                         3, fantasy=fantasy,
                                         acquisition=acq)
        np.testing.assert_array_equal(base, want)
        for k, got in sharded.items():
            np.testing.assert_array_equal(got, base, err_msg=f"{k} shards")

    def test_q1_and_even_pool(self):
        rst, pst, y_raw, n, best_y = _problem(n=20, q=1, seed=3)
        cand = np.random.default_rng(4).random((64, 3)).astype(np.float32)
        want, base, sharded = _all_picks(rst, pst, cand, y_raw, n, best_y,
                                         1, shards=(1, 2, 4))
        np.testing.assert_array_equal(base, want)
        for k, got in sharded.items():
            np.testing.assert_array_equal(got, base, err_msg=f"{k} shards")

    @pytest.mark.parametrize("shards", [2, 3])
    def test_pad_rows_never_picked(self, shards):
        """An odd pool: the pad rows (unit-cube midpoints, often good
        candidates) start out taken and never appear in the picks."""
        rst, pst, y_raw, n, best_y = _problem(seed=5)
        cand = np.random.default_rng(6).random((41, 3)).astype(np.float32)
        cand[-1] = 0.49            # a near-twin of the pad row
        got = gp.select_batch_sharded(pst, cand, y_raw, n, best_y, 4,
                                      devices=(CPU,) * shards).numpy()
        assert np.all(got < 41)
        np.testing.assert_array_equal(
            got, gp.select_batch(pst, cand, y_raw, n, best_y, 4).numpy())

    @pytest.mark.parametrize("q", [2, 8])
    def test_kernel_route_at_the_tuner_width(self, q):
        """``use_kernel`` (the plain version on CPU tensors) at 16 knobs,
        over a pool of LHS points, a local ball and axis sweeps."""
        rst, pst, y_raw, n, best_y = _problem(n=40, d=16, q=q, seed=7)
        rng = np.random.default_rng(8)
        inc = rng.random(16)
        cand = np.vstack([rng.random((150, 16)),
                          np.clip(inc + rng.normal(0, 0.08, (40, 16)), 0, 1),
                          np.repeat(inc[None], 16, 0)]).astype(np.float32)
        cand[-16:][np.arange(16), np.arange(16)] = 0.5
        want, base, sharded = _all_picks(rst, pst, cand, y_raw, n, best_y,
                                         q, use_kernel=True)
        np.testing.assert_array_equal(base, want)
        for k, got in sharded.items():
            np.testing.assert_array_equal(got, base, err_msg=f"{k} shards")

    def test_default_devices_is_the_state_device(self):
        _, pst, y_raw, n, best_y = _problem(seed=9)
        cand = np.random.default_rng(10).random((30, 3)).astype(np.float32)
        np.testing.assert_array_equal(
            gp.select_batch_sharded(pst, cand, y_raw, n, best_y, 3).numpy(),
            gp.select_batch(pst, cand, y_raw, n, best_y, 3).numpy())

    def test_no_devices_raises(self):
        _, pst, y_raw, n, best_y = _problem(seed=9)
        with pytest.raises(ValueError, match="at least one device"):
            gp.select_batch_sharded(pst, np.zeros((4, 3), np.float32),
                                    y_raw, n, best_y, 1, devices=())


def _space():
    return Space((Knob("x", "float", 0.5, lo=0.0, hi=1.0),
                  Knob("y", "float", 0.5, lo=0.0, hi=1.0),
                  Knob("k", "int", 4, lo=1, hi=16),
                  Knob("c", "categorical", "a", choices=("a", "b", "c"))))


def _f(c):
    return ((c["x"] - 0.7) ** 2 + (c["y"] - 0.35) ** 2
            + 0.01 * c["k"] + (0.3 if c["c"] == "b" else 0.0))


def _run(**cfg_kw):
    strat = ps.BOStrategy(_space(), ps.BOConfig(
        n_init=6, n_iter=9, batch_size=3, n_candidates=128, n_local=32,
        fit_steps=20, seed=4, device="cpu", **cfg_kw))
    while not strat.finished:
        cfgs = strat.ask()
        if not cfgs:
            break
        strat.tell(cfgs, [float(_f(c)) for c in cfgs])
    return strat


class TestStrategyGate:
    def test_one_device_falls_back(self):
        strat = ps.BOStrategy(_space(), ps.BOConfig(shard_candidates=True,
                                                    device="cpu"))
        assert strat._shard_devices() is None
        off = ps.BOStrategy(_space(), ps.BOConfig(device="cpu"))
        assert off._shard_devices() is None

    @pytest.mark.parametrize("gate, shards", [(True, 3), (2, 2)])
    def test_gate_never_changes_a_trace(self, monkeypatch, gate, shards):
        """The sharded path inside ask (three CPU shards standing in for
        the host's cards) gives the trace of the gate-off run."""
        base = _run()
        calls = []

        def devices(n=None, device="cuda"):
            calls.append(n)
            return (CPU,) * (shards if n is None else int(n))
        monkeypatch.setattr(ps, "pool_devices", devices)
        sharded = _run(shard_candidates=gate)
        assert calls and all(c == (None if gate is True else gate)
                             for c in calls)
        assert sharded.trace.configs == base.trace.configs
        assert sharded.trace.values == base.trace.values


class TestRefitDevice:
    def _strategy(self, monkeypatch, count, **cfg_kw):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        monkeypatch.setattr(ps, "resolve_device",
                            lambda d: torch.device(d) if d == "cpu"
                            else torch.device("cuda", 0))
        return ps.BOStrategy(_space(), ps.BOConfig(refit_async=True,
                                                   **cfg_kw))

    def test_spare_card_of_a_two_card_host(self, monkeypatch):
        st = self._strategy(monkeypatch, 2)
        assert st._refit_device() == torch.device("cuda", 1)
        assert sharding.spare_device() == torch.device("cuda", 1)

    def test_one_card_shares_it(self, monkeypatch):
        st = self._strategy(monkeypatch, 1)
        assert st._refit_device() == torch.device("cuda", 0)

    def test_pinned_card_wins(self, monkeypatch):
        st = self._strategy(monkeypatch, 2, refit_device=0)
        assert st._refit_device() == torch.device("cuda", 0)
        st = self._strategy(monkeypatch, 2, refit_device=3)
        assert st._refit_device() == torch.device("cuda", 1)

    def test_cpu_strategy_stays_home(self, monkeypatch):
        st = self._strategy(monkeypatch, 2, device="cpu")
        assert st._refit_device() == CPU

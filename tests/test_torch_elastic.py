"""The port's elastic control plane (``repro_torch.train.elastic``, pure
Python) on the reference's ``TestElastic`` cases
(``tests/test_runtime.py``), and against the reference's own decisions
over a sweep of carves and fleet health maps."""

import itertools

import pytest

from repro.train import elastic as jelastic
from repro_torch.train import elastic


class TestElastic:
    def test_watchdog_flags_persistent_straggler(self):
        w = elastic.StepWatchdog(patience=2)
        for t in range(12):
            for h in range(4):
                w.observe(h, 1.0 + (3.0 if (h == 2 and t > 7) else 0.0))
            health = w.classify()
        assert health[2] == elastic.STRAGGLER
        assert health[0] == elastic.HEALTHY

    def test_watchdog_ignores_transient(self):
        w = elastic.StepWatchdog(patience=3)
        for t in range(10):
            for h in range(4):
                w.observe(h, 4.0 if (h == 1 and t == 5) else 1.0)
            health = w.classify()
        assert health[1] == elastic.HEALTHY

    def test_recarve_keeps_model_axis(self):
        c = elastic.Carve(2, 16, 16)
        new = elastic.recarve(c.chips - 16, c)
        assert new.model == 16
        assert new.chips <= c.chips - 16

    def test_reshard_plan_covers_all_new_shards(self):
        plan = elastic.plan_reshard(elastic.Carve(1, 8, 4),
                                    elastic.Carve(1, 6, 4))
        targets = {j for _, j in plan.param_moves}
        assert targets == set(range(6))

    def test_policy_actions(self):
        pol = elastic.ElasticPolicy(elastic.Carve(1, 16, 16),
                                    chips_per_host=8)
        assert pol.decide({0: "healthy"}, None)[0] == "continue"
        act = pol.decide({0: "healthy", 1: "dead"}, 500)
        assert act[0] == "restore" and act[1] == 500
        act = pol.decide({0: "healthy", 1: "straggler"}, None)
        assert act[0] == "evict"


def _plain(x):
    """Carves and plans as plain tuples, for comparing across packages."""
    if hasattr(x, "pod"):
        return ("carve", x.pod, x.data, x.model)
    if hasattr(x, "param_moves"):
        return ("plan", _plain(x.old), _plain(x.new), x.batch_scale,
                x.param_moves, x.summary())
    if isinstance(x, tuple):
        return tuple(_plain(e) for e in x)
    return x


@pytest.mark.parametrize("pod,data,model", [(1, 16, 16), (2, 16, 16),
                                            (1, 8, 4), (4, 2, 8)])
def test_decisions_match_reference(pod, data, model):
    carve = (pod, data, model)
    for alive in range(1, pod * data * model + 1, 7):
        try:
            want = jelastic.recarve(alive, jelastic.Carve(*carve))
        except ValueError:
            with pytest.raises(ValueError):
                elastic.recarve(alive, elastic.Carve(*carve))
            continue
        got = elastic.recarve(alive, elastic.Carve(*carve))
        assert _plain(got) == _plain(want)
        assert _plain(elastic.plan_reshard(elastic.Carve(*carve), got)) == \
            _plain(jelastic.plan_reshard(jelastic.Carve(*carve), want))
    states = ("healthy", "straggler", "dead")
    for health in itertools.product(states, repeat=3):
        hmap = dict(enumerate(health))
        for evict in (True, False):
            jp = jelastic.ElasticPolicy(jelastic.Carve(*carve),
                                        chips_per_host=pod * data * model
                                        // 2 or 1,
                                        evict_stragglers=evict)
            tp = elastic.ElasticPolicy(elastic.Carve(*carve),
                                       chips_per_host=pod * data * model
                                       // 2 or 1, evict_stragglers=evict)
            try:
                want = jp.decide(hmap, 7)
            except ValueError:
                with pytest.raises(ValueError):
                    tp.decide(hmap, 7)
                continue
            assert _plain(tp.decide(hmap, 7)) == _plain(want)


def test_watchdog_matches_reference_on_a_trace():
    w, jw = elastic.StepWatchdog(k=1.3, patience=2, window=8), \
        jelastic.StepWatchdog(k=1.3, patience=2, window=8)
    for t in range(40):
        for h in range(5):
            s = 1.0 + 0.1 * ((t * 7 + h * 3) % 5) + (2.0 if h == t % 5 else 0)
            w.observe(h, s)
            jw.observe(h, s)
        assert w.classify() == jw.classify()

"""The GP fit on the card: one Adam step captured in a CUDA graph and
replayed (``gp._graphed_fit``), the multi-task fit's graph, the graph
cache's bound, and fits on 8 threads at once.  Needs an NVIDIA GPU
(``cuda`` marker); skips without one.  Imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_gp_cuda.py

The graphed fit must be bit-equal (``torch.equal``) to the same step
function run eagerly with the same kernels, cold (150 steps) and warm
(50), as ``BOStrategy`` runs them at the main path's shape (56 points
padded to 64, 16 knobs).  The kernel fit (backward kernel) must be within
``PARAM_ATOL`` = 5e-3 of the plain fit (autograd through the plain
Matérn), the tolerance of ``tests/test_torch_gp.py``.  The multi-task fit
(two tasks of 56 rows at the tuning daemon's 327 knobs) is held the same
way: graphed against eager (200 cold + 50 warm steps, bit-equal), kernel
against plain (``PARAM_ATOL``).  A graph evicted from the bounded cache
and captured again gives the same bits.
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch.core import gp
from repro_torch.core import strategy as ps
from repro_torch.core.space import Knob, Space
from repro_torch.kernels.gp_gram import ops

PARAM_ATOL = 5e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fit's CUDA graph and kernels "
                    "have no CPU mode")
    return torch.device("cuda")


def _data(n=56, d=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, d))
    y = np.log(1.0 + x[:, 0] + (x[:, 1] - 0.4) ** 2
               + 0.05 * rng.normal(size=n))
    return x, y


def _problem(device, obs_var=False, seed=0):
    x, y = _data(seed=seed)
    var = (np.random.default_rng(seed + 1).uniform(0, 0.01, len(y))
           if obs_var else None)
    xj, yj, ej, _, _ = gp._prepare(x, y, True, device, 64, var)
    return gp.init_params(x.shape[1], device=device), xj, yj, ej


def _equal(a, b) -> bool:
    return all(torch.equal(u, w) for u, w in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("use_kernel,obs_var", [(True, False), (True, True),
                                                (False, False)])
def test_graphed_fit_equals_the_eager_steps(use_kernel, obs_var, cuda):
    params, x, y, extra = _problem(cuda, obs_var)
    cold = gp._fit(params, x, y, "matern52", steps=150, extra_noise=extra,
                   use_kernel=use_kernel)
    want = gp._eager_fit(params, x, y, "matern52", 150, 0.05, extra,
                         use_kernel)
    assert _equal(cold, want)
    warm = gp._fit(cold, x, y, "matern52", steps=50, extra_noise=extra,
                   use_kernel=use_kernel)
    want = gp._eager_fit(cold, x, y, "matern52", 50, 0.05, extra,
                         use_kernel)
    assert _equal(warm, want)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_fit_is_within_param_atol_of_the_plain_fit(seed, cuda):
    x, y = _data(seed=seed)
    kern = gp.fit(x, y, steps=150, pad_to=64, use_kernel=True, device=cuda)
    plain = gp.fit(x, y, steps=150, pad_to=64, use_kernel=False,
                   device=cuda)
    for a, b in zip(kern.params, plain.params):
        torch.testing.assert_close(a, b, atol=PARAM_ATOL, rtol=0)


@pytest.mark.cuda
def test_second_fit_at_the_same_shape_replays_the_cached_graph(cuda):
    params, x, y, _ = _problem(cuda, seed=2)
    gp._fit(params, x, y, "matern52", steps=20, use_kernel=True)
    captures, graphs = gp.graph_captures, dict(gp._GRAPHS)
    other = _problem(cuda, seed=3)
    gp._fit(other[0], other[1], other[2], "matern52", steps=20,
            use_kernel=True)
    assert gp.graph_captures == captures
    assert gp._GRAPHS == graphs


@pytest.mark.cuda
def test_launch_counters_advance_per_replay(cuda):
    params, x, y, _ = _problem(cuda, seed=4)
    gp._fit(params, x, y, "matern52", steps=5, use_kernel=True)  # captured
    ops.reset_launch_counts()
    gp._fit(params, x, y, "matern52", steps=7, use_kernel=True)
    assert (ops.gram_launches, ops.gram_bwd_launches,
            ops.cross_launches) == (7, 7, 0)
    gp._fit(params, x, y, "matern52", steps=7, use_kernel=False)
    assert (ops.gram_launches, ops.gram_bwd_launches) == (7, 7)


def _spaces():
    return Space((Knob("x", "float", 0.5, lo=0.0, hi=1.0),
                  Knob("y", "float", 0.5, lo=0.0, hi=1.0),
                  Knob("k", "int", 4, lo=1, hi=16)))


@pytest.mark.cuda
def test_refit_async_fits_on_its_executor_thread_with_the_graph(
        cuda, monkeypatch):
    threads = []
    run = gp._FitGraph.run

    def spy(self, *a, **k):
        threads.append(threading.current_thread().name)
        return run(self, *a, **k)

    monkeypatch.setattr(gp._FitGraph, "run", spy)
    monkeypatch.setattr(gp, "_GRAPHS", {})      # capture on first use
    s = ps.BOStrategy(_spaces(), ps.BOConfig(
        n_init=6, n_iter=12, batch_size=2, n_candidates=128, fit_steps=30,
        refit_async=True, use_kernel=True, seed=1, device="cuda"))
    while not s.finished:
        cfgs = s.ask()
        if not cfgs:
            break
        s.tell(cfgs, [(c["x"] - 0.7) ** 2 + (c["y"] - 0.3) ** 2
                      + 0.01 * c["k"] for c in cfgs])
    s.close()
    assert s.finished and len(s.trace.values) == 6 + 12
    assert any(t.startswith("gp-refit") for t in threads), threads
    assert all(np.isfinite(s.trace.values))


# ---------------------------------------------------------------------------
# the multi-task fit, the graph cache's bound, and fits on many threads
# ---------------------------------------------------------------------------

def _corpus(device, n_tasks=2, n=56, d=327, seed=0, obs_var=False):
    """A two-task corpus at the tuning daemon's width, prepared as
    ``fit_multitask`` prepares it: (init params, x, tasks, y, extra)."""
    rng = np.random.default_rng(seed)
    x = rng.random((n_tasks * n, d))
    t = np.repeat(np.arange(n_tasks, dtype=np.int32), n)
    y = np.log(1.0 + x[:, 0] + (x[:, 1] - 0.4) ** 2 + 0.3 * t
               + 0.05 * rng.normal(size=len(t)))
    var = rng.uniform(0, 1e-3, len(t)) if obs_var else None
    xj, tj, yj, extra, _, _, off = gp._mt_prepare(x, y, t, var, device)
    return (gp.init_mt_params(d, n_tasks, offsets=off, device=device), xj,
            tj, yj, extra)


@pytest.mark.cuda
@pytest.mark.parametrize("use_kernel,obs_var", [(True, False), (True, True),
                                                (False, False)])
def test_graphed_mtgp_fit_equals_the_eager_steps(use_kernel, obs_var, cuda):
    params, x, t, y, extra = _corpus(cuda, obs_var=obs_var)
    kw = dict(extra_noise=extra, use_kernel=use_kernel)
    cold = gp._mt_fit(params, x, t, y, "matern52", steps=200, **kw)
    want = gp._mt_fit(params, x, t, y, "matern52", steps=200, graphed=False,
                      **kw)
    assert _equal(cold, want)
    warm = gp._mt_fit(cold, x, t, y, "matern52", steps=50, **kw)
    want = gp._mt_fit(cold, x, t, y, "matern52", steps=50, graphed=False,
                      **kw)
    assert _equal(warm, want)


@pytest.mark.cuda
def test_mtgp_kernel_fit_is_within_param_atol_of_the_plain_fit(cuda):
    params, x, t, y, extra = _corpus(cuda, seed=1)
    kern = gp._mt_fit(params, x, t, y, "matern52", steps=200,
                      use_kernel=True)
    plain = gp._mt_fit(params, x, t, y, "matern52", steps=200,
                       use_kernel=False, graphed=False)
    for a, b in zip(kern, plain):
        torch.testing.assert_close(a, b, atol=PARAM_ATOL, rtol=0)


@pytest.mark.cuda
def test_mtgp_gradient_reaches_the_backward_kernel(cuda):
    """The ICM Gram's gradient goes through ``G ∘ B[t, t]`` into the
    backward kernel: one launch per backward, and within relative L2 1e-3
    of autograd through the plain Gram."""
    params, x, t, y, extra = _corpus(cuda, n_tasks=3, n=40, seed=2,
                                     obs_var=True)
    grads = {}
    for use_kernel in (True, False):
        leaf = gp._mt_flat(params).requires_grad_(True)
        before = ops.gram_bwd_launches
        loss = gp.mt_neg_log_marginal(gp._mt_unflat(leaf, 3), x, t, y,
                                      "matern52", extra, use_kernel)
        (grads[use_kernel],) = torch.autograd.grad(loss, [leaf])
        assert ops.gram_bwd_launches == before + use_kernel
    a, b = grads[True].double(), grads[False].double()
    assert float((a - b).norm() / b.norm()) <= 1e-3


@pytest.mark.cuda
def test_an_evicted_graph_is_recaptured_bit_equal(cuda, monkeypatch):
    monkeypatch.setattr(gp, "_GRAPHS", {})
    monkeypatch.setattr(gp, "_GRAPH_CAPACITY", 2)
    fits = {}
    for d in (327, 330, 332):                 # the third evicts the first
        x, y = _data(d=d, seed=d)
        xj, yj, _, _, _ = gp._prepare(x, y, True, cuda, 64)
        fits[d] = (gp.init_params(d, device=cuda), xj, yj)
    first = gp._fit(*fits[327], "matern52", steps=60, use_kernel=True)
    captures, evictions = gp.graph_captures, gp.graph_evictions
    for d in (330, 332):
        gp._fit(*fits[d], "matern52", steps=60, use_kernel=True)
    assert gp.graph_evictions == evictions + 1 and len(gp._GRAPHS) == 2
    again = gp._fit(*fits[327], "matern52", steps=60, use_kernel=True)
    assert gp.graph_captures == captures + 3  # 330, 332, then 327 anew
    assert gp.graph_evictions == evictions + 2
    assert _equal(again, first)
    want = gp._eager_fit(*fits[327], "matern52", 60, 0.05, None, True)
    assert _equal(again, want)


@pytest.mark.cuda
def test_eight_threads_fit_at_once_with_exact_launch_counts(cuda,
                                                            monkeypatch):
    """8 threads fit and predict at once, two of the shapes captured
    while other threads launch: every result equals the same fit run
    alone afterwards, bit for bit, and the launch counters are exact —
    per fit ``steps`` replays and one posterior Gram, one cross-Gram per
    predict, and three eager warm-up steps per capture."""
    monkeypatch.setattr(gp, "_GRAPHS", {})
    steps, n_threads = 40, 8
    jobs = [_data(d=327 if i % 2 else 330, seed=10 + i)
            for i in range(n_threads)]
    xq = torch.rand((256, 330), device=cuda)
    results, errors = {}, []
    barrier = threading.Barrier(n_threads)

    def work(i):
        x, y = jobs[i]
        try:
            barrier.wait()
            st = gp.fit(x, y, steps=steps, pad_to=64, use_kernel=True,
                        device=cuda)
            mu, _ = gp.predict(st, xq[:, :x.shape[1]].contiguous(),
                               use_kernel=True)
            results[i] = (st.params, mu)
        except Exception as e:              # reported below
            errors.append(repr(e))

    ops.reset_launch_counts()
    captures = gp.graph_captures
    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    assert errors == []
    new = gp.graph_captures - captures
    assert new == 2
    assert (ops.gram_launches, ops.gram_bwd_launches, ops.cross_launches) \
        == (n_threads * (steps + 1) + 3 * new, n_threads * steps + 3 * new,
            n_threads)
    for i, (x, y) in enumerate(jobs):
        st = gp.fit(x, y, steps=steps, pad_to=64, use_kernel=True,
                    device=cuda)
        mu, _ = gp.predict(st, xq[:, :x.shape[1]].contiguous(),
                           use_kernel=True)
        assert _equal(results[i][0], st.params)
        assert torch.equal(results[i][1], mu)

"""The GP fit on the card: one Adam step captured in a CUDA graph and
replayed (``gp._graphed_fit``).  Needs an NVIDIA GPU (``cuda`` marker);
skips without one.  Imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_gp_cuda.py

The graphed fit must be bit-equal (``torch.equal``) to the same step
function run eagerly with the same kernels, cold (150 steps) and warm
(50), as ``BOStrategy`` runs them at the main path's shape (56 points
padded to 64, 16 knobs).  The kernel fit (backward kernel) must be within
``PARAM_ATOL`` = 5e-3 of the plain fit (autograd through the plain
Matérn), the tolerance of ``tests/test_torch_gp.py``.
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

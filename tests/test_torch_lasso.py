"""The port's lasso (§3.3) and ranking against the JAX reference.

Inputs are made from a numpy seed and handed to both packages.  The λ
grid is computed on the host from λ_max, so it agrees to float32 rounding
of one reduction (rtol 1e-6).  The betas come out of a warm-started FISTA
path whose every step rounds differently in the two frameworks; each λ
stops at tol 1e-7 on the step size, so the paths agree to ~1e-5 absolute
on standardized coefficients of order 1 (atol 1e-4 leaves a margin).
The ranking, which only orders importances, must agree exactly.
"""

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import lasso as rlasso
from repro.core import ranking as rranking
from repro.core.costmodel import SINGLE_POD as REF_SINGLE_POD
from repro.core.evaluators import AnalyticEvaluator as RefEvaluator
from repro.core.knobs import clean_space as ref_clean_space
from repro.models.config import SHAPES_BY_NAME as REF_SHAPES
from repro_torch.core import lasso as plasso
from repro_torch.core import ranking as pranking

BETA_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sparse_problem(n=200, d=30, noise=0.05, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    beta = np.zeros(d)
    beta[:4] = [3.0, -2.0, 1.5, 1.0]
    return x, x @ beta + rng.normal(0, noise, n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_path_matches_reference(seed):
    x, y = _sparse_problem(seed=seed)
    lams, betas = plasso.lasso_path(x, y, n_lambdas=30, device="cpu")
    rlams, rbetas = rlasso.lasso_path(x, y, n_lambdas=30)
    np.testing.assert_allclose(lams, rlams, rtol=1e-6)
    np.testing.assert_allclose(betas, rbetas, atol=BETA_ATOL)
    imp = plasso.path_importance(lams, betas)
    rimp = rlasso.path_importance(rlams, rbetas)
    assert list(np.argsort(-imp)[:4]) == list(np.argsort(-rimp)[:4])


def test_standardize_and_lambda_max_match():
    x, y = _sparse_problem(n=60, d=10, seed=4)
    std = plasso.standardize(x, y, device="cpu")
    rstd = rlasso.standardize(x, y)
    for a, b in zip(std, rstd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    assert plasso.lambda_max(std) == pytest.approx(rlasso.lambda_max(rstd),
                                                   rel=1e-6)


def test_lasso_fit_and_ridge_match():
    x, y = _sparse_problem(n=80, d=12, seed=5)
    np.testing.assert_allclose(plasso.lasso_fit(x, y, 0.05, device="cpu"),
                               rlasso.lasso_fit(x, y, 0.05), atol=BETA_ATOL)
    np.testing.assert_allclose(plasso.ridge_fit(x, y, 0.1, device="cpu"),
                               rlasso.ridge_fit(x, y, 0.1), atol=1e-5)


def test_fig6_ranking_matches_reference():
    """The ``benchmarks/fig6_ranking.py`` inputs at a reduced budget:
    LHS samples of the canonical cell scored by the reference's noisy
    test cluster, ranked by both packages."""
    cfg, cell = ref_get_config("yi-6b"), REF_SHAPES["train_4k"]
    space, _, _ = ref_clean_space(cfg, cell, REF_SINGLE_POD)
    ev = RefEvaluator(cfg, cell, REF_SINGLE_POD, noise_sigma=0.025, seed=0)
    rk = rranking.rank(space, ev, n_samples=100, seed=0)
    prk = pranking.rank(space, None, samples=rk.samples, values=rk.values,
                        device="cpu")
    assert (prk.fmap.columns, prk.fmap.owner) == (rk.fmap.columns,
                                                 rk.fmap.owner)
    assert prk.top(16) == rk.top(16)
    np.testing.assert_allclose(prk.importance, rk.importance, rtol=1e-3,
                               atol=1e-6)

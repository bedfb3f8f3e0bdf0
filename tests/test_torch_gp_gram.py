"""The port's Matérn-5/2 Gram wrappers against the JAX reference.

On CPU tensors the wrappers compute the plain-torch version; that path is
held against the reference's Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it) and the reference's jnp oracle at the
reference's own tolerance, atol 2e-4.  The plain backward
(``ref.matern52_gram_bwd``, the CUDA backward kernel's formula) is held
against ``jax.grad`` of the reference's jnp Matérn at relative L2 1e-4.
The CUDA kernels themselves are held against the plain versions on the
card by ``test_torch_gp_gram_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gp as rgp
from repro.kernels.gp_gram.ops import matern52_cross, matern52_gram
from repro.kernels.gp_gram.ref import matern52_cross_ref, matern52_gram_ref
from repro_torch.kernels.gp_gram import ops
from repro_torch.kernels.gp_gram import ref as tref

ATOL = 2e-4            # the reference's gp_gram tolerance (f32 Gram)
# the plain backward against jax.grad of the reference's Matérn, both in
# float32: the reference differentiates the expanded |a|²+|b|²−2a·b form,
# the plain version takes direct differences; at these cases they read
# 8.7e-5 apart at worst (n 300, d 24), so they are held to 1e-4
GRAD_REL = 1e-4

GRAM_CASES = [(40, 17, 5), (130, 200, 16), (8, 8, 2), (300, 1, 24),
              (128, 128, 8), (136, 77, 9)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(n, m, d, seed):
    rng = np.random.default_rng(seed)
    xa = rng.random((n, d), dtype=np.float32)
    xb = rng.random((m, d), dtype=np.float32)
    ls = rng.uniform(0.1, 1.0, d).astype(np.float32)
    return xa, xb, ls


@pytest.mark.parametrize("case", GRAM_CASES,
                         ids=lambda c: f"n{c[0]}m{c[1]}d{c[2]}")
def test_cpu_path_matches_reference(case):
    n, m, d = case
    xa, xb, ls = _inputs(n, m, d, seed=n + m)
    ta, tb, tl = (torch.from_numpy(a) for a in (xa, xb, ls))
    gram = ops.matern52_gram(ta, tl, 1.7).numpy()
    cross = ops.matern52_cross(ta, tb, tl, torch.tensor(0.9)).numpy()
    np.testing.assert_allclose(gram, np.asarray(matern52_gram(xa, ls, 1.7)),
                               atol=ATOL)
    np.testing.assert_allclose(gram, np.asarray(matern52_gram_ref(xa, ls,
                                                                  1.7)),
                               atol=ATOL)
    np.testing.assert_allclose(
        cross, np.asarray(matern52_cross(xa, xb, ls, 0.9)), atol=ATOL)
    np.testing.assert_allclose(
        cross, np.asarray(matern52_cross_ref(xa, xb, ls, 0.9)), atol=ATOL)
    np.testing.assert_allclose(
        cross, tref.matern52_cross_ref(ta, tb, tl, 0.9).numpy(), atol=0)


def test_gram_psd():
    """Property: Gram + jitter is positive definite (Cholesky succeeds)."""
    x = torch.from_numpy(np.random.default_rng(5).random((64, 6),
                                                         dtype=np.float32))
    g = ops.matern52_gram(x, torch.full((6,), 0.3), 1.0)
    chol = np.linalg.cholesky(g.numpy().astype(np.float64)
                              + 1e-5 * np.eye(64))
    assert np.all(np.isfinite(chol))
    assert np.allclose(g.numpy(), g.numpy().T, atol=1e-6)
    np.testing.assert_allclose(np.diag(g.numpy()), 1.0, atol=ATOL)


def test_cpu_path_launches_nothing():
    ops.reset_launch_counts()
    x = torch.rand((9, 3))
    ops.matern52_gram(x, torch.ones(3), 1.0)
    ops.matern52_cross(x, x, torch.ones(3), 1.0)
    assert (ops.gram_launches, ops.cross_launches) == (0, 0)


def _grad_inputs(n, d, seed, rows):
    """x [n, d] (with ``rows="pads_and_duplicates"``: a quarter of its rows
    again and 8 rows of 0.5, as ``gp._prepare`` pads), log lengthscale,
    log signal variance, and a seeded upstream gradient g, not symmetric."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, d), dtype=np.float32)
    if rows == "pads_and_duplicates":
        x = np.vstack([x, x[:max(1, n // 4)], np.full((8, d), 0.5,
                                                      np.float32)])
    log_ls = np.log(rng.uniform(0.1, 1.0, d)).astype(np.float32)
    log_sv = np.float32(np.log(1.7))
    g = rng.normal(size=(len(x), len(x))).astype(np.float32)
    return x, log_ls, log_sv, g


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("rows", ["random", "pads_and_duplicates"])
@pytest.mark.parametrize("case", GRAM_CASES,
                         ids=lambda c: f"n{c[0]}d{c[2]}")
def test_plain_backward_matches_jax_grad(case, rows):
    """``ref.matern52_gram_bwd`` against ``jax.grad`` of
    ``repro.core.gp.matern52(x, x, exp(log ls), exp(log sv))`` contracted
    with g, in the log-parameters."""
    n, _, d = case
    x, log_ls, log_sv, g = _grad_inputs(n, d, n + d, rows)

    def contracted(a, b):
        return jnp.sum(g * rgp.matern52(x, x, jnp.exp(a), jnp.exp(b)))

    want_ls, want_sv = jax.grad(contracted, argnums=(0, 1))(
        jnp.asarray(log_ls), jnp.asarray(log_sv))
    ls = torch.exp(torch.from_numpy(log_ls))
    sv = torch.exp(torch.tensor(log_sv))
    dls, dsv = tref.matern52_gram_bwd(torch.from_numpy(x), ls, sv,
                                      torch.from_numpy(g))
    assert _rel((dls * ls).numpy(), want_ls) <= GRAD_REL
    assert _rel(float(dsv * sv), float(want_sv)) <= GRAD_REL


@pytest.mark.parametrize("case", GRAM_CASES[:3],
                         ids=lambda c: f"n{c[0]}d{c[2]}")
def test_plain_backward_matches_autograd_of_plain_gram(case):
    """The formula against torch's autograd through ``ref.matern52``."""
    n, _, d = case
    x, log_ls, log_sv, g = (torch.from_numpy(np.asarray(a)) for a in
                            _grad_inputs(n, d, 7 * n, "pads_and_duplicates"))
    ls = torch.exp(log_ls).requires_grad_(True)
    sv = torch.exp(log_sv).requires_grad_(True)
    want = torch.autograd.grad(torch.sum(g * tref.matern52(x, x, ls, sv)),
                               [ls, sv])
    got = tref.matern52_gram_bwd(x, ls.detach(), sv.detach(), g)
    for a, b in zip(got, want):
        assert _rel(a.numpy(), b.numpy()) <= GRAD_REL


def test_cpu_gram_differentiates_through_the_plain_version():
    """On CPU tensors ``ops.matern52_gram`` is the plain version with
    ordinary autograd, bit for bit, and launches nothing."""
    ops.reset_launch_counts()
    x, log_ls, log_sv, g = (torch.from_numpy(np.asarray(a)) for a in
                            _grad_inputs(40, 5, 3, "pads_and_duplicates"))
    grads = []
    for gram in (ops.matern52_gram, tref.matern52_gram_ref):
        ls = torch.exp(log_ls).requires_grad_(True)
        sv = torch.exp(log_sv).requires_grad_(True)
        k = gram(x, ls, sv)
        grads.append(torch.autograd.grad(torch.sum(g * k), [ls, sv]))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    assert (ops.gram_launches, ops.cross_launches,
            ops.gram_bwd_launches) == (0, 0, 0)


def test_cpu_backward_wrapper_is_the_plain_version():
    ops.reset_launch_counts()
    x, log_ls, log_sv, g = (torch.from_numpy(np.asarray(a)) for a in
                            _grad_inputs(24, 3, 4, "random"))
    ls, sv = torch.exp(log_ls), torch.exp(log_sv)
    got = ops.matern52_gram_bwd(x, ls, sv, g)
    want = tref.matern52_gram_bwd(x, ls, sv, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.gram_bwd_launches == 0
    with pytest.raises(ValueError):          # g must be [n, n]
        ops.matern52_gram_bwd(x, ls, sv, g[:, :5].contiguous())


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "width", "rank",
                                 "signal_var"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.rand((8, 4))
    ls = torch.ones(4)
    sv = 1.0
    if bad == "dtype":
        x = x.double()
    elif bad == "contiguity":
        x = torch.rand((4, 8)).T
    elif bad == "width":
        ls = torch.ones(3)
    elif bad == "rank":
        x = torch.rand(8)
    else:
        sv = torch.ones(2)
    with pytest.raises((TypeError, ValueError)):
        ops.matern52_cross(x, torch.rand((5, 4)) if bad != "width" else x,
                           ls, sv)


# ops.bwd_grid(n, d): (blocks, partial rows) of the backward's launch.  Up
# to 64 features (and beyond the wide kernel's 512) one block per 64 rows
# of i, whose partials a second launch adds when there are two or more;
# from 65 to 512 features the wide kernel: 16 x 16 pair tiles shared out
# over clusters of 16 blocks, at most 16 clusters, whose partials a second
# launch adds when there are two or more
BWD_GRID = {
    **{(n, d): grid for d in (16, 64) for n, grid in (
        (1, (1, 0)), (8, (1, 0)), (56, (1, 0)), (64, (1, 0)),
        (65, (2, 2)), (128, (2, 2)), (300, (5, 5)))},
    **{(n, d): grid for d in (65, 327, 332) for n, grid in (
        (1, (16, 0)), (8, (16, 0)), (56, (16, 0)), (64, (16, 0)),
        (65, (32, 2)), (128, (64, 4)), (300, (256, 16)))},
}


@pytest.mark.parametrize("n, d", sorted(BWD_GRID), ids=lambda v: str(v))
def test_backward_grid_and_scratch(n, d):
    assert ops.bwd_grid(n, d) == BWD_GRID[n, d]


def test_backward_grid_beyond_the_wide_kernel_and_empty():
    assert ops.bwd_grid(64, 512) == (16, 0)
    assert ops.bwd_grid(64, 513) == (1, 0)
    assert ops.bwd_grid(130, 600) == (3, 3)
    assert ops.bwd_grid(0, 327) == (0, 0)


def test_backward_grid_mirrors_the_cuda_source():
    """The launcher's constants in ``gp_gram.cu`` are the ones
    :func:`ops.bwd_grid` sizes the scratch by."""
    import re
    src = ops.SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("kBwdRows") == ops._BWD_ROWS
    assert const("kExpandedMaxD") == tref.EXPANDED_MAX_D
    assert const("kWideMaxD") == ops._WIDE_MAX_D
    assert (const("kWideRows"), const("kWideCols")) == ops._WIDE_TILE
    assert const("kWideCluster") == ops._WIDE_CLUSTER
    assert const("kWideMaxClusters") == ops._WIDE_MAX_CLUSTERS

"""The port's Matérn-5/2 Gram wrappers against the JAX reference.

On CPU tensors the wrappers compute the plain-torch version; that path is
held against the reference's Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it) and the reference's jnp oracle at the
reference's own tolerance, atol 2e-4.  The CUDA kernel itself is held
against the plain version on the card by ``test_torch_gp_gram_cuda.py``
and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro.kernels.gp_gram.ops import matern52_cross, matern52_gram
from repro.kernels.gp_gram.ref import matern52_cross_ref, matern52_gram_ref
from repro_torch.kernels.gp_gram import ops
from repro_torch.kernels.gp_gram import ref as tref

ATOL = 2e-4            # the reference's gp_gram tolerance (f32 Gram)

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

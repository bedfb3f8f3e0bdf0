"""The hand-written CUDA Matérn-5/2 kernel against its plain-torch
version, on the card.  Needs an NVIDIA GPU (``cuda`` marker); skips
without one.  Imports nothing of JAX, so it runs on a machine that has
only the port's dependencies:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_gp_gram_cuda.py

Tolerance atol 2e-4, the reference's gp_gram tolerance (f32 Gram), also
against the float64 formula where r is near 0: a config's one-knob
neighbours (the candidates' axis sweeps) at the tuning daemon's 327-332
knobs, where the expanded |a|² + |b|² − 2a·b of the reference cancels
(beyond 64 features the kernels and the plain version sum direct
differences).  The
backward kernel's (dL/dlengthscale, dL/dsignal_var) is held to relative
L2 1e-3 of its plain version and of that formula in float64 at every
case, and of autograd through the plain Matérn at the cases with n = m,
as ``chip_smoke.py`` holds it, and must give the same bits twice.
Autograd differentiates the expanded |a|²+|b|²−2a·b: with repeated rows
its gradient of a zero distance is rounding noise, which read 1.2e-2
against the kernel at n = 300, d = 40 (NVIDIA H100 80GB HBM3), where the
kernel holds 1e-3 of the float64 formula, so it is no yardstick at the
wide cases.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.gp_gram import ops
from repro_torch.kernels.gp_gram import ref as tref

ATOL = 2e-4
GRAD_REL = 1e-3

# the reference's GRAM_CASES, its off-ladder case, one knob, the main
# path's shapes, a d that spans two staged chunks of the kernel, and the
# tuning daemon's: whole cleaned spaces of 327-332 knobs (56 observations
# padded to 64; 2048 LHS + 256 local + 5·d sweep candidates, and 2304 of
# them without the sweeps) and a multi-task corpus of two 64-row tasks
CASES = [(40, 17, 5), (130, 200, 16), (8, 8, 2), (300, 1, 24),
         (128, 128, 8), (136, 77, 9), (50, 30, 1), (64, 64, 16),
         (2384, 64, 16), (300, 200, 40), (64, 64, 327), (64, 64, 332),
         (3939, 64, 327), (2304, 64, 332), (128, 128, 327)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(n, m, d, seed, device):
    rng = np.random.default_rng(seed)
    xa = rng.random((n, d), dtype=np.float32)
    xb = rng.random((m, d), dtype=np.float32)
    ls = rng.uniform(0.1, 1.0, d).astype(np.float32)
    return (torch.from_numpy(a).to(device) for a in (xa, xb, ls))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: f"n{c[0]}m{c[1]}d{c[2]}")
def test_kernel_matches_plain(case, cuda):
    n, m, d = case
    xa, xb, ls = _inputs(n, m, d, n * m, cuda)
    sv = torch.tensor(1.3, device=cuda)
    before = (ops.gram_launches, ops.cross_launches)
    got = ops.matern52_cross(xa, xb, ls, sv)
    want = tref.matern52_cross_ref(xa, xb, ls, sv)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    got = ops.matern52_gram(xa, ls, 1.3)
    torch.testing.assert_close(got, tref.matern52_gram_ref(xa, ls, sv),
                               atol=ATOL, rtol=0)
    assert (ops.gram_launches, ops.cross_launches) == (before[0] + 1,
                                                       before[1] + 1)


def _one_knob_neighbours(d, seed, device):
    """64 training rows whose first is the incumbent, and the candidates'
    axis sweeps: the incumbent with one knob set to 0, 0.25, ..., 1 (5·d
    rows), at lengthscale 0.3 (the fit's init): near r = 0, where the
    expanded |a|² + |b|² − 2a·b cancels."""
    rng = np.random.default_rng(seed)
    x = rng.random((64, d), dtype=np.float32)
    sweeps = np.repeat(x[:1], 5 * d, axis=0)
    for j in range(d):
        sweeps[5 * j:5 * j + 5, j] = np.linspace(0, 1, 5, dtype=np.float32)
    return (torch.from_numpy(x).to(device), torch.from_numpy(sweeps).to(device),
            torch.full((d,), 0.3, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 327, 332])
def test_one_knob_neighbours_match_plain_and_float64(d, cuda):
    x, sweeps, ls = _one_knob_neighbours(d, d, cuda)
    sv = torch.tensor(1.3, device=cuda)
    got = ops.matern52_cross(sweeps, x, ls, sv)
    exact = tref.matern52_cross_ref(sweeps.double(), x.double(), ls.double(),
                                    sv.double())
    torch.testing.assert_close(got, tref.matern52_cross_ref(sweeps, x, ls, sv),
                               atol=ATOL, rtol=0)
    torch.testing.assert_close(got.double(), exact, atol=ATOL, rtol=0)
    # the Gram of the incumbent and 63 of its neighbours, and its backward
    near = torch.cat([x[:1], sweeps[1:64]]).contiguous()
    torch.testing.assert_close(
        ops.matern52_gram(near, ls, sv).double(),
        tref.matern52_gram_ref(*(t.double() for t in (near, ls, sv))),
        atol=ATOL, rtol=0)
    g = torch.randn((64, 64), generator=torch.Generator().manual_seed(d))
    g = g.to(cuda)
    dls, dsv = ops.matern52_gram_bwd(near, ls, sv, g)
    for w in (tref.matern52_gram_bwd(near, ls, sv, g),
              tref.matern52_gram_bwd(*(t.double() for t in (near, ls, sv,
                                                            g)))):
        assert _rel(dls, w[0]) <= GRAD_REL
        assert _rel(dsv, w[1]) <= GRAD_REL


@pytest.mark.cuda
def test_wrapper_raises_instead_of_falling_back(cuda):
    x = torch.rand((8, 4), device=cuda)
    with pytest.raises(ValueError):          # mixed devices
        ops.matern52_gram(x, torch.ones(4), 1.0)
    with pytest.raises(TypeError):           # the kernel takes float32 only
        ops.matern52_gram(x.double(), torch.ones(4, device=cuda,
                                                 dtype=torch.float64), 1.0)


def _rel(a, b) -> float:
    return float((a - b).double().norm() / b.double().norm())


def _grad_inputs(n, d, seed, device):
    """x [n, d] with its last rows repeated and 8 rows of 0.5 (as the fit
    pads), lengthscale, a 0-dim signal variance and g [n, n], not
    symmetric."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, d), dtype=np.float32)
    x[-min(8, n // 2):] = 0.5
    x[:n // 8] = x[n // 8:2 * (n // 8)]
    ls = rng.uniform(0.1, 1.0, d).astype(np.float32)
    g = rng.normal(size=(n, n)).astype(np.float32)
    return (torch.from_numpy(x).to(device), torch.from_numpy(ls).to(device),
            torch.tensor(1.3, device=device), torch.from_numpy(g).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: f"n{c[0]}d{c[2]}")
def test_backward_kernel_matches_plain(case, cuda):
    n, _, d = case
    x, ls, sv, g = _grad_inputs(n, d, n + d, cuda)
    before = ops.gram_bwd_launches
    dls, dsv = ops.matern52_gram_bwd(x, ls, sv, g)
    wants = {"plain": tref.matern52_gram_bwd(x, ls, sv, g),
             "float64": tref.matern52_gram_bwd(
                 *(t.double() for t in (x, ls, sv, g)))}
    if case[0] == case[1]:
        ls_ = ls.clone().requires_grad_(True)
        sv_ = sv.clone().requires_grad_(True)
        wants["autograd"] = torch.autograd.grad(
            torch.sum(g * tref.matern52(x, x, ls_, sv_)), [ls_, sv_])
    torch.cuda.synchronize()
    assert ops.gram_bwd_launches == before + 1
    for name, w in wants.items():
        assert _rel(dls, w[0]) <= GRAD_REL, name
        assert _rel(dsv, w[1]) <= GRAD_REL, name


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(64, 16), (300, 40), (64, 327)],
                         ids=lambda c: f"n{c[0]}d{c[1]}")
def test_backward_kernel_is_deterministic(case, cuda):
    x, ls, sv, g = _grad_inputs(*case, 11, cuda)
    first = ops.matern52_gram_bwd(x, ls, sv, g)
    again = ops.matern52_gram_bwd(x, ls, sv, g)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_gram_autograd_runs_the_backward_kernel(cuda):
    """On CUDA tensors the Gram's gradient in (lengthscale, signal_var)
    is the backward kernel's; x gets none, and asking for one raises."""
    x, ls, sv, g = _grad_inputs(64, 16, 5, cuda)
    ls_ = ls.clone().requires_grad_(True)
    sv_ = sv.clone().requires_grad_(True)
    before = (ops.gram_launches, ops.gram_bwd_launches)
    k = ops.matern52_gram(x, ls_, sv_)
    got = torch.autograd.grad(torch.sum(g * k), [ls_, sv_])
    want = ops.matern52_gram_bwd(x, ls, sv, g)
    assert (ops.gram_launches, ops.gram_bwd_launches) == (before[0] + 1,
                                                          before[1] + 2)
    assert got[1].shape == sv.shape
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        ops.matern52_gram(x.clone().requires_grad_(True), ls_, sv_)

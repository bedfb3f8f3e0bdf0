"""The hand-written CUDA Matérn-5/2 kernel against its plain-torch
version, on the card.  Needs an NVIDIA GPU (``cuda`` marker); skips
without one.  Imports nothing of JAX, so it runs on a machine that has
only the port's dependencies:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_gp_gram_cuda.py

Tolerance atol 2e-4, the reference's gp_gram tolerance (f32 Gram).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.gp_gram import ops
from repro_torch.kernels.gp_gram import ref as tref

ATOL = 2e-4

# the reference's GRAM_CASES, its off-ladder case, one knob, the main
# path's shapes, and a d that spans two staged chunks of the kernel
CASES = [(40, 17, 5), (130, 200, 16), (8, 8, 2), (300, 1, 24),
         (128, 128, 8), (136, 77, 9), (50, 30, 1), (64, 64, 16),
         (2384, 64, 16), (300, 200, 40)]


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


@pytest.mark.cuda
def test_wrapper_raises_instead_of_falling_back(cuda):
    x = torch.rand((8, 4), device=cuda)
    with pytest.raises(ValueError):          # mixed devices
        ops.matern52_gram(x, torch.ones(4), 1.0)
    with pytest.raises(TypeError):           # the kernel takes float32 only
        ops.matern52_gram(x.double(), torch.ones(4, device=cuda,
                                                 dtype=torch.float64), 1.0)

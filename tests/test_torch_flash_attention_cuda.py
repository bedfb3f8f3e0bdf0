"""The hand-written CUDA flash-attention kernel against its plain-torch
version, on the card.  Needs an NVIDIA GPU (``cuda`` marker); skips
without one.  Imports nothing of JAX, so it runs on a machine that has
only the port's dependencies:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_flash_attention_cuda.py

Tolerances are the reference's flash tolerances
(``tests/test_kernels.py``): atol 2e-5 in float32, 2e-2 in bfloat16.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import reference_attention

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

# (B, Sq, Sk, H, Kh, D, causal, window, softcap): the reference's
# FLASH_CASES, then cases for the kernel's own edges: every compiled head
# dim, ragged tiles, Sq != Sk, a window without causal, and yi-6b's heads
# at a short prefill
CASES = [
    (2, 256, 256, 4, 2, 64, True, None, None),
    (1, 128, 384, 8, 8, 128, True, None, 30.0),
    (2, 200, 200, 4, 1, 64, True, 64, None),
    (1, 512, 512, 2, 2, 128, False, None, None),
    (1, 96, 96, 6, 6, 64, True, None, None),
    (2, 64, 64, 4, 4, 32, True, 16, 10.0),
    (1, 77, 77, 4, 2, 16, True, None, None),
    (1, 130, 70, 2, 1, 256, True, None, None),
    (1, 100, 300, 2, 2, 64, False, 8, None),
    (1, 70, 200, 2, 1, 32, False, None, 5.0),
    (1, 1000, 1000, 32, 4, 128, True, None, None),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(case, dtype, device, seed):
    B, Sq, Sk, H, Kh, D = case[:6]
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((B, Sq, H, D), dtype=np.float32),
            rng.standard_normal((B, Sk, Kh, D), dtype=np.float32),
            rng.standard_normal((B, Sk, Kh, D), dtype=np.float32))
    return [torch.from_numpy(a).to(device=device, dtype=dtype)
            for a in arrs]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "B{}S{}x{}H{}-{}D{}"
                         .format(*c[:6]))
def test_kernel_matches_plain(case, dtype, cuda):
    causal, window, softcap = case[6:]
    q, k, v = _qkv(case, dtype, cuda, seed=case[1] + case[3])
    before = ops.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap)
    want = reference_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)


@pytest.mark.cuda
def test_rows_with_nothing_visible_are_zero(cuda):
    """A window without causal leaves rows i >= Sk + window - 1 with no
    key; the kernel writes zeros there (as the TPU kernel does), and the
    visible rows match the plain version."""
    q, k, v = _qkv((1, 300, 100, 2, 2, 64), torch.float32, cuda, seed=3)
    got = ops.flash_attention(q, k, v, causal=False, window=8)
    want = reference_attention(q, k, v, causal=False, window=8)
    torch.cuda.synchronize()
    assert bool((got[:, 107:] == 0).all())
    torch.testing.assert_close(got[:, :107], want[:, :107], atol=2e-5,
                               rtol=0)


@pytest.mark.cuda
def test_strided_inputs_read_in_place(cuda):
    """A view with non-default strides (heads sliced out of a wider
    tensor) gives the same result as its contiguous copy."""
    wide = torch.randn((1, 200, 8, 64), device=cuda)
    q = wide[:, :, :4]
    k, v = wide[:, :, 4:6], wide[:, :, 6:8]
    got = ops.flash_attention(q, k, v)
    want = ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous())
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.cuda
def test_block_size_knobs_do_not_change_the_output(cuda):
    q, k, v = _qkv((1, 256, 256, 4, 2, 64), torch.float32, cuda, seed=7)
    outs = [ops.flash_attention(q, k, v, block_q=bq, block_k=bk)
            for bq, bk in [(64, 64), (128, 256), (256, 128)]]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], atol=0, rtol=0)


@pytest.mark.cuda
def test_wrapper_raises_instead_of_falling_back(cuda):
    q = torch.randn((1, 8, 4, 64), device=cuda)
    with pytest.raises(ValueError):          # mixed devices
        ops.flash_attention(q, q.cpu(), q.cpu())
    with pytest.raises(TypeError):           # float16 is not compiled
        h = q.half()
        ops.flash_attention(h, h, h)
    with pytest.raises(ValueError):          # head_dim 48 is not compiled
        x = torch.randn((1, 8, 4, 48), device=cuda)
        ops.flash_attention(x, x, x)

"""The hand-written CUDA flash-attention backward against its plain
version, on the card.  Needs an NVIDIA GPU (``cuda`` marker); skips
without one.  Imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_flash_backward_cuda.py

A CUDA call that asks for a gradient goes through the ``autograd.
Function`` (the forward kernel writes each row's log-sum-exp; the
backward kernel's three launches give dq, dk, dv).  The plain version is
``ref.attention_grads`` (autograd of the plain forward with P in
float32).  Limits: relative L2 of each of dq, dk, dv 1e-2 in bf16, 1e-5
in float32; two calls bit-equal.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops

REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# (B, Sq, Sk, H, Kh, D, causal, window, softcap, dtype): the reference's
# FLASH_CASES on both routes, GQA 8/1, window, soft-cap, Sq != Sk both
# ways, ragged tiles, every head dim of the FMA route, whisper's shapes
CASES = [
    (2, 256, 256, 4, 2, 64, True, None, None, torch.bfloat16),
    (1, 128, 384, 8, 8, 128, True, None, 30.0, torch.bfloat16),
    (2, 200, 200, 4, 1, 64, True, 64, None, torch.bfloat16),
    (1, 512, 512, 2, 2, 128, False, None, None, torch.bfloat16),
    (1, 200, 200, 8, 1, 128, True, None, None, torch.bfloat16),
    (1, 100, 333, 4, 2, 64, False, None, None, torch.bfloat16),
    (1, 333, 129, 8, 1, 128, True, None, None, torch.bfloat16),
    (2, 1500, 1500, 6, 6, 64, False, None, None, torch.bfloat16),
    (2, 448, 1500, 6, 6, 64, False, None, None, torch.bfloat16),
    (1, 77, 77, 4, 2, 16, True, None, None, torch.float32),
    (2, 64, 64, 4, 4, 32, True, 16, 10.0, torch.float32),
    (1, 130, 190, 4, 2, 64, False, None, 30.0, torch.float32),
    (1, 130, 130, 4, 2, 128, True, 40, None, torch.float32),
    (1, 70, 70, 2, 1, 256, True, None, None, torch.float32),
    (1, 96, 96, 6, 6, 32, True, None, None, torch.bfloat16),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(case, device, seed=0):
    B, Sq, Sk, H, Kh, D = case[:6]
    dtype = case[9]
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            .to(device=device, dtype=dtype)
            for s in ((B, Sq, H, D), (B, Sk, Kh, D), (B, Sk, Kh, D),
                      (B, Sq, H, D))]


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def _grads(q, k, v, do, **kw):
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    out = ops.flash_attention(qs, ks, vs, **kw)
    assert out.grad_fn is not None
    return torch.autograd.grad(out, (qs, ks, vs), do)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=lambda c: "B{}S{}x{}H{}-{}D{}"
                         .format(*c[:6]) + str(c[9]).split(".")[-1])
def test_backward_kernel_matches_plain(case, cuda):
    causal, window, softcap, dtype = case[6:]
    q, k, v, do = _inputs(case, cuda)
    kw = dict(causal=causal, window=window, softcap=softcap)
    n, n_bwd = ops.launches, ops.launches_bwd
    got = _grads(q, k, v, do, **kw)
    torch.cuda.synchronize()
    assert (ops.launches, ops.launches_bwd) == (n + 1, n_bwd + 1)
    want = ref.attention_grads(q, k, v, do, **kw)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        assert _rel(g, w) <= REL[dtype]
    again = _grads(q, k, v, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_with_nothing_visible_get_zero_gradient(dtype, cuda):
    """A window without causal leaves rows i >= Sk + window - 1 with no
    key: zero output and zero dq there; the visible rows' gradients match
    the plain version's on the visible rows alone."""
    case = (1, 300, 100, 2, 2, 64, False, 8, None, dtype)
    q, k, v, do = _inputs(case, cuda, seed=3)
    dq, dk, dv = _grads(q, k, v, do, causal=False, window=8)
    assert bool((dq[:, 107:] == 0).all())
    wq, wk, wv = ref.attention_grads(q[:, :107], k, v, do[:, :107],
                                     causal=False, window=8)
    assert _rel(dq[:, :107], wq) <= REL[dtype]
    assert _rel(dk, wk) <= REL[dtype] and _rel(dv, wv) <= REL[dtype]


@pytest.mark.cuda
def test_no_grad_calls_launch_the_forward_alone(cuda):
    case = (1, 128, 128, 4, 2, 64, True, None, None, torch.bfloat16)
    q, k, v, _ = _inputs(case, cuda)
    n_bwd = ops.launches_bwd
    out = ops.flash_attention(q.requires_grad_(), k, v)
    assert out.grad_fn is not None
    with torch.no_grad():
        out = ops.flash_attention(q, k, v)
    assert out.grad_fn is None and ops.launches_bwd == n_bwd


@pytest.mark.cuda
def test_gradient_path_on_the_fma_route_takes_the_default_tile(cuda):
    """Only the FMA route's default tile is compiled with the log-sum-exp
    store: a tile knob on a call that asks for a gradient raises."""
    case = (1, 128, 128, 4, 2, 64, True, None, None, torch.float32)
    q, k, v, _ = _inputs(case, cuda)
    with pytest.raises(ValueError, match="default tile"):
        ops.flash_attention(q.requires_grad_(), k, v, block_q=32,
                            block_k=32, num_warps=4)
    with torch.no_grad():
        ops.flash_attention(q, k, v, block_q=32, block_k=32, num_warps=4)


@pytest.mark.cuda
def test_mlstm_refuses_a_gradient_on_the_card(cuda):
    shape = (1, 64, 2, 32)
    q = torch.randn(shape, device=cuda, requires_grad=True)
    k = torch.randn(shape, device=cuda)
    g = torch.randn(shape[:3], device=cuda)
    with pytest.raises(ValueError, match="15b"):
        mlstm_ops.mlstm_chunk(q, k, k, g, -g.abs(), chunk=64)
    with torch.no_grad():
        mlstm_ops.mlstm_chunk(q, k, k, g, -g.abs(), chunk=64)

"""The flash-attention backward on the CPU: on CPU tensors
``flash_attention`` computes its plain version and ordinary autograd
differentiates it; its gradients agree with ``jax.grad`` of the
reference's off-TPU flash path (``repro.models.attention.
chunked_attention``) at the reference's ``FLASH_CASES``
(``tests/test_kernels.py``), in float32, within relative L2 1e-5.
``ref.attention_grads`` (the backward kernel's plain version on the card)
is the same gradient.  The CUDA kernels are held against these on the
card (``tests/test_torch_flash_backward_cuda.py``, ``chip_smoke.py``).

The mLSTM kernel has no backward yet: off the CPU, a call with grad
enabled and an input that requires grad raises (checked on the ``meta``
device, which reaches the same branch as a CUDA tensor)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import chunked_attention
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops

FLASH_CASES = [
    # (B, Sq, Sk, H, Kh, D, causal, window, softcap, bk)
    (2, 256, 256, 4, 2, 64, True, None, None, 128),
    (1, 128, 384, 8, 8, 128, True, None, 30.0, 128),
    (2, 200, 200, 4, 1, 64, True, 64, None, 128),
    (1, 512, 512, 2, 2, 128, False, None, None, 128),
    (1, 96, 96, 6, 6, 64, True, None, None, 128),
    (2, 64, 64, 4, 4, 32, True, 16, 10.0, 64),
]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _inputs(case, seed=0):
    B, Sq, Sk, H, Kh, D = case[:6]
    rng = np.random.default_rng(seed + Sq + H)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, Kh, D), (B, Sk, Kh, D),
                      (B, Sq, H, D))]


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: f"B{c[0]}S{c[1]}x{c[2]}H{c[3]}-{c[4]}"
                                       f"D{c[5]}")
def test_plain_gradients_match_reference(case):
    B, Sq, Sk, H, Kh, D, causal, window, softcap, bk = case
    q, k, v, do = _inputs(case)

    def f(q, k, v):
        o = chunked_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap, chunk=bk)
        return jnp.sum(o * do)
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                              softcap=softcap)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    plain = ref.attention_grads(tq, tk, tv, torch.from_numpy(do),
                                causal=causal, window=window,
                                softcap=softcap)
    for g, p, w in zip(got, plain, want):
        assert _rel(g.numpy(), w) <= 1e-5
        assert torch.equal(g, p)


def test_bf16_plain_version_is_the_straight_through_gradient():
    """On the bf16 wgmma route the plain version rounds P to bf16 before
    P.V; autograd passes straight through that rounding, so its gradient
    is within bf16 rounding of the float32-P gradient the backward kernel
    computes (``ref.attention_grads``)."""
    case = FLASH_CASES[0]
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(case))
    assert ops.route(q.dtype, q.shape[3]) == "wgmma"
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    out = ops.flash_attention(qs, ks, vs, causal=True)
    got = torch.autograd.grad(out, (qs, ks, vs), do)
    want = ref.attention_grads(q, k, v, do, causal=True)
    for g, w in zip(got, want):
        assert _rel(g.float().numpy(), w.numpy()) <= 1e-2


def test_backward_counter_is_reset():
    ops.launches_bwd = 3
    ops.reset_launch_counts()
    assert ops.launches_bwd == ops.launches == 0


def test_mlstm_refuses_a_gradient_off_the_cpu():
    shape = (1, 64, 2, 32)
    q = torch.empty(shape, device="meta", requires_grad=True)
    k = torch.empty(shape, device="meta")
    gates = torch.empty(shape[:3], device="meta")
    with pytest.raises(ValueError, match="15b"):
        mlstm_ops.mlstm_chunk(q, k, k, gates, gates, chunk=64)
    with torch.no_grad():                 # no gradient asked: not refused
        with pytest.raises(ValueError, match="cpu or cuda"):
            mlstm_ops.mlstm_chunk(q, k, k, gates, gates, chunk=64)
    # on CPU tensors autograd differentiates the plain version
    rng = np.random.default_rng(0)
    t = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.3)
         .requires_grad_() for s in (shape, shape, shape, shape[:3],
                                     shape[:3])]
    t[4] = -torch.nn.functional.softplus(t[4])
    h = mlstm_ops.mlstm_chunk(*t, chunk=16)
    g = torch.autograd.grad(h.sum(), t[0])[0]
    assert torch.isfinite(g).all() and g.abs().sum() > 0

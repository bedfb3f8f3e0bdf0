"""The flash-attention backward on the CPU: on CPU tensors
``flash_attention`` computes its plain version and ordinary autograd
differentiates it; its gradients agree with ``jax.grad`` of the
reference's off-TPU flash path (``repro.models.attention.
chunked_attention``) at the reference's ``FLASH_CASES``
(``tests/test_kernels.py``), in float32, within relative L2 1e-5.
``ref.attention_grads`` (the FMA backward kernel's plain version on the
card) is the same gradient.  ``attention_grads(operand_dtype=bfloat16)``,
the tensor-core backward's plain version, rounds P and dS to bf16 where
they enter the products and nowhere else (held against a product built
by hand from autograd's P and dS that rounds only there), and stays
within relative L2 1e-2 of ``jax.grad`` of ``chunked_attention`` at the
bf16 cases of ``FLASH_CASES``.  The CUDA kernels are held against these
on the card (``tests/test_torch_flash_backward_cuda.py``,
``chip_smoke.py``).

The mLSTM wrapper off the CPU and off CUDA raises with or without a
gradient asked (checked on the ``meta`` device); on CPU tensors autograd
differentiates its plain version.  Its backward kernel is held on the
card by ``tests/test_torch_mlstm_backward_cuda.py``."""

import math

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
    """On CPU tensors the bf16 wgmma route's plain forward rounds P to
    bf16 before P.V and autograd passes straight through that rounding,
    so its gradient is within bf16 rounding of the float32-P gradient
    (``ref.attention_grads``).  The card's bf16 backward instead rounds P
    and dS where they enter its products
    (``attention_grads(operand_dtype=bfloat16)``, tested below)."""
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


def _hand_rounded(q, k, v, do, causal, window, softcap, dtype):
    """The gradient built from autograd's P and dS (the gradient at the
    pre-cap scores) with only those two rounded to ``dtype`` before the
    three products that take them."""
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    rep = H // Kh
    kr, vr = (t.float().repeat_interleave(rep, 2) for t in (k, v))
    x = (torch.einsum("bqhd,bkhd->bhqk", q.float(), kr)
         / math.sqrt(D)).requires_grad_()
    s = softcap * torch.tanh(x / softcap) if softcap else x
    mask = ref.visible_mask(Sq, Sk, causal, window)
    p = torch.softmax(torch.where(mask, s, ref.NEG_INF), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vr)
    ds, = torch.autograd.grad(o, x, do.float())
    p, ds = p.detach().to(dtype).float(), ds.to(dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) / math.sqrt(D)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) / math.sqrt(D)
    return (dq, dk.reshape(B, Sk, Kh, rep, D).sum(3),
            dv.reshape(B, Sk, Kh, rep, D).sum(3))


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: f"B{c[0]}S{c[1]}x{c[2]}H{c[3]}-{c[4]}"
                                       f"D{c[5]}")
def test_rounded_grads_round_at_the_kernel_places(case):
    """The plain version of the tensor-core backward rounds at exactly P
    (before P^T dO) and dS (before dS^T q, dS k): within 2e-4 of the hand
    product that rounds only there (two float32 roads to P and dS may
    round an element apart), and at least 5e-4 from the unrounded
    gradient, which it departs from by ~1.7e-3 (bf16's spacing)."""
    causal, window, softcap = case[6:9]
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(case))
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ref.attention_grads(q, k, v, do, operand_dtype=torch.bfloat16,
                              **kw)
    hand = _hand_rounded(q, k, v, do, causal, window, softcap,
                         torch.bfloat16)
    exact = ref.attention_grads(q, k, v, do, **kw)
    for g, h, e in zip(got, hand, exact):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), h.numpy()) <= 2e-4
        assert _rel(g.numpy(), e.numpy()) >= 5e-4


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: f"B{c[0]}S{c[1]}x{c[2]}H{c[3]}-{c[4]}"
                                       f"D{c[5]}")
def test_rounded_grads_match_reference_in_bf16(case):
    """At the bf16 cases (inputs and cotangent in bf16) the rounded plain
    version is within relative L2 1e-2 of ``jax.grad`` of the reference's
    ``chunked_attention``."""
    B, Sq, Sk, H, Kh, D, causal, window, softcap, bk = case
    q, k, v, do = (x.astype(jnp.bfloat16) for x in _inputs(case))

    def f(q, k, v):
        o = chunked_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap, chunk=bk)
        return jnp.sum(o.astype(jnp.float32) * do.astype(jnp.float32))
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
    t = [torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
         for x in (q, k, v, do)]
    got = ref.attention_grads(*t, causal=causal, window=window,
                              softcap=softcap, operand_dtype=torch.bfloat16)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), np.asarray(w, np.float32)) <= 1e-2


def test_rounded_grads_default_is_autograd():
    """``operand_dtype=None`` keeps the function as it was: autograd of the
    float32-P plain forward, bit for bit."""
    case = FLASH_CASES[1]
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(case))
    kw = dict(causal=True, softcap=30.0)
    qf, kf, vf = (t.clone().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(ref.reference_attention(qf, kf, vf, **kw),
                               (qf, kf, vf), do)
    got = ref.attention_grads(q, k, v, do, operand_dtype=None, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_backward_counter_is_reset():
    ops.launches_bwd = 3
    ops.launches_bwd_wgmma = 2
    ops.launches_bwd_fma = 1
    ops.reset_launch_counts()
    assert ops.launches_bwd == ops.launches == 0
    assert ops.launches_bwd_wgmma == ops.launches_bwd_fma == 0


def test_misaligned_cotangent_is_copied_for_tma():
    """The wgmma backward reads dO by TMA: a view with a stride off the
    16-byte rule, or broadcast (stride 0), is copied first
    (``ops._tma_readable`` decides; a pure function of the view)."""
    base = torch.zeros((1, 8, 2, 72), dtype=torch.bfloat16)
    assert ops._tma_readable(base[..., :64])         # 144-byte head stride
    assert not ops._tma_readable(base[..., 4:68])    # 8-byte offset
    odd = torch.zeros((1, 8, 2, 68), dtype=torch.bfloat16)
    assert not ops._tma_readable(odd[..., :64])      # 136-byte head stride
    assert not ops._tma_readable(base[:, :, :1].expand(1, 8, 2, 72))
    assert ops._tma_readable(base[:, :, :1])         # one head: no stride


def test_mlstm_refuses_a_gradient_off_the_cpu():
    shape = (1, 64, 2, 32)
    q = torch.empty(shape, device="meta", requires_grad=True)
    k = torch.empty(shape, device="meta")
    gates = torch.empty(shape[:3], device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        mlstm_ops.mlstm_chunk(q, k, k, gates, gates, chunk=64)
    with torch.no_grad():                 # no gradient asked
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

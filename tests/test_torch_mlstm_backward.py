"""The mLSTM backward's plain version on the CPU.

``ref.mlstm_chunkwise_grads`` (the plain version of the backward kernel
``csrc/mlstm_chunk_bwd.cu``: the stabilisers held constant, a forward
walk for the carries, a reverse walk for their gradient) against
``torch.autograd`` of ``ref.mlstm_chunkwise`` (relative L2 1e-10 in
float64, 1e-5 in float32), against ``jax.grad`` of the reference's
sequential oracle (``repro.kernels.mlstm_chunk.ref.mlstm_sequential``;
float32, relative L2 1e-4: a time-step recurrence against the chunkwise
form, each in float32), and with ``operand_dtype=bfloat16`` against
autograd of the rounded plain version with the stabilisers detached
(1e-5 on float32 inputs).  With the roundings, h is no longer exactly
invariant to the stabilisers (a rounded operand does not scale with
exp(-m)), so there the gradient is defined, as the kernel computes it,
with m held constant.  Without them, autograd with m detached equals
autograd with m live: the stabilisers take no gradient.  The inputs come
from numpy draws, with q scaled row by row so that rows fall on both
branches of the denominator max(|n . q|, exp(-m)); every case asserts
that both are hit.  The kernel is held on the card by
``tests/test_torch_mlstm_backward_cuda.py`` and ``chip_smoke.py``.

``grad_operand_dtype=bfloat16`` (with ``operand_dtype=bfloat16``: the
tensor-core backward's plain version) rounds dnum, scale_in o q, dS and
G_C where the backward's products read them.  It is held against autograd
of a hand-built forward whose four products round those operands in their
own backward (``_GradRounded``), at float32 inputs, and against
``jax.grad`` of the sequential oracle at bf16 inputs (1e-2); without the
keyword the function's bits are pinned to what they were before it was
added.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_chunk.ref import mlstm_sequential as jax_sequential
from repro_torch.kernels.mlstm_chunk import ops
from repro_torch.kernels.mlstm_chunk.ref import (NEG_INF, mlstm_chunkwise,
                                                 mlstm_chunkwise_grads)

# (B, S, H, P, chunk): several chunks, a chunk that is not a power of two,
# one chunk (chunk = S), a chunk above S (clamped to one chunk), and the
# wgmma route's smallest P
CASES = [(1, 64, 2, 16, 16), (2, 96, 2, 32, 32), (1, 60, 2, 16, 20),
         (1, 64, 1, 16, 64), (1, 32, 2, 32, 256), (1, 128, 1, 64, 32)]
REL = {torch.float64: 1e-10, torch.float32: 1e-5}
JAX_REL = 1e-4
BF16_INPUT_REL = 1e-2   # h enters dh . h rounded to bf16, as in the kernel
NAMES = ("dq", "dk", "dv", "dlogi", "dlogf")
ids = lambda c: "B{}S{}H{}P{}C{}".format(*c)   # noqa: E731


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, H, P, seed):
    """q, k, v, logi, logf, dh as float64 numpy draws.  q's rows are
    scaled by 0.05 or 3 at random, so both branches of the denominator
    are taken."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s)           # noqa: E731
    scale = np.where(rng.random((B, S, H, 1)) < 0.5, 0.05, 3.0)
    q = n(B, S, H, P) * scale
    k = n(B, S, H, P) * 2.0 / P ** 0.5
    v = n(B, S, H, P)
    logi = n(B, S, H)
    logf = -np.logaddexp(0.0, -(n(B, S, H) * 2.0 + 2.0))
    return q, k, v, logi, logf, n(B, S, H, P)


def _branches(q, k, logi, logf):
    """(rows with |n . q| > exp(-m), rows below), from the sequential
    recurrence in float64."""
    B, S, H, P = q.shape
    n = np.zeros((B, H, P))
    m = np.full((B, H), -1e30)
    upper = np.zeros((B, S, H), bool)
    for t in range(S):
        m_new = np.maximum(logf[:, t] + m, logi[:, t])
        n = n * np.exp(logf[:, t] + m - m_new)[..., None] \
            + np.exp(logi[:, t] - m_new)[..., None] * k[:, t]
        upper[:, t] = np.abs((n * q[:, t]).sum(-1)) > np.exp(-m_new)
        m = m_new
    return int(upper.sum()), int((~upper).sum())


def _torch(arrs, dtype):
    """q, k, v, dh in ``dtype``; the gates float64 for float64, else
    float32."""
    gate = torch.float64 if dtype == torch.float64 else torch.float32
    q, k, v, li, lf, dh = (torch.from_numpy(a) for a in arrs)
    return ([t.to(dtype) for t in (q, k, v)] + [li.to(gate), lf.to(gate)],
            dh.to(dtype))


def _autograd(args, dh, chunk, **kw):
    """(h, grads): autograd of ``mlstm_chunkwise`` against ``dh``."""
    ins = [t.clone().requires_grad_() for t in args]
    h = mlstm_chunkwise(*ins, chunk, **kw)
    return h.detach(), torch.autograd.grad(h, ins, dh)


def _rel(a, b):
    a, b = (np.asarray(torch.as_tensor(x).double()) for x in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _check(got, want, limit, tag):
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, (tag, name)
        assert bool(torch.isfinite(g).all()), (tag, name)
        rel = _rel(g, w)
        assert rel <= limit, (tag, name, rel)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("case", CASES, ids=ids)
def test_grads_match_autograd(case, dtype):
    B, S, H, P, chunk = case
    arrs = _inputs(B, S, H, P, seed=S * H + P)
    upper, lower = _branches(*(arrs[i] for i in (0, 1, 3, 4)))
    assert upper > 0 and lower > 0
    args, dh = _torch(arrs, dtype)
    h, want = _autograd(args, dh, chunk)
    got = mlstm_chunkwise_grads(*args, h, dh, chunk)
    assert all(g.dtype == dtype for g in got)
    _check(got, want, REL[dtype], case)


@pytest.mark.parametrize("case", CASES, ids=ids)
def test_stabilisers_take_no_gradient(case):
    """Autograd of the plain version with m_comb and m_new detached equals
    autograd with them live (float64, 1e-12)."""
    B, S, H, P, chunk = case
    args, dh = _torch(_inputs(B, S, H, P, seed=S + P), torch.float64)
    _, live = _autograd(args, dh, chunk)
    _, frozen = _autograd(args, dh, chunk, detach_m=True)
    _check(frozen, live, 1e-12, case)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=ids)
def test_rounded_grads_match_autograd(case, dtype):
    """``operand_dtype=bfloat16`` (the wgmma route's plain version)
    against autograd of the rounded plain version with the stabilisers
    detached: 1e-5 on float32 inputs; on bf16 inputs h is the forward's
    bf16 output, as the kernel reads it (1e-2).  The rounded gradients
    differ from the unrounded ones."""
    B, S, H, P, chunk = case
    arrs = _inputs(B, S, H, P, seed=3 * S + P)
    args, dh = _torch(arrs, dtype)
    bf16 = dict(operand_dtype=torch.bfloat16)
    h, want = _autograd(args, dh, chunk, detach_m=True, **bf16)
    got = mlstm_chunkwise_grads(*args, h, dh, chunk, **bf16)
    _check(got, want, 1e-5 if dtype == torch.float32 else BF16_INPUT_REL,
           case)
    plain = mlstm_chunkwise_grads(*args, h, dh, chunk)
    assert any(_rel(g, w) > 1e-6 for g, w in zip(got, plain))


@pytest.mark.parametrize("case", CASES, ids=ids)
def test_grads_match_jax(case):
    """Float32, against ``jax.grad`` of the reference's sequential oracle
    on the same numbers."""
    B, S, H, P, chunk = case
    arrs = [a.astype(np.float32) for a in _inputs(B, S, H, P, seed=S + H)]
    args, dh = _torch(arrs, torch.float32)
    h = mlstm_chunkwise(*args, chunk)
    got = mlstm_chunkwise_grads(*args, h, dh, chunk)
    _, vjp = jax.vjp(jax_sequential, *(jnp.asarray(a) for a in arrs[:5]))
    want = vjp(jnp.asarray(arrs[5]))
    _check(got, [torch.from_numpy(np.array(w)) for w in want], JAX_REL,
           case)


@pytest.mark.parametrize("case", CASES[:3], ids=ids)
def test_wrapper_on_cpu_differentiates_the_plain_version(case):
    """``ops.mlstm_chunk`` on CPU tensors: autograd of its plain version,
    which the plain backward matches."""
    B, S, H, P, chunk = case
    args, dh = _torch(_inputs(B, S, H, P, seed=S), torch.float32)
    ins = [t.clone().requires_grad_() for t in args]
    h = ops.mlstm_chunk(*ins, chunk=chunk)
    want = torch.autograd.grad(h, ins, dh)
    got = mlstm_chunkwise_grads(*args, h.detach(), dh, chunk)
    _check(got, want, REL[torch.float32], case)


def test_grads_refuse_a_chunk_that_does_not_divide():
    args, dh = _torch(_inputs(1, 48, 1, 16, seed=0), torch.float32)
    h = mlstm_chunkwise(*args, 16)
    with pytest.raises(ValueError, match="divide"):
        mlstm_chunkwise_grads(*args, h, dh, 20)


# ---------------------------------------------------------------------------
# the tensor-core backward's own roundings (grad_operand_dtype)
# ---------------------------------------------------------------------------

BF16 = dict(operand_dtype=torch.bfloat16)
BOTH = dict(operand_dtype=torch.bfloat16, grad_operand_dtype=torch.bfloat16)
# the hand-built gradient against the keyword: the two roads round a few
# elements of an operand to neighbouring bf16 values (their float32 sums
# differ in order); the roundings themselves move dq, dk, dv by ~1.7e-3
HAND_REL = 2e-4
MOVED_REL = 5e-4


def _bf(t):
    return t.to(torch.bfloat16).to(t.dtype)


class _GradRounded(torch.autograd.Function):
    """einsum(eq, a, b) whose backward rounds to bf16 the incoming gradient
    where it enters a's gradient (``ga``) or b's (``gb``), and a's value
    where it enters b's (``ra``); autograd computes both products."""

    @staticmethod
    def forward(ctx, a, b, eq, ga, gb, ra):
        ctx.save_for_backward(a, b)
        ctx.cfg = eq, ga, gb, ra
        return torch.einsum(eq, a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        eq, ga, gb, ra = ctx.cfg
        with torch.enable_grad():
            a1, b1 = a.detach().requires_grad_(), b.detach().requires_grad_()
            da, = torch.autograd.grad(torch.einsum(eq, a1, b.detach()), a1,
                                      _bf(g) if ga else g)
            a2 = _bf(a.detach()) if ra else a.detach()
            db, = torch.autograd.grad(torch.einsum(eq, a2, b1), b1,
                                      _bf(g) if gb else g)
        return da, db, None, None, None, None


def _hand_forward(q, k, v, logi, logf, chunk):
    """``mlstm_chunkwise(..., operand_dtype=bfloat16, detach_m=True)``
    written anew, with a = n_all . q as the row sums of S o W plus scale_in
    q . n (as the kernel and the plain backward take it: beta enters dS)
    and its four products as ``_GradRounded``: S = q k^T (dS
    rounded into dS k and dS^T q), (S o W) v (dnum rounded into A^T dnum,
    not into dA), (scale_in q) C (dnum rounded into C dnum and into the
    carry's gradient, scale_in q rounded there) and the carry (k o wk)^T v
    (G_C rounded into both of its products).  The forward's own roundings
    pass the gradient straight through."""
    def rnd(t):
        return t + (_bf(t) - t).detach()
    B, S, H, P = q.shape
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    c_prev = torch.zeros((B, H, P, P))
    n_prev = torch.zeros((B, H, P))
    m_prev = torch.full((B, H), NEG_INF)
    out = []
    for t0 in range(0, S, chunk):
        qi, ki, vi = (x[:, t0:t0 + chunk] for x in (q, k, v))
        li, lf = logi[:, t0:t0 + chunk], logf[:, t0:t0 + chunk]
        cum = torch.cumsum(lf, dim=1)
        d = cum[:, :, None, :] - cum[:, None, :, :] + li[:, None, :, :]
        d = torch.where(mask[None, :, :, None], d, float("-inf"))
        m_comb = torch.maximum(d.amax(dim=2), cum + m_prev[:, None, :])
        m_comb = m_comb.clamp_min(NEG_INF).detach()
        w = torch.exp(d - m_comb[:, :, None, :])
        qk = _GradRounded.apply(qi, ki, "bihp,bjhp->bijh", True, True, False)
        h_intra = _GradRounded.apply(rnd(qk * w), vi, "bijh,bjhp->bihp",
                                     False, True, False)
        scale_in = torch.exp(cum + m_prev[:, None, :] - m_comb)
        h_inter = _GradRounded.apply(scale_in[..., None] * qi, rnd(c_prev),
                                     "bihp,bhpr->bihr", True, True, True)
        # a = n_all . q as the kernel takes it: the row sums of the
        # unrounded S o W (so beta enters dS) and scale_in q . n
        a = (qk * w).sum(dim=2) + scale_in * (qi * n_prev[:, None]).sum(-1)
        den = torch.maximum(torch.abs(a), torch.exp(-m_comb))
        out.append((h_intra + h_inter) / den[..., None])
        total = cum[:, -1, :]
        m_new = torch.maximum(total + m_prev, torch.amax(
            total[:, None, :] - cum + li, dim=1)).detach()
        wk = torch.exp(total[:, None, :] - cum + li - m_new[:, None, :])
        decay = torch.exp(total + m_prev - m_new)
        c_prev = c_prev * decay[..., None, None] + _GradRounded.apply(
            rnd(ki * wk[..., None]), vi, "bjhp,bjhr->bhpr", True, True, False)
        n_prev = n_prev * decay[..., None] + torch.einsum(
            "bjhp,bjh->bhp", ki, wk)
        m_prev = m_new
    return torch.cat(out, dim=1)


GRAD_CASES = [(1, 128, 1, 64, 32), (2, 96, 2, 32, 32), (1, 64, 2, 16, 16)]


@pytest.mark.parametrize("case", GRAD_CASES, ids=ids)
def test_grad_roundings_at_the_kernel_places(case):
    """At float32 inputs, ``grad_operand_dtype`` rounds where
    ``_hand_forward``'s backward rounds (HAND_REL) and nowhere else, and
    moves dq, dk and dv off the forward-rounded gradient (MOVED_REL)."""
    B, S, H, P, chunk = case
    args, dh = _torch(_inputs(B, S, H, P, seed=5 * S + P), torch.float32)
    h = mlstm_chunkwise(*args, chunk, **BF16)
    got = mlstm_chunkwise_grads(*args, h, dh, chunk, **BOTH)
    ins = [t.clone().requires_grad_() for t in args]
    hand = torch.autograd.grad(_hand_forward(*ins, chunk), ins, dh)
    _check(got, hand, HAND_REL, case)
    fwd_only = mlstm_chunkwise_grads(*args, h, dh, chunk, **BF16)
    for name, g, f in zip(NAMES[:3], got, fwd_only):
        assert _rel(g, f) >= MOVED_REL, (case, name)


# the tensor-core route's shapes (P 64-1024, chunks 128-1024), cut short:
# several chunks, one chunk, B*H 1 and 2
BF16_CASES = [(1, 256, 2, 64, 128), (1, 256, 1, 128, 128),
              (1, 512, 1, 64, 128), (2, 256, 1, 64, 256)]


@pytest.mark.parametrize("case", BF16_CASES, ids=ids)
def test_grad_rounded_matches_jax_in_bf16(case):
    """At bf16 inputs and cotangent, the fully rounded gradient (both
    keywords; h the rounded forward's bf16 output) is within 1e-2 of
    ``jax.grad`` of the reference's sequential oracle on the same numbers,
    at the shapes the tensor-core backward takes.  (Off them, at small
    chunks, bf16 inputs alone can bring the unrounded plain version near
    the limit: h enters beta in bf16.)"""
    B, S, H, P, chunk = case
    args, dh = _torch(_inputs(B, S, H, P, seed=7 * S + H), torch.bfloat16)
    h = mlstm_chunkwise(*args, chunk, **BF16)
    got = mlstm_chunkwise_grads(*args, h, dh, chunk, **BOTH)
    arrs = [t.float().numpy() for t in (*args, dh)]
    _, vjp = jax.vjp(jax_sequential, *(jnp.asarray(a) for a in arrs[:5]))
    want = vjp(jnp.asarray(arrs[5]))
    _check(got, [torch.from_numpy(np.array(w)) for w in want],
           BF16_INPUT_REL, case)


# sha256 (first 16 hex digits) of the five gradients' bytes, as the plain
# backward gave them before ``grad_operand_dtype`` existed
PINNED = [((1, 64, 2, 16, 16), torch.float64, None, "ce1b029407a784be"),
          ((2, 96, 2, 32, 32), torch.float32, None, "84e3be5a0e172098"),
          ((1, 128, 1, 64, 32), torch.float32, torch.bfloat16,
           "3239334d37b0adb8")]


@pytest.mark.parametrize("pinned", PINNED, ids=lambda p: ids(p[0]))
def test_without_the_keyword_the_bits_are_unchanged(pinned):
    (B, S, H, P, chunk), dtype, od, digest = pinned
    args, dh = _torch(_inputs(B, S, H, P, seed=11), dtype)
    h = mlstm_chunkwise(*args, chunk, operand_dtype=od)
    got = mlstm_chunkwise_grads(*args, h, dh, chunk, operand_dtype=od)
    same = mlstm_chunkwise_grads(*args, h, dh, chunk, operand_dtype=od,
                                 grad_operand_dtype=None)
    assert all(torch.equal(a, b) for a, b in zip(got, same))
    sha = hashlib.sha256()
    for g in got:
        sha.update(g.contiguous().numpy().tobytes())
    assert sha.hexdigest()[:16] == digest


def test_backward_counters_reset_by_route():
    """Each route's backward has its own counter beside the total, and
    ``reset_launch_counts`` zeroes them all; ``BWD_KERNELS`` is by route."""
    ops.launches_bwd, ops.launches_bwd_wgmma, ops.launches_bwd_fma = 3, 2, 1
    ops.reset_launch_counts()
    assert ops.launches_bwd == ops.launches_bwd_wgmma == 0
    assert ops.launches_bwd_fma == ops.launches == 0
    assert set(ops.BWD_KERNELS) == {"wgmma", "fma"}


@pytest.mark.parametrize("dtype, P, chunk", [
    (torch.float32, 128, 256), (torch.bfloat16, 32, 128),
    (torch.bfloat16, 128, 64)], ids=["float32", "P32", "chunk64"])
def test_wgmma_backward_refuses_other_routes(dtype, P, chunk):
    """``ops._backward_wgmma`` takes only the wgmma route's inputs (bf16,
    P in ``WGMMA_HEAD_DIMS``, a chunk in ``WGMMA_CHUNKS``) and refuses the
    others before any device work."""
    S = 2 * chunk
    args = [torch.zeros((1, S, 1, P), dtype=dtype) for _ in range(3)] + [
        torch.zeros((1, S, 1)) for _ in range(2)]
    h = dh = torch.zeros((1, S, 1, P), dtype=dtype)
    assert ops.route(dtype, P, chunk) == "fma"
    with pytest.raises(ValueError, match="bf16 at P in"):
        ops._backward_wgmma(*args, h, dh, chunk)

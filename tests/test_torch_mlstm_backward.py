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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_chunk.ref import mlstm_sequential as jax_sequential
from repro_torch.kernels.mlstm_chunk import ops
from repro_torch.kernels.mlstm_chunk.ref import (mlstm_chunkwise,
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

"""The hand-written CUDA mLSTM backwards (``csrc/mlstm_chunk_bwd_wgmma.cu``
on the tensor cores, ``csrc/mlstm_chunk_bwd.cu`` on fp32 FMAs) against
their plain versions, on the card.  Needs an NVIDIA GPU (``cuda``
marker); skips without one.  Imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_mlstm_backward_cuda.py

A CUDA call of ``ops.mlstm_chunk`` that asks for a gradient goes through
the ``autograd.Function``: the routed forward, then the same route's
backward.  Plain versions: ``ref.mlstm_chunkwise_grads`` (float32, no
rounding) for every route, and on the wgmma route also
``ref.mlstm_chunkwise_grads(..., operand_dtype=torch.bfloat16,
grad_operand_dtype=torch.bfloat16)``, which rounds where that route's
forward and backward round.  Limits: relative L2 of each of dq, dk, dv,
d logi, d logf 1e-5 (float32) and 1e-2 (bf16) against the first, 5e-3
against the second; a planted fault (d logf written one row off) lands
above each; two calls bit-equal; each route's counter moves once a call
and the other's not at all.  The inputs put rows on both branches of the
denominator (q scaled row by row).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.mlstm_chunk import ops
from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunkwise_grads

REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
REL_ROUNDED = 5e-3          # the wgmma route against its rounded plain version
ROUNDED = dict(operand_dtype=torch.bfloat16,
               grad_operand_dtype=torch.bfloat16)
F32, BF16 = torch.float32, torch.bfloat16
# (B, S, H, P, chunk, dtype): every P of the FMA forward in float32, a
# chunk that is no power of two, chunk 1 and 5, one chunk (chunk = S); bf16
# on the FMA forward (P 32, chunk 64); the wgmma route at P 64-1024 and
# chunks 128-1024, one chunk and two, odd B*H
CASES = [
    (1, 128, 2, 16, 32, F32), (2, 96, 2, 32, 48, F32), (1, 64, 1, 64, 64, F32),
    (1, 256, 2, 128, 64, F32), (1, 128, 1, 256, 128, F32),
    (1, 64, 1, 512, 16, F32), (1, 64, 1, 1024, 32, F32),
    (1, 20, 1, 16, 1, F32), (1, 50, 3, 16, 5, F32),
    (1, 128, 2, 32, 32, BF16), (1, 128, 2, 64, 64, BF16),
    (1, 256, 2, 64, 128, BF16), (1, 512, 1, 128, 256, BF16),
    (2, 256, 1, 256, 128, BF16), (1, 512, 3, 512, 256, BF16),
    (1, 1024, 1, 1024, 1024, BF16), (1, 2048, 1, 64, 1024, BF16),
]
FULL = (1, 4096, 4, 1024, 256)       # xlstm-1.3b's layer at microbatch 1
ids = lambda c: "B{}S{}H{}P{}C{}-{}".format(                  # noqa: E731
    *c[:5], str(c[5]).split(".")[-1])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(B, S, H, P, device, dtype, seed=0):
    """q (rows scaled by 0.05 or 3, so both branches of the denominator
    are taken), k ~ 2 N / sqrt(P), v ~ N, logi ~ N, logf = -softplus(-(2 N
    + 2)), dh ~ N; q, k, v, dh in ``dtype``, the gates float32."""
    rng = np.random.default_rng(seed)
    n = lambda *s: torch.from_numpy(                       # noqa: E731
        rng.standard_normal(s, dtype=np.float32))
    scale = torch.from_numpy(np.where(rng.random((B, S, H, 1)) < 0.5, 0.05,
                                      3.0).astype(np.float32))
    q, k, v = n(B, S, H, P) * scale, n(B, S, H, P) * 2.0 / P ** 0.5, \
        n(B, S, H, P)
    logi = n(B, S, H)
    logf = -torch.nn.functional.softplus(-(n(B, S, H) * 2.0 + 2.0))
    dh = n(B, S, H, P)
    return ([t.to(device=device, dtype=dtype) for t in (q, k, v)]
            + [t.to(device) for t in (logi, logf)],
            dh.to(device=device, dtype=dtype))


def _grads(args, dh, chunk):
    """(h, the five gradients) through ``ops.mlstm_chunk``'s autograd."""
    ins = [t.clone().requires_grad_() for t in args]
    h = ops.mlstm_chunk(*ins, chunk=chunk)
    assert h.grad_fn is not None
    return h.detach(), torch.autograd.grad(h, ins, dh)


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def _fault(want):
    """A planted fault: d logf of each row written to the next one (an
    index one row off)."""
    dlf = torch.roll(want[4], 1, dims=1)
    dlf[:, 0] = 0
    return (*want[:4], dlf)


def _counts():
    return (ops.launches_bwd, ops.launches_bwd_wgmma, ops.launches_bwd_fma,
            ops.launches_wgmma, ops.launches_fma)


def _check(args, dh, chunk, dtype):
    B, S, H, P = args[0].shape
    which = ops.route(dtype, P, min(chunk, S))
    before = _counts()
    h, got = _grads(args, dh, chunk)
    again = _grads(args, dh, chunk)[1]
    torch.cuda.synchronize()
    wg, fm = 2 * (which == "wgmma"), 2 * (which == "fma")
    assert tuple(a - b for a, b in zip(_counts(), before)) == (
        2, wg, fm, wg, fm)
    for g, t in zip(got, args):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert bool(torch.isfinite(g.float()).all())
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    plains = [(mlstm_chunkwise_grads(*args, h, dh, chunk), REL[dtype])]
    if which == "wgmma":
        plains.append((mlstm_chunkwise_grads(*args, h, dh, chunk, **ROUNDED),
                       REL_ROUNDED))
    for want, limit in plains:
        rels = [_rel(g, w) for g, w in zip(got, want)]
        assert max(rels) <= limit, rels
        assert max(_rel(f, w) for f, w in zip(_fault(want), want)) \
            > limit


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=ids)
def test_backward_matches_plain_versions(cuda, case):
    B, S, H, P, chunk, dtype = case
    args, dh = _inputs(B, S, H, P, cuda, dtype, seed=S * H + P)
    _check(args, dh, chunk, dtype)


@pytest.mark.cuda
def test_full_width_layer_shape(cuda):
    args, dh = _inputs(*FULL[:4], cuda, BF16, seed=5)
    assert ops.route(BF16, FULL[3], FULL[4]) == "wgmma"
    _check(args, dh, FULL[4], BF16)


@pytest.mark.cuda
def test_a_call_without_a_gradient_launches_no_backward(cuda):
    """The forward's launch is the same with and without a gradient asked
    (bit-equal outputs); only the call that asks launches the backward."""
    args, _ = _inputs(1, 512, 2, 128, cuda, BF16, seed=1)
    before = ops.launches_bwd
    with torch.no_grad():
        plain = ops.mlstm_chunk(*args, chunk=256)
    ins = [t.clone().requires_grad_() for t in args]
    h = ops.mlstm_chunk(*ins, chunk=256)
    torch.cuda.synchronize()
    assert ops.launches_bwd == before
    assert torch.equal(h.detach(), plain)
    h.float().sum().backward()
    assert ops.launches_bwd == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, P, chunk", [(F32, 64, 32), (BF16, 64, 128),
                                            (BF16, 128, 256)],
                         ids=["fma-f32", "wgmma-P64", "wgmma-P128"])
def test_strided_inputs_are_read_in_place(cuda, dtype, P, chunk):
    """q/k/v as head slices of one [B,S,3H,P] tensor, the gates as columns
    of a wider one and dh as a head slice: the same gradients, bit for
    bit, on either route."""
    B, S, H = 1, 512, 2
    args, dh = _inputs(B, S, H, P, cuda, dtype, seed=3)
    qkv = torch.cat(args[:3], dim=2)
    gates = torch.cat(args[3:], dim=2)
    views = [qkv[:, :, :H], qkv[:, :, H:2 * H], qkv[:, :, 2 * H:],
             gates[..., :H], gates[..., H:]]
    dh_view = torch.cat([dh, dh], dim=2)[:, :, H:]
    got = _grads(views, dh_view, chunk)[1]
    want = _grads(args, dh, chunk)[1]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_float32_stays_on_the_fma_backward(cuda):
    """A float32 call at the wgmma route's shape runs the FMA forward and
    the FMA backward, bit-equal to ``ops._backward`` called directly
    without roundings."""
    args, dh = _inputs(1, 512, 2, 128, cuda, F32, seed=9)
    assert ops.route(F32, 128, 256) == "fma"
    before = _counts()
    h, got = _grads(args, dh, 256)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_counts(), before)) == (1, 0, 1, 0, 1)
    want = ops._backward(*args, h, dh, 256, False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_wgmma_backward_called_directly_matches_autograd(cuda):
    """``ops._backward_wgmma`` on the forward's output gives autograd's
    bits, counts one wgmma backward launch and no FMA one; it refuses a
    float32 input."""
    args, dh = _inputs(1, 512, 2, 128, cuda, BF16, seed=4)
    h, want = _grads(args, dh, 256)
    before = _counts()
    got = ops._backward_wgmma(*args, h, dh, 256)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_counts(), before)) == (1, 1, 0, 0, 0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="bf16"):
        ops._backward_wgmma(*(t.float() if t.dtype == BF16 else t
                              for t in args), h.float(), dh.float(), 256)


@pytest.mark.cuda
def test_refuses_a_chunk_above_1024_with_a_gradient(cuda):
    args, _ = _inputs(1, 2048, 1, 32, cuda, F32)
    ins = [t.clone().requires_grad_() for t in args]
    with pytest.raises(ValueError, match="1024"):
        ops.mlstm_chunk(*ins, chunk=2048)
    with torch.no_grad():                 # the forward alone takes it
        ops.mlstm_chunk(*ins, chunk=2048)

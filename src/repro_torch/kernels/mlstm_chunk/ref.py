"""Plain-torch versions of the chunkwise mLSTM kernel.

``mlstm_sequential`` is the oracle: the stabilised recurrence one step at
a time (``repro.kernels.mlstm_chunk.ref``).  ``mlstm_chunkwise`` is the
body of the reference model's chunked scan (``repro.models.xlstm``
``mlstm_apply``): it keeps that body's ``-inf``-masked decay matrix, its
``max(., -1e30)`` clamp on the stabiliser and its chunk-local inclusive
cumsum.  It is the CPU path of ``ops.mlstm_chunk`` and the yardstick
``chip_smoke.py`` holds the CUDA kernels against on the card; with
``operand_dtype=torch.bfloat16`` it rounds where the tensor-core kernel
rounds (its plain version).  ``mlstm_gates`` computes the stabilisers of
every chunk from the gates alone, as that kernel's first pass does.

Both take q/k/v [B,S,H,P] (k already scaled by 1/sqrt(P)) and the gates
logi/logf [B,S,H], compute in float32 and return h [B,S,H,P] in q's dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30


def mlstm_sequential(q, k, v, logi, logf):
    """The stabilised mLSTM recurrence, one time step at a time."""
    B, S, H, P = q.shape
    qf, kf, vf = (t.float() for t in (q, k, v))
    li, lf = logi.float(), logf.float()
    c = torch.zeros((B, H, P, P), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, H, P), dtype=torch.float32, device=q.device)
    m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=q.device)
    hs = []
    for t in range(S):
        m_new = torch.maximum(lf[:, t] + m, li[:, t])
        fw = torch.exp(lf[:, t] + m - m_new)
        iw = torch.exp(li[:, t] - m_new)
        c = c * fw[..., None, None] + iw[..., None, None] * torch.einsum(
            "bhp,bhr->bhpr", kf[:, t], vf[:, t])
        n = n * fw[..., None] + iw[..., None] * kf[:, t]
        num = torch.einsum("bhp,bhpr->bhr", qf[:, t], c)
        den = torch.maximum(torch.abs(torch.einsum("bhp,bhp->bh", n,
                                                   qf[:, t])),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1).to(q.dtype)


def mlstm_chunkwise(q, k, v, logi, logf, chunk: int, *,
                    operand_dtype=None, record=None):
    """The stabilised chunkwise-parallel form, chunk by chunk in order.

    Within a chunk: D[i,j] = cum_i - cum_j + li_j for j <= i (else -inf),
    m_comb = max(max_j D, cum + m_prev) clamped at -1e30, W = exp(D -
    m_comb), h = ((q k^T) o W) v + (q C_prev) exp(cum + m_prev - m_comb),
    divided by max(|n_all . q|, exp(-m_comb)).  Across chunks it carries
    C [P,P], n [P] and the scalar m per (batch, head).

    ``operand_dtype`` (``torch.bfloat16``): round to that type the operands
    the tensor-core kernel rounds, each right before its product: (q k^T)
    o W before the product with v, k o wk before the carry product, and
    the carried C before q C_prev.  The carries, n and every sum stay in
    float32.  None (or float32) rounds nothing.  ``record``: a list that
    gets, per chunk in order, a dict of the gate terms the walk carries
    (m_prev, m_comb, scale_in, wk, decay)."""
    def rnd(t):
        return t if operand_dtype is None else t.to(operand_dtype).float()

    B, S, H, P = q.shape
    c = min(chunk, S)
    if c < 1 or S % c:
        raise ValueError(f"chunk {c} must divide the sequence length {S}")
    dev = q.device
    qf, kf, vf = (t.float() for t in (q, k, v))
    li_all, lf_all = logi.float(), logf.float()
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev))
    c_prev = torch.zeros((B, H, P, P), dtype=torch.float32, device=dev)
    n_prev = torch.zeros((B, H, P), dtype=torch.float32, device=dev)
    m_prev = torch.full((B, H), NEG_INF, dtype=torch.float32, device=dev)
    out = torch.empty((B, S, H, P), dtype=q.dtype, device=dev)
    for t0 in range(0, S, c):
        qi, ki, vi = (t[:, t0:t0 + c] for t in (qf, kf, vf))   # [B,c,H,P]
        li, lf = li_all[:, t0:t0 + c], lf_all[:, t0:t0 + c]    # [B,c,H]
        cum = torch.cumsum(lf, dim=1)                          # inclusive
        d = cum[:, :, None, :] - cum[:, None, :, :] + li[:, None, :, :]
        d = torch.where(mask[None, :, :, None], d, float("-inf"))
        m_loc = d.amax(dim=2)                                  # [B,i,H]
        m_comb = torch.maximum(m_loc, cum + m_prev[:, None, :])
        m_comb = m_comb.clamp_min(NEG_INF)                     # avoid -inf
        w = torch.exp(d - m_comb[:, :, None, :])               # [B,i,j,H]
        qk = torch.einsum("bihp,bjhp->bijh", qi, ki)
        h_intra = torch.einsum("bijh,bjhp->bihp", rnd(qk * w), vi)
        n_intra = torch.einsum("bijh,bjhp->bihp", w, ki)
        scale_in = torch.exp(cum + m_prev[:, None, :] - m_comb)
        h_inter = torch.einsum("bihp,bhpr->bihr", qi, rnd(c_prev)) \
            * scale_in[..., None]
        n_all = n_intra + n_prev[:, None] * scale_in[..., None]
        denom = torch.maximum(
            torch.abs(torch.einsum("bihp,bihp->bih", n_all, qi)),
            torch.exp(-m_comb))
        out[:, t0:t0 + c] = ((h_intra + h_inter)
                             / denom[..., None]).to(q.dtype)
        # carry update
        total = cum[:, -1, :]                                  # [B,H]
        m_new = torch.maximum(total + m_prev, torch.amax(
            total[:, None, :] - cum + li, dim=1))
        wk = torch.exp(total[:, None, :] - cum + li - m_new[:, None, :])
        decay = torch.exp(total + m_prev - m_new)
        c_prev = c_prev * decay[..., None, None] + torch.einsum(
            "bjhp,bjhr->bhpr", rnd(ki * wk[..., None]), vi)
        n_prev = n_prev * decay[..., None] + torch.einsum(
            "bjhp,bjh->bhp", ki, wk)
        if record is not None:
            record.append(dict(m_prev=m_prev, m_comb=m_comb,
                               scale_in=scale_in, wk=wk, decay=decay))
        m_prev = m_new
    return out


class MlstmGates(NamedTuple):
    """The stabilisers of every chunk, from the gates alone."""
    cum: torch.Tensor       # [B,S,H] chunk-local inclusive cumsum of logf
    m_comb: torch.Tensor    # [B,S,H]
    scale_in: torch.Tensor  # [B,S,H] exp(cum + m_prev - m_comb)
    wk: torch.Tensor        # [B,S,H] exp(total - cum + li - m_new)
    m_prev: torch.Tensor    # [B,n,H] the stabiliser entering each chunk
    decay: torch.Tensor     # [B,n,H] exp(total + m_prev - m_new)


def mlstm_gates(logi, logf, chunk: int) -> MlstmGates:
    """The gate terms ``mlstm_chunkwise`` carries, for all chunks at once.

    The stabiliser chain m_new = max(total + m_prev, max_j(total - cum_j +
    li_j)) reads only the gates, so it runs first, over the chunks' totals,
    and every other term follows row by row with no carried product: the
    plain version of the tensor-core kernel's first pass.  The expressions
    are ``mlstm_chunkwise``'s, in its order."""
    B, S, H = logi.shape
    c = min(chunk, S)
    if c < 1 or S % c:
        raise ValueError(f"chunk {c} must divide the sequence length {S}")
    n = S // c
    li = logi.float().reshape(B, n, c, H)
    cum = torch.cumsum(logf.float().reshape(B, n, c, H), dim=2)
    total = cum[:, :, -1, :]                                   # [B,n,H]
    g = torch.amax(total[:, :, None, :] - cum + li, dim=2)     # [B,n,H]
    m_prev = torch.empty_like(total)
    m_new = torch.empty_like(total)
    m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=li.device)
    for t in range(n):                     # the only sequential part
        m_prev[:, t] = m
        m = torch.maximum(total[:, t] + m, g[:, t])
        m_new[:, t] = m
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=li.device))
    d = cum[:, :, :, None, :] - cum[:, :, None, :, :] + li[:, :, None, :, :]
    d = torch.where(mask[None, None, :, :, None], d, float("-inf"))
    m_comb = torch.maximum(d.amax(dim=3), cum + m_prev[:, :, None, :])
    m_comb = m_comb.clamp_min(NEG_INF)
    scale_in = torch.exp(cum + m_prev[:, :, None, :] - m_comb)
    wk = torch.exp(total[:, :, None, :] - cum + li - m_new[:, :, None, :])
    decay = torch.exp(total + m_prev - m_new)
    flat = lambda t: t.reshape(B, S, H)                    # noqa: E731
    return MlstmGates(flat(cum), flat(m_comb), flat(scale_in), flat(wk),
                      m_prev, decay)

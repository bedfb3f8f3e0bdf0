"""Plain-torch versions of the chunkwise mLSTM kernel.

``mlstm_sequential`` is the oracle: the stabilised recurrence one step at
a time (``repro.kernels.mlstm_chunk.ref``).  ``mlstm_chunkwise`` is the
body of the reference model's chunked scan (``repro.models.xlstm``
``mlstm_apply``): it keeps that body's ``-inf``-masked decay matrix, its
``max(., -1e30)`` clamp on the stabiliser and its chunk-local inclusive
cumsum.  It is the CPU path of ``ops.mlstm_chunk`` and the yardstick
``chip_smoke.py`` holds the CUDA kernel against on the card.

Both take q/k/v [B,S,H,P] (k already scaled by 1/sqrt(P)) and the gates
logi/logf [B,S,H], compute in float32 and return h [B,S,H,P] in q's dtype.
"""

from __future__ import annotations

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


def mlstm_chunkwise(q, k, v, logi, logf, chunk: int):
    """The stabilised chunkwise-parallel form, chunk by chunk in order.

    Within a chunk: D[i,j] = cum_i - cum_j + li_j for j <= i (else -inf),
    m_comb = max(max_j D, cum + m_prev) clamped at -1e30, W = exp(D -
    m_comb), h = ((q k^T) o W) v + (q C_prev) exp(cum + m_prev - m_comb),
    divided by max(|n_all . q|, exp(-m_comb)).  Across chunks it carries
    C [P,P], n [P] and the scalar m per (batch, head)."""
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
        h_intra = torch.einsum("bijh,bjhp->bihp", qk * w, vi)
        n_intra = torch.einsum("bijh,bjhp->bihp", w, ki)
        scale_in = torch.exp(cum + m_prev[:, None, :] - m_comb)
        h_inter = torch.einsum("bihp,bhpr->bihr", qi, c_prev) \
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
            "bjhp,bjhr->bhpr", ki * wk[..., None], vi)
        n_prev = n_prev * decay[..., None] + torch.einsum(
            "bjhp,bjh->bhp", ki, wk)
        m_prev = m_new
    return out

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
``mlstm_chunkwise_grads`` is the plain version of the backward kernel
(``csrc/mlstm_chunk_bwd.cu``): the gradients of ``mlstm_chunkwise``,
chunk by chunk in reverse, with the stabilisers held constant.

They take q/k/v [B,S,H,P] (k already scaled by 1/sqrt(P)) and the gates
logi/logf [B,S,H], compute in float32 (float64 for float64 inputs) and
return h [B,S,H,P] in q's dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


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
                    operand_dtype=None, record=None, detach_m: bool = False):
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
    float32.  None (or float32) rounds nothing.  A rounding passes the
    gradient through unrounded (its value is the rounded operand, bit for
    bit), so autograd gives the gradient the backward kernel computes.
    ``record``: a list that gets, per chunk in order, a dict of the gate
    terms the walk carries (m_prev, m_comb, scale_in, wk, decay).
    ``detach_m``: hold the stabilisers m_comb and m_new constant under
    autograd (h does not depend on them, so the gradient is the same)."""
    def rnd(t):
        if operand_dtype is None:
            return t
        return t + (t.to(operand_dtype).to(t.dtype) - t).detach()

    B, S, H, P = q.shape
    c = min(chunk, S)
    if c < 1 or S % c:
        raise ValueError(f"chunk {c} must divide the sequence length {S}")
    dev, ct = q.device, _compute_dtype(q)
    qf, kf, vf = (t.to(ct) for t in (q, k, v))
    li_all, lf_all = logi.to(ct), logf.to(ct)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev))
    c_prev = torch.zeros((B, H, P, P), dtype=ct, device=dev)
    n_prev = torch.zeros((B, H, P), dtype=ct, device=dev)
    m_prev = torch.full((B, H), NEG_INF, dtype=ct, device=dev)
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
        if detach_m:
            m_comb = m_comb.detach()
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
        if detach_m:
            m_new = m_new.detach()
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
    ct = _compute_dtype(logi)
    li = logi.to(ct).reshape(B, n, c, H)
    cum = torch.cumsum(logf.to(ct).reshape(B, n, c, H), dim=2)
    total = cum[:, :, -1, :]                                   # [B,n,H]
    g = torch.amax(total[:, :, None, :] - cum + li, dim=2)     # [B,n,H]
    m_prev = torch.empty_like(total)
    m_new = torch.empty_like(total)
    m = torch.full((B, H), NEG_INF, dtype=ct, device=li.device)
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


def mlstm_chunkwise_grads(q, k, v, logi, logf, h, dh, chunk: int, *,
                          operand_dtype=None, grad_operand_dtype=None):
    """(dq, dk, dv, dlogi, dlogf) of ``mlstm_chunkwise`` against the
    cotangent ``dh``, in float32 (float64 for float64 inputs); ``h`` is
    the forward's output.  The backward kernel's plain version, in its
    order of terms.

    Every numerator term and the denominator carry exp(-m) of their row,
    so h does not depend on the stabilisers: they are constants here
    (``mlstm_gates``).  With the ones-column augmentation v~ = [v, 1],
    C~ = [C, n], the numerator and a = n_all . q are one product, and
    dnum~_i = [dh_i / den_i, beta_i], beta_i = -sign(a_i) (dh_i . h_i) /
    den_i where |a_i| > exp(-m_comb_i), else 0.  A forward walk gives
    C~ entering each chunk; the reverse walk carries G = dL/dC~ leaving
    the chunk, G <- decay G + sum_i scale_in_i q_i^T dnum~_i.  Per chunk:
    dA = dnum~ v~^T on the causal triangle, dS = dA o W, E = dA o (S o W);
    dq = dS k + scale_in C~ dnum~, dk = dS^T q + wk G v~, dv = (S o W)^T
    dnum + G_C^T (k o wk); the gates take E's row and column sums,
    dscale_in = q . (C~ dnum~), dwk = k . (G v~) and d decay = <G, C~>,
    and d logf is the reverse cumsum of d cum within the chunk.

    ``operand_dtype`` (``torch.bfloat16``): the forward's roundings (the
    wgmma route's), where its values enter a product: S o W into the
    product with dnum, k o wk into the carry and into G_C^T (k o wk), and
    the carried C (not n) into C~ dnum~.

    ``grad_operand_dtype`` (``torch.bfloat16``): the wgmma backward's own
    roundings, each where a product reads the operand and nowhere else:
    dnum = dh / den in the reverse carry, in C dnum and in A^T dnum;
    scale_in o q (the product, rounded) in the reverse carry; dS in dS k
    and dS^T q; G_C in G_C v and G_C^T (k o wk).  n, G_n, beta, the
    rank-one terms, d decay (with the unrounded G_C) and every sum stay
    unrounded.  None rounds nothing, and the function is then what it was
    without the keyword, bit for bit."""
    B, S, H, P = q.shape
    c = min(chunk, S)
    if c < 1 or S % c:
        raise ValueError(f"chunk {c} must divide the sequence length {S}")
    n, dev, ct = S // c, q.device, _compute_dtype(q)

    def rnd(t):
        return t if operand_dtype is None else t.to(operand_dtype).to(ct)

    def rg(t):
        if grad_operand_dtype is None:
            return t
        return t.to(grad_operand_dtype).to(ct)

    def chunks(t):
        return t.to(ct).reshape((B, n, c) + tuple(t.shape[2:]))
    qf, kf, vf, hf, dhf, li = (chunks(t) for t in (q, k, v, h, dh, logi))
    gates = mlstm_gates(logi, logf, c)
    cum, m_comb, scale_in, wk = (chunks(t) for t in (
        gates.cum, gates.m_comb, gates.scale_in, gates.wk))
    decay = gates.decay                                        # [B,n,H]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev))
    # the forward walk: C~ = [C, n] entering each chunk
    c_in, n_in = [], []
    c_t = torch.zeros((B, H, P, P), dtype=ct, device=dev)
    n_t = torch.zeros((B, H, P), dtype=ct, device=dev)
    for t in range(n):
        c_in.append(c_t)
        n_in.append(n_t)
        kw = kf[:, t] * wk[:, t, ..., None]
        c_t = c_t * decay[:, t, :, None, None] + torch.einsum(
            "bjhp,bjhr->bhpr", rnd(kw), vf[:, t])
        n_t = n_t * decay[:, t, :, None] + torch.einsum(
            "bjhp,bjh->bhp", kf[:, t], wk[:, t])
    del c_t, n_t
    dq, dk, dv = (torch.empty((B, n, c, H, P), dtype=ct, device=dev)
                  for _ in range(3))
    dli, dlf = (torch.empty((B, n, c, H), dtype=ct, device=dev)
                for _ in range(2))
    g_c = torch.zeros((B, H, P, P), dtype=ct, device=dev)     # G = [G_C, G_n]
    g_n = torch.zeros((B, H, P), dtype=ct, device=dev)
    for t in reversed(range(n)):
        qi, ki, vi, hi, dhi = (x[:, t] for x in (qf, kf, vf, hf, dhf))
        cm, lit, mc, sc, wkt = (x[:, t] for x in (cum, li, m_comb, scale_in,
                                                  wk))
        d = cm[:, :, None, :] - cm[:, None, :, :] + lit[:, None, :, :]
        d = torch.where(mask[None, :, :, None], d, float("-inf"))
        w = torch.exp(d - mc[:, :, None, :])                  # [B,i,j,H]
        a_mat = torch.einsum("bihp,bjhp->bijh", qi, ki) * w   # S o W
        a = a_mat.sum(dim=2) + sc * torch.einsum("bihp,bhp->bih", qi,
                                                 n_in[t])
        floor = torch.exp(-mc)
        den = torch.maximum(a.abs(), floor)
        g = dhi / den[..., None]                              # dnum
        beta = torch.where(a.abs() > floor,
                           -torch.sign(a) * (dhi * hi).sum(-1) / den,
                           torch.zeros_like(a))
        d_a = torch.einsum("bihp,bjhp->bijh", g, vi) + beta[:, :, None, :]
        d_a = torch.where(mask[None, :, :, None], d_a, 0.0)
        d_s = d_a * w
        e = d_a * a_mat
        x = torch.einsum("bhpr,bihr->bihp", rnd(c_in[t]), rg(g)) \
            + n_in[t][:, None] * beta[..., None]              # C~ dnum~
        dq[:, t] = torch.einsum("bijh,bjhp->bihp", rg(d_s), ki) \
            + sc[..., None] * x
        y = torch.einsum("bhpr,bjhr->bjhp", rg(g_c), vi) \
            + g_n[:, None]                                    # G v~
        dk[:, t] = torch.einsum("bijh,bihp->bjhp", rg(d_s), qi) \
            + wkt[..., None] * y
        dv[:, t] = torch.einsum("bijh,bihr->bjhr", rnd(a_mat), rg(g)) \
            + torch.einsum("bjhp,bhpr->bjhr", rnd(ki * wkt[..., None]),
                           rg(g_c))
        d_decay = (g_c * c_in[t]).sum((-2, -1)) + (g_n * n_in[t]).sum(-1)
        f = (ki * y).sum(-1) * wkt                            # dwk o wk
        e_col = e.sum(dim=1)
        dli[:, t] = e_col + f
        d_cum = e.sum(dim=2) - e_col + (qi * x).sum(-1) * sc - f
        d_cum[:, -1] += f.sum(dim=1) + d_decay * decay[:, t]  # d total
        dlf[:, t] = torch.flip(torch.cumsum(torch.flip(d_cum, (1,)), 1),
                               (1,))
        if grad_operand_dtype is None:
            dg_c = torch.einsum("bih,bihp,bihr->bhpr", sc, qi, g)
        else:
            dg_c = torch.einsum("bihp,bihr->bhpr", rg(sc[..., None] * qi),
                                rg(g))
        g_c = g_c * decay[:, t, :, None, None] + dg_c
        g_n = g_n * decay[:, t, :, None] + torch.einsum(
            "bih,bihp,bih->bhp", sc, qi, beta)
    flat = lambda t: t.reshape((B, S) + tuple(t.shape[3:]))   # noqa: E731
    return flat(dq), flat(dk), flat(dv), flat(dli), flat(dlf)

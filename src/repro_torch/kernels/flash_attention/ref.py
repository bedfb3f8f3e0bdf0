"""Plain-torch version of the flash-attention kernel (materialises scores).

The CPU path of ``ops.flash_attention`` and the yardstick ``chip_smoke.py``
holds the CUDA kernel against on the card.  Causal alignment is top-left:
query row i sees keys <= i, also when Sq != Sk.  A window without
``causal`` masks only the window (keys > i - window).

``p_dtype=torch.bfloat16`` is the plain version of the kernel's bf16
route, which rounds P to bf16 before P.V: the unnormalised exp(s - m) is
rounded, the row sum is taken in float32 from the unrounded values, and
the sum of bf16(p) v is divided by it.  The kernel takes m as the running
max of the tiles seen so far and this version the row's max, so both
round the same values, scaled by different powers of e (roundings of the
same size, not the same bits).

``attention_grads`` is the plain version of the backward kernel: autograd
of ``reference_attention`` with P in float32, on float32 copies of the
inputs.  On the bf16 route that is the straight-through gradient of the
forward's P rounding, which the kernel computes too.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def reference_attention(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        p_dtype: Optional[torch.dtype] = None):
    """q [B,Sq,H,D], k/v [B,Sk,Kh,D] -> [B,Sq,H,D] (q.dtype), f32 math;
    ``p_dtype`` rounds P before P.V (None: P stays float32)."""
    B, Sq, H, D = q.shape
    _, Sk, Kh, _ = k.shape
    rep = H // Kh
    kr = torch.repeat_interleave(k, rep, dim=2).float()
    vr = torch.repeat_interleave(v, rep, dim=2).float()
    qf = q.float() / math.sqrt(D)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kr)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qi = torch.arange(Sq, device=q.device)[:, None]
    ki = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    if p_dtype is None:
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, vr)
        return o.to(q.dtype)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    rowsum = e.sum(dim=-1)                               # [B,H,Sq], f32
    o = torch.einsum("bhqk,bkhd->bqhd", e.to(p_dtype).float(), vr)
    return (o / rowsum.transpose(1, 2)[..., None]).to(q.dtype)


def attention_grads(q, k, v, dout, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None):
    """(dq, dk, dv) in float32: ``torch.autograd.grad`` of
    ``reference_attention(..., p_dtype=None)`` at float32 copies of q, k,
    v against the cotangent ``dout``."""
    qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    with torch.enable_grad():
        o = reference_attention(qf, kf, vf, causal=causal, window=window,
                                softcap=softcap)
        return torch.autograd.grad(o, (qf, kf, vf), dout.float())

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

``attention_grads`` is the plain version of the backward kernels.  With
``operand_dtype=None`` it is autograd of ``reference_attention`` with P
in float32, on float32 copies of the inputs: the FMA route's function.
With ``operand_dtype=torch.bfloat16`` it is the wgmma route's: the same
gradient written out (P = exp(s - L), dP = dO v^T, D_i = rowsum(P dP),
dS = P (dP - D_i), times 1 - tanh^2 under a soft-cap), with P rounded to
bf16 before P^T dO and dS rounded to bf16 before dS^T q and dS k, the
two places where the kernel feeds them to the tensor cores, and
everything else in float32.
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


def visible_mask(Sq: int, Sk: int, causal: bool, window: Optional[int],
                 device=None):
    """[Sq, Sk] bool: the (query, key) pairs the kernels attend to."""
    qi = torch.arange(Sq, device=device)[:, None]
    ki = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    return mask


def attention_grads(q, k, v, dout, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    operand_dtype: Optional[torch.dtype] = None):
    """(dq, dk, dv) in float32.  ``operand_dtype=None``:
    ``torch.autograd.grad`` of ``reference_attention(..., p_dtype=None)``
    at float32 copies of q, k, v against the cotangent ``dout``.
    Otherwise the same gradient with P and dS rounded to
    ``operand_dtype`` where they enter the products (module docstring);
    a row with nothing visible then gets zero gradient, as in the
    kernel."""
    if operand_dtype is not None:
        return _rounded_grads(q, k, v, dout, causal, window, softcap,
                              operand_dtype)
    qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    with torch.enable_grad():
        o = reference_attention(qf, kf, vf, causal=causal, window=window,
                                softcap=softcap)
        return torch.autograd.grad(o, (qf, kf, vf), dout.float())


def _rounded_grads(q, k, v, dout, causal, window, softcap, operand_dtype):
    B, Sq, H, D = q.shape
    _, Sk, Kh, _ = k.shape
    rep = H // Kh
    scale = 1.0 / math.sqrt(D)
    qf, do = q.float(), dout.float()
    kr = torch.repeat_interleave(k, rep, dim=2).float()
    vr = torch.repeat_interleave(v, rep, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kr) * scale
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
    mask = visible_mask(Sq, Sk, causal, window, q.device)[None, None]
    lse = torch.logsumexp(torch.where(mask, s, NEG_INF), dim=-1,
                          keepdim=True)
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    del s
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vr)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    del dp
    if softcap is not None:
        ds = ds * (1 - t * t)
        del t
    p = p.to(operand_dtype).float()
    ds = ds.to(operand_dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    del p
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return (dq, dk.reshape(B, Sk, Kh, rep, D).sum(3),
            dv.reshape(B, Sk, Kh, rep, D).sum(3))

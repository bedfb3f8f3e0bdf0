"""GQA attention: reference, chunked, flash, and decode (from
``repro.models.attention``).

Three selectable implementations (the ``attention_impl`` knob — a C3
module-selector in SAPPHIRE's space):

* ``reference`` — plain einsum softmax attention; materializes the [S, S]
  score matrix.  The oracle for everything else.
* ``chunked``   — online softmax over KV chunks in a Python loop; never
  materializes [S, S].
* ``flash``     — the hand-written CUDA kernel
  (``kernels/flash_attention``) on a CUDA tensor, its plain version on a
  CPU tensor.  The TPU tile knobs are passed through and do not change the
  output.

Decode attends a 1-token query against a KV cache (layout knob bshd/bhsd,
dtype knob bf16/f32/int8-sim) in plain torch, as the reference computes it
outside any kernel.  The port updates caches in place, where the reference
returns new arrays: the returned caches are the buffers it was given.
The reference's cross-attention and no-rope options (``kv_override``,
``cross``, ``use_rope``) and query ``offset`` serve only whisper and are
not ported (ROADMAP queue A, item 14b).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import common
from repro_torch.models.common import dense_apply, dense_init
from repro_torch.models.config import ModelConfig
from repro_torch.models.rotary import apply_rope
from repro_torch.runconfig import RunConfig

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
         stack: int = 0):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    kw = dict(dtype=dtype, stack=stack)
    return {
        "q": dense_init(gen, d, qd, bias=cfg.qkv_bias, **kw),
        "k": dense_init(gen, d, kvd, bias=cfg.qkv_bias, **kw),
        "v": dense_init(gen, d, kvd, bias=cfg.qkv_bias, **kw),
        "o": dense_init(gen, qd, d, scale=1.0 / math.sqrt(2 * cfg.n_layers),
                        **kw),
    }


# ---------------------------------------------------------------------------
# core softmax attention paths
# ---------------------------------------------------------------------------

def _causal_mask(sq: int, sk: int, window: Optional[int], device):
    """[sq, sk] boolean mask: key j visible to query i when j <= i (and
    j > i - window)."""
    qi = torch.arange(sq, device=device)[:, None]
    ki = torch.arange(sk, device=device)[None, :]
    m = ki <= qi
    if window is not None:
        m &= ki > (qi - window)
    return m


def reference_attention(q, k, v, *, causal: bool, window: Optional[int],
                        softcap: Optional[float]):
    """q [B,Sq,H,D], k/v [B,Sk,Kh,D] -> [B,Sq,H,D].  Materializes scores.

    Scores accumulate in float32 (exact products of the operands, as the
    reference's ``preferred_element_type``); the probabilities are rounded
    to v's dtype before the value product, as in the reference."""
    B, Sq, H, D = q.shape
    Kh = k.shape[2]
    rep = H // Kh
    kr = torch.repeat_interleave(k, rep, dim=2)
    vr = torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float())
    scores = scores / math.sqrt(D)
    scores = common.softcap(scores, softcap)
    if causal or window is not None:
        # a window without causal still masks causally, as in the reference
        m = _causal_mask(Sq, k.shape[1], window, q.device)
        scores = scores.masked_fill(~m[None, None], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(vr.dtype).float(),
                       vr.float())
    return out.to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool, window: Optional[int],
                      softcap: Optional[float], chunk: int):
    """Online softmax over KV chunks; O(Sq·chunk) live memory.

    Equivalent to reference_attention (tests assert allclose); a Python
    loop takes the place of the reference's ``lax.scan``."""
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    rep = H // Kh
    chunk = min(chunk, Sk)
    qf = q.float() / math.sqrt(D)
    qidx = torch.arange(Sq, device=q.device)
    m_prev = torch.full((B, H, Sq), NEG_INF, device=q.device)
    l_prev = torch.zeros((B, H, Sq), device=q.device)
    acc = torch.zeros((B, Sq, H, D), device=q.device)
    for c0 in range(0, Sk, chunk):
        kr = torch.repeat_interleave(k[:, c0:c0 + chunk], rep, dim=2)
        vr = torch.repeat_interleave(v[:, c0:c0 + chunk], rep, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kr.float())
        s = common.softcap(s, softcap)
        kidx = c0 + torch.arange(kr.shape[1], device=q.device)
        neg = torch.zeros((Sq, kr.shape[1]), device=q.device)
        if causal:
            neg = neg + torch.where(kidx[None, :] <= qidx[:, None], 0.0,
                                    NEG_INF)
        if window is not None:
            neg = neg + torch.where(kidx[None, :] > (qidx[:, None] - window),
                                    0.0, NEG_INF)
        s = s + torch.clamp(neg, min=NEG_INF)[None, None]
        m_new = torch.maximum(m_prev, s.amax(dim=-1))
        alpha = torch.exp(m_prev - m_new)
        p = torch.exp(s - m_new[..., None])
        l_prev = l_prev * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, vr.float())
        acc = acc * alpha.transpose(1, 2)[..., None] + pv
        m_prev = m_new
    out = acc / torch.clamp(l_prev, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def flash_attention_dispatch(q, k, v, *, causal, window, softcap,
                             rc: RunConfig):
    """The flash kernel: on a CUDA tensor it launches the CUDA kernel (or
    raises); on a CPU tensor it computes the kernel's plain version.

    The kernel runs its route's default tiles: ``rc.flash_block_q``/
    ``flash_block_k`` are the TPU kernel's tile knobs (multiples of 128
    up to 2048), which the card's kernels have no counterpart of, so they
    are not passed (the card's own tiles are ``kernels.autotune``'s)."""
    return flash_ops.flash_attention(
        q, k, v, causal=causal, window=window, softcap=softcap)


# ---------------------------------------------------------------------------
# layer-level apply (projections + rope + attention + output proj)
# ---------------------------------------------------------------------------

def apply(params, x, positions, cfg: ModelConfig, rc: RunConfig, *,
          causal: bool = True, window: Optional[int] = None):
    """Full-sequence attention (train / prefill).

    x [B, S, d_model]; positions [B, S] (or [3,B,S] for M-RoPE).
    """
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    red = common.reduce_dtype(rc)
    q = dense_apply(params["q"], x, preferred=red) \
        .reshape(B, S, cfg.n_heads, hd)
    k = dense_apply(params["k"], x, preferred=red) \
        .reshape(B, S, cfg.n_kv_heads, hd)
    v = dense_apply(params["v"], x, preferred=red) \
        .reshape(B, S, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)

    impl = rc.attention_impl
    if impl == "reference":
        out = reference_attention(q, k, v, causal=causal, window=window,
                                  softcap=cfg.logit_softcap)
    elif impl == "chunked":
        out = chunked_attention(q, k, v, causal=causal, window=window,
                                softcap=cfg.logit_softcap,
                                chunk=rc.chunk_size_k)
    elif impl == "flash":
        out = flash_attention_dispatch(q, k, v, causal=causal, window=window,
                                       softcap=cfg.logit_softcap, rc=rc)
    else:
        raise ValueError(f"unknown attention_impl {impl!r}")

    out = out.reshape(B, S, cfg.q_dim)
    return dense_apply(params["o"], out, preferred=red)


def project_kv(params, x, positions, cfg: ModelConfig):
    """Project and rotate K/V for the cache fill."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    k = dense_apply(params["k"], x).reshape(B, S, cfg.n_kv_heads, hd)
    v = dense_apply(params["v"], x).reshape(B, S, cfg.n_kv_heads, hd)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return k, v


# ---------------------------------------------------------------------------
# decode step with KV cache
# ---------------------------------------------------------------------------

def decode_apply(params, x, cache_k, cache_v, pos, cfg: ModelConfig,
                 rc: RunConfig, *, window: Optional[int] = None):
    """One-token decode.

    x        [B, 1, d_model]
    cache_k/v: layout per rc.kv_layout —
               bshd: [B, S_max, Kh, D]; bhsd: [B, Kh, S_max, D]
    pos      int scalar OR [B] vector — tokens already in each cache row
             (continuous batching runs every slot at its own position).
    Returns (out [B,1,d_model], cache_k, cache_v); the caches are updated
    in place.
    """
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    pos = torch.as_tensor(pos, device=x.device)
    pos_vec = pos.reshape(-1).expand(B) if pos.dim() <= 1 else pos
    q = dense_apply(params["q"], x).reshape(B, 1, cfg.n_heads, hd)
    positions = pos_vec[:, None]
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k_new = dense_apply(params["k"], x).reshape(B, 1, cfg.n_kv_heads, hd)
    v_new = dense_apply(params["v"], x).reshape(B, 1, cfg.n_kv_heads, hd)
    k_new = apply_rope(k_new, positions, cfg.rope_theta, cfg.mrope_sections)
    _cache_insert(cache_k, k_new, pos_vec, rc)
    _cache_insert(cache_v, v_new, pos_vec, rc)
    kv_len = pos_vec + 1                                  # [B]

    k = _cache_read(cache_k, rc)           # [B, S_max, Kh, D] bf16/f32
    v = _cache_read(cache_v, rc)
    S_max = k.shape[1]

    rep = cfg.n_heads // cfg.n_kv_heads
    kr = torch.repeat_interleave(k, rep, dim=2)
    vr = torch.repeat_interleave(v, rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) \
        / math.sqrt(hd)
    s = common.softcap(s, cfg.logit_softcap)
    kidx = torch.arange(S_max, device=x.device)
    m = kidx[None, :] < kv_len[:, None]                   # [B, S_max]
    if window is not None:
        m &= kidx[None, :] > (kv_len[:, None] - 1 - window)
    s = s.masked_fill(~m[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(vr.dtype).float(),
                       vr.float())
    out = out.to(x.dtype).reshape(B, 1, cfg.q_dim)
    out = dense_apply(params["o"], out, preferred=common.reduce_dtype(rc))
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# KV cache helpers (layout + dtype knobs)
# ---------------------------------------------------------------------------

def init_cache(batch: int, s_max: int, cfg: ModelConfig, rc: RunConfig, *,
               device=None, stack: int = 0):
    """One layer's (k, v) cache buffers (zeros); ``stack`` > 0 adds a
    leading ``[stack]`` axis, one cache per pattern group."""
    if rc.kv_layout == "bhsd":
        shape = (batch, cfg.n_kv_heads, s_max, cfg.resolved_head_dim)
    else:
        shape = (batch, s_max, cfg.n_kv_heads, cfg.resolved_head_dim)
    shape = ((stack,) if stack else ()) + shape
    dt = common.dtype_of(rc.kv_cache_dtype)
    return (torch.zeros(shape, dtype=dt, device=device),
            torch.zeros(shape, dtype=dt, device=device))


_INT8_SCALE = 127.0 / 8.0   # static symmetric scale for simulated int8 KV


def _quantize(x):
    return torch.clamp(torch.round(x.float() * _INT8_SCALE),
                       -127, 127).to(torch.int8)


def _dequantize(x):
    return (x.float() / _INT8_SCALE).to(torch.bfloat16)


def _cache_insert(cache, new, pos, rc: RunConfig):
    """Write new [B,1,Kh,D] at per-row position pos [B], in place.

    A position past the end is clamped to the last row, as the
    reference's ``dynamic_update_slice`` clamps its start index (idle
    engine slots keep advancing until they are recycled)."""
    if cache.dtype == torch.int8:
        new = _quantize(new)
    else:
        new = new.to(cache.dtype)
    B = cache.shape[0]
    seq_axis = 2 if rc.kv_layout == "bhsd" else 1
    rows = torch.arange(B, device=cache.device)
    at = torch.clamp(pos.to(cache.device).reshape(-1).expand(B),
                     0, cache.shape[seq_axis] - 1)
    if rc.kv_layout == "bhsd":
        cache[rows, :, at] = new[:, 0]          # [B, Kh, D]
    else:
        cache[rows, at] = new[:, 0]
    return cache


def _cache_read(cache, rc: RunConfig):
    """Return cache as [B, S_max, Kh, D] in a compute dtype."""
    x = cache
    if rc.kv_layout == "bhsd":
        x = x.transpose(1, 2)
    if x.dtype == torch.int8:
        x = _dequantize(x)
    return x


def fill_cache(cache, kv, rc: RunConfig):
    """Bulk-fill a cache prefix with prefill K/V [B, S, Kh, D], in place."""
    if cache.dtype == torch.int8:
        kv = _quantize(kv)
    else:
        kv = kv.to(cache.dtype)
    S = kv.shape[1]
    if rc.kv_layout == "bhsd":
        cache[:, :, :S] = kv.transpose(1, 2)
    else:
        cache[:, :S] = kv
    return cache

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
Whisper's options are the reference's: ``kv_override`` (pre-projected
cross-attention K/V), ``cross`` / ``cross_len`` (decode against the
encoder memory, no cache update), ``use_rope=False`` and the query
``offset`` of the masks.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import common
from repro_torch.models.common import dense_apply, dense_axes, dense_init
from repro_torch.models.config import ModelConfig
from repro_torch.models.rotary import apply_rope
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import (WHISPER_ITEM, ambient_mesh,
                                           compute_range)
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


def axes(cfg: ModelConfig):
    b = cfg.qkv_bias
    return {
        "q": dense_axes("qkv_in", "heads", bias=b),
        "k": dense_axes("qkv_in", "kv_heads", bias=b),
        "v": dense_axes("qkv_in", "kv_heads", bias=b),
        "o": dense_axes("heads", "o_out"),
    }


def cache_axes(rc: RunConfig):
    if rc.kv_layout == "bhsd":
        ax = ("batch", "kv_heads", "kv_seq", "head_dim")
    else:
        ax = ("batch", "kv_seq", "kv_heads", "head_dim")
    return ax, ax


# ---------------------------------------------------------------------------
# core softmax attention paths
# ---------------------------------------------------------------------------

def _causal_mask(sq: int, sk: int, window: Optional[int], device,
                 offset: int = 0):
    """[sq, sk] boolean mask: key j visible to query i when j <= i + offset
    (and j > i + offset - window).  ``offset`` = absolute position of query
    row 0 minus that of key column 0 (0 for self-attention over the same
    range)."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    ki = torch.arange(sk, device=device)[None, :]
    m = ki <= qi
    if window is not None:
        m &= ki > (qi - window)
    return m


def reference_attention(q, k, v, *, causal: bool, window: Optional[int],
                        softcap: Optional[float], offset: int = 0):
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
        m = _causal_mask(Sq, k.shape[1], window, q.device, offset)
        scores = scores.masked_fill(~m[None, None], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(vr.dtype).float(),
                       vr.float())
    return out.to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool, window: Optional[int],
                      softcap: Optional[float], chunk: int, offset: int = 0):
    """Online softmax over KV chunks; O(Sq·chunk) live memory.

    Equivalent to reference_attention (tests assert allclose); a Python
    loop takes the place of the reference's ``lax.scan``."""
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    rep = H // Kh
    chunk = min(chunk, Sk)
    qf = q.float() / math.sqrt(D)
    qidx = torch.arange(Sq, device=q.device) + offset
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
    are not passed (the card's own tiles are ``kernels.autotune``'s).

    The kernel takes q, k and v of one dtype.  Cross-attention K/V read
    from a cache may differ from q (a dequantized int8-sim cache is bf16):
    all three are promoted to the wider type, as the reference's float32
    arithmetic reads them, and the output is cast back to q's dtype."""
    if k.dtype != q.dtype or v.dtype != q.dtype:
        wide = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                   v.dtype)
        return flash_ops.flash_attention(
            q.to(wide), k.to(wide), v.to(wide), causal=causal,
            window=window, softcap=softcap).to(q.dtype)
    return flash_ops.flash_attention(
        q, k, v, causal=causal, window=window, softcap=softcap)


# ---------------------------------------------------------------------------
# layer-level apply (projections + rope + attention + output proj)
# ---------------------------------------------------------------------------

def apply(params, x, positions, cfg: ModelConfig, rc: RunConfig, *,
          causal: bool = True, window: Optional[int] = None,
          kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
          use_rope: bool = True):
    """Full-sequence attention (train / prefill).

    x [B, S, d_model]; positions [B, S] (or [3,B,S] for M-RoPE).
    kv_override: (k, v) already-projected [B, Sk, Kh, D] tensors for
    cross-attention; the flash kernel reads them through their strides,
    so a view TMA cannot read raises (the caller passes contiguous ones).
    """
    tp = _tensor_parallel(cfg, rc)
    if tp is not None:
        if kv_override is not None:
            raise ValueError("cross-attention under tensor parallelism is "
                             f"not implemented: {WHISPER_ITEM}")
        return _apply_tp(params, x, positions, cfg, rc, tp, causal=causal,
                         window=window, use_rope=use_rope)
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    red = common.reduce_dtype(rc)
    q = dense_apply(params["q"], x, preferred=red) \
        .reshape(B, S, cfg.n_heads, hd)
    if kv_override is None:
        k = dense_apply(params["k"], x, preferred=red) \
            .reshape(B, S, cfg.n_kv_heads, hd)
        v = dense_apply(params["v"], x, preferred=red) \
            .reshape(B, S, cfg.n_kv_heads, hd)
        if use_rope:
            k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        k, v = kv_override
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)

    out = _attend(q, k, v, cfg, rc, causal=causal, window=window)
    out = out.reshape(B, S, cfg.q_dim)
    return dense_apply(params["o"], out, preferred=red)


def _attend(q, k, v, cfg: ModelConfig, rc: RunConfig, *, causal, window):
    impl = rc.attention_impl
    if impl == "reference":
        return reference_attention(q, k, v, causal=causal, window=window,
                                   softcap=cfg.logit_softcap)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 softcap=cfg.logit_softcap,
                                 chunk=rc.chunk_size_k)
    if impl == "flash":
        return flash_attention_dispatch(q, k, v, causal=causal,
                                        window=window,
                                        softcap=cfg.logit_softcap, rc=rc)
    raise ValueError(f"unknown attention_impl {impl!r}")


# ---------------------------------------------------------------------------
# tensor parallelism over heads
# ---------------------------------------------------------------------------

def _tensor_parallel(cfg: ModelConfig, rc: RunConfig):
    """(mesh, q columns, kv columns) of this rank when the model axis
    splits the q projection's columns (the reference's guard: ``q_dim``
    divides by the axis), else None.  The kv columns are None when
    ``kv_dim`` does not divide (the k/v weights are then whole)."""
    mesh = ambient_mesh()
    if mesh is None:
        return None
    d = cfg.d_model
    q = compute_range(("qkv_in", "heads"), (d, cfg.q_dim), 1, rc.shard,
                      mesh)
    if q is None:
        return None
    kv = compute_range(("qkv_in", "kv_heads"), (d, cfg.kv_dim), 1,
                       rc.shard, mesh)
    return mesh, q, kv


def _local_kv(p, x, col, cols, heads, B, S, hd, red, mesh):
    """K or V for kv heads [k_lo, k_hi) = ``heads`` on this rank, from
    the weight's storage block (``cols``, None when whole).

    Storage and compute differ where a rank's q heads need kv heads it
    does not hold whole (the reference's guard splits ``kv_dim``, not
    heads): the columns are then gathered over the model axis.  A column
    block reads ``col()``, the block input under Megatron's f.  A whole
    weight reads ``x`` itself and gives a replicated projection, whose
    rank-local use sums the projection's gradient over the model axis
    (``copy_to``), so its weight gradient and its input gradient are
    whole on every rank."""
    k_lo, k_hi = heads
    if cols is None:
        y = collectives.copy_to(dense_apply(p, x, preferred=red), "model",
                                mesh, red)
        base = 0
    else:
        y = dense_apply(p, col(), preferred=red)
        base = cols[0]
        if not (cols[0] <= k_lo * hd and k_hi * hd <= cols[1]):
            y = collectives.all_gather(y, 2, ("model",), mesh,
                                       sum_axes=("model",))
            base = 0
    y = y[..., k_lo * hd - base:k_hi * hd - base]
    return y.reshape(B, S, k_hi - k_lo, hd)


def _apply_tp(params, x, positions, cfg: ModelConfig, rc: RunConfig, tp, *,
              causal: bool, window: Optional[int], use_rope: bool):
    """``apply`` with the heads split over the model axis (Megatron).

    Storage: this rank holds q columns [c0, c1) and the o rows alike (and
    k/v columns when ``kv_dim`` divides).  Compute: the rank attends
    with the q heads its columns touch, [c0 // hd, ceil(c1 / hd)) (the q
    columns gathered first when a head is cut), and the kv heads those
    need; its block of the output columns enters the row-parallel o
    projection, whose partial sums are reduced over the model axis.  The
    column blocks read the input under Megatron's f
    (``common.column_input``)."""
    mesh, (c0, c1), kv_cols = tp
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    red = common.reduce_dtype(rc)
    rep = cfg.n_heads // cfg.n_kv_heads
    h_lo, h_hi = c0 // hd, -(-c1 // hd)
    col = common.column_input(x, red, mesh)
    q = dense_apply(params["q"], col(), preferred=red)
    if c0 % hd or c1 % hd:
        q = collectives.all_gather(q, 2, ("model",), mesh,
                                   sum_axes=("model",))
        q = q[..., h_lo * hd:h_hi * hd]
    q = q.reshape(B, S, h_hi - h_lo, hd)
    kv_heads = (h_lo // rep, (h_hi - 1) // rep + 1)
    k = _local_kv(params["k"], x, col, kv_cols, kv_heads, B, S, hd, red,
                  mesh)
    v = _local_kv(params["v"], x, col, kv_cols, kv_heads, B, S, hd, red,
                  mesh)
    if use_rope:
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    if h_lo % rep or (h_hi - h_lo) % rep:
        # local q head i no longer reads kv head i // rep: one kv head per
        # q head
        idx = torch.tensor([h // rep - kv_heads[0]
                            for h in range(h_lo, h_hi)], device=x.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    out = _attend(q, k, v, cfg, rc, causal=causal, window=window)
    out = out.reshape(B, S, (h_hi - h_lo) * hd)
    out = out[..., c0 - h_lo * hd:c1 - h_lo * hd]
    return dense_apply(params["o"], out, preferred=red, row_parallel=True)


def project_kv(params, x, positions, cfg: ModelConfig, *,
               use_rope: bool = True):
    """Project (and rotate) K/V for the cache fill / cross-attention
    memory."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    k = dense_apply(params["k"], x).reshape(B, S, cfg.n_kv_heads, hd)
    v = dense_apply(params["v"], x).reshape(B, S, cfg.n_kv_heads, hd)
    if use_rope:
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return k, v


# ---------------------------------------------------------------------------
# decode step with KV cache
# ---------------------------------------------------------------------------

def decode_apply(params, x, cache_k, cache_v, pos, cfg: ModelConfig,
                 rc: RunConfig, *, window: Optional[int] = None,
                 cross: bool = False, cross_len: Optional[int] = None,
                 use_rope: bool = True):
    """One-token decode.

    x        [B, 1, d_model]
    cache_k/v: layout per rc.kv_layout —
               bshd: [B, S_max, Kh, D]; bhsd: [B, Kh, S_max, D]
    pos      int scalar OR [B] vector — tokens already in each cache row
             (continuous batching runs every slot at its own position).
    cross    : cross-attention (the cache holds the encoder memory, of
               which the first ``cross_len`` rows are visible; no update).
    Returns (out [B,1,d_model], cache_k, cache_v); the caches are updated
    in place.
    """
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    pos = torch.as_tensor(pos, device=x.device)
    pos_vec = pos.reshape(-1).expand(B) if pos.dim() <= 1 else pos
    q = dense_apply(params["q"], x).reshape(B, 1, cfg.n_heads, hd)
    positions = pos_vec[:, None]
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    if not cross:
        k_new = dense_apply(params["k"], x).reshape(B, 1, cfg.n_kv_heads, hd)
        v_new = dense_apply(params["v"], x).reshape(B, 1, cfg.n_kv_heads, hd)
        if use_rope:
            k_new = apply_rope(k_new, positions, cfg.rope_theta,
                               cfg.mrope_sections)
        _cache_insert(cache_k, k_new, pos_vec, rc)
        _cache_insert(cache_v, v_new, pos_vec, rc)
        kv_len = pos_vec + 1                              # [B]
    else:
        kv_len = torch.full((B,), int(cross_len), device=x.device)

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
    if window is not None and not cross:
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


def read_cache_full(cache, rc: RunConfig):
    """Whole cache as [B, S, Kh, D] in compute dtype (cross-attention
    memory): under ``kv_layout="bhsd"`` a transposed view, an int8-sim
    cache dequantized to bf16."""
    return _cache_read(cache, rc)


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

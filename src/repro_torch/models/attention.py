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
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import common
from repro_torch.models.common import dense_apply, dense_axes, dense_init
from repro_torch.models.config import ModelConfig
from repro_torch.models.rotary import apply_rope
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import (WHISPER_ITEM, Placement,
                                           ambient_mesh, compute_range,
                                           logical_to_spec, seq_block)
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
          use_rope: bool = True, seq_parallel: bool = False):
    """Full-sequence attention (train / prefill).

    x [B, S, d_model]; positions [B, S] (or [3,B,S] for M-RoPE).
    kv_override: (k, v) already-projected [B, Sk, Kh, D] tensors for
    cross-attention; the flash kernel reads them through their strides,
    so a view TMA cannot read raises (the caller passes contiguous ones).
    With ``seq_parallel`` (on a mesh) ``x`` is this rank's block of the
    sequence [B, S/M, d_model] and so is the result; the positions are
    whole, as they meet the gathered sequence.  Where the model axis does
    not split the heads, every rank attends over the gathered sequence
    with the weights under ``common.replicated`` and its block of the
    attention's output enters the o projection.
    """
    tp = _tensor_parallel(cfg, rc)
    if tp is not None:
        if kv_override is not None:
            raise ValueError("cross-attention under tensor parallelism is "
                             f"not implemented: {WHISPER_ITEM}")
        return _apply_tp(params, x, positions, cfg, rc, tp, causal=causal,
                         window=window, use_rope=use_rope,
                         seq_parallel=seq_parallel)
    red = common.reduce_dtype(rc)
    if seq_parallel:
        mesh = ambient_mesh()
        params = common.replicated(params, mesh)
        x = collectives.gather_seq(x, mesh, red)
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
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
    if seq_parallel:
        out = seq_block(out, mesh)
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


def _local_kv(p, x, col, cols, heads, B, S, hd, red, mesh, seq_parallel):
    """K or V for kv heads [k_lo, k_hi) = ``heads`` on this rank, from
    the weight's storage block (``cols``, None when whole).

    Storage and compute differ where a rank's q heads need kv heads it
    does not hold whole (the reference's guard splits ``kv_dim``, not
    heads): the columns are then gathered over the model axis.  A column
    block reads ``col()``, the block input under Megatron's f (the
    gathered sequence under ``seq_parallel``).  A whole weight reads
    ``x`` itself and gives a replicated projection, whose rank-local use
    sums the projection's gradient over the model axis (``copy_to``), so
    its weight gradient and its input gradient are whole on every rank;
    under ``seq_parallel`` it reads the gathered sequence instead, with
    the weight under ``common.replicated`` (the gather's backward sums
    the input's gradient)."""
    k_lo, k_hi = heads
    if cols is None and seq_parallel:
        y = dense_apply(common.replicated(p, mesh), col(), preferred=red)
        base = 0
    elif cols is None:
        y = collectives.copy_to(dense_apply(p, x, preferred=red), "model",
                                mesh, red)
        base = 0
    else:
        y = dense_apply(p, col(), preferred=red)
        base = cols[0]
        if not (cols[0] <= k_lo * hd and k_hi * hd <= cols[1]):
            # the gather lays the columns out major (its dimension 0):
            # the heads taken from it are made contiguous again
            y = collectives.all_gather(y, 2, ("model",), mesh,
                                       sum_axes=("model",))
            y = y[..., k_lo * hd:k_hi * hd].contiguous()
            return y.reshape(B, S, k_hi - k_lo, hd)
    y = y[..., k_lo * hd - base:k_hi * hd - base]
    return y.reshape(B, S, k_hi - k_lo, hd)


def _apply_tp(params, x, positions, cfg: ModelConfig, rc: RunConfig, tp, *,
              causal: bool, window: Optional[int], use_rope: bool,
              seq_parallel: bool):
    """``apply`` with the heads split over the model axis (Megatron).

    Storage: this rank holds q columns [c0, c1) and the o rows alike (and
    k/v columns when ``kv_dim`` divides).  Compute: the rank attends
    with the q heads its columns touch, [c0 // hd, ceil(c1 / hd)) (the q
    columns gathered first when a head is cut), and the kv heads those
    need; its block of the output columns enters the row-parallel o
    projection, whose partial sums are reduced over the model axis.  The
    column blocks read the input under Megatron's f
    (``common.column_input``).  Under ``seq_parallel`` ``x`` is this
    rank's block of the sequence: the column blocks read the gathered
    sequence, attention runs over all of it at the rank's heads, and the
    o projection's sums are reduce-scattered back to the block."""
    mesh, (c0, c1), kv_cols = tp
    B, S, _ = x.shape
    if seq_parallel:
        S *= mesh.shape["model"]
    hd = cfg.resolved_head_dim
    red = common.reduce_dtype(rc)
    rep = cfg.n_heads // cfg.n_kv_heads
    h_lo, h_hi = c0 // hd, -(-c1 // hd)
    col = common.column_input(x, red, mesh, seq_parallel)
    q = dense_apply(params["q"], col(), preferred=red)
    if c0 % hd or c1 % hd:
        q = collectives.all_gather(q, 2, ("model",), mesh,
                                   sum_axes=("model",))
        q = q[..., h_lo * hd:h_hi * hd].contiguous()
    q = q.reshape(B, S, h_hi - h_lo, hd)
    kv_heads = (h_lo // rep, (h_hi - 1) // rep + 1)
    k = _local_kv(params["k"], x, col, kv_cols, kv_heads, B, S, hd, red,
                  mesh, seq_parallel)
    v = _local_kv(params["v"], x, col, kv_cols, kv_heads, B, S, hd, red,
                  mesh, seq_parallel)
    if use_rope:
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    if kv_heads[1] - kv_heads[0] > 1 and (h_lo % rep or (h_hi - h_lo) % rep):
        # local q head i no longer reads kv head i // rep: one kv head per
        # q head (where they all read one kv head, that head serves them)
        idx = torch.tensor([h // rep - kv_heads[0]
                            for h in range(h_lo, h_hi)], device=x.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    out = _attend(q, k, v, cfg, rc, causal=causal, window=window)
    out = out.reshape(B, S, (h_hi - h_lo) * hd)
    out = out[..., c0 - h_lo * hd:c1 - h_lo * hd]
    return dense_apply(params["o"], out, preferred=red, row_parallel=True,
                       seq_parallel=seq_parallel)


def project_kv(params, x, positions, cfg: ModelConfig, *,
               use_rope: bool = True, rc: Optional[RunConfig] = None,
               heads: Optional[slice] = None, seq_parallel: bool = False):
    """Project (and rotate) K/V for the cache fill / cross-attention
    memory: [B, S, Kh, D].

    On a mesh, with ``heads`` (a cache block's kv heads) and ``rc``, the
    result is those kv heads over the whole sequence, from this rank's
    blocks of the weights (:func:`_kv_block`); under ``seq_parallel``
    ``x`` is this rank's block of the sequence, gathered first."""
    if heads is not None:
        mesh = ambient_mesh()
        if seq_parallel:
            x = collectives.all_gather(x, 1, ("model",), mesh)
        tp = _tensor_parallel(cfg, rc)
        k, v = (_kv_block(params[n], x, tp, heads, cfg) for n in ("k", "v"))
    else:
        B, S, _ = x.shape
        hd = cfg.resolved_head_dim
        k = dense_apply(params["k"], x).reshape(B, S, cfg.n_kv_heads, hd)
        v = dense_apply(params["v"], x).reshape(B, S, cfg.n_kv_heads, hd)
    if use_rope:
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return k, v


def _kv_block(p, x, tp, heads: slice, cfg: ModelConfig):
    """K or V [B, S, heads, D] at kv heads ``heads`` of the whole input
    ``x``, from this rank's block of the weight.  Storage and the cache
    differ where the reference's guard splits ``kv_dim`` over the model
    axis but not the kv heads (yi-6b: 4 kv heads, 512 columns over 16
    ranks): the rank's columns are then a cut head, and the cache, whole
    over the model axis, needs every head, so the columns are
    all-gathered over the model axis."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    cols = None if tp is None else tp[2]
    y = dense_apply(p, x)
    base = 0
    if cols is not None:
        base = cols[0]
        if not (cols[0] <= heads.start * hd and heads.stop * hd <= cols[1]):
            y = collectives.all_gather(y, 2, ("model",), tp[0])
            base = 0
    y = y[..., heads.start * hd - base:heads.stop * hd - base]
    return y.contiguous().reshape(B, S, heads.stop - heads.start, hd)


class CacheBlock(NamedTuple):
    """This rank's block of a layer's KV cache on a mesh (its
    ``Placement``, the reference's ``cache_axes`` under its guard): the
    sequence rows and the kv heads it holds, and the mesh axes the
    sequence is split over (``shard_kv_seq`` where the batch does not
    divide: long_500k's B = 1).  Its batch rows are the rank's serving
    rows (``transformer.serve_rows``)."""
    seq: slice
    heads: slice
    seq_axes: Tuple[str, ...]


def cache_block(cfg: ModelConfig, rc: RunConfig, mesh, batch: int,
                s_max: int) -> CacheBlock:
    """The :class:`CacheBlock` of this rank of ``mesh`` in a cache of the
    global ``batch`` rows and ``s_max`` positions."""
    ax = cache_axes(rc)[0]
    dims = {"batch": batch, "kv_seq": s_max, "kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.resolved_head_dim}
    shape = tuple(dims[a] for a in ax)
    pl = Placement.of(mesh, logical_to_spec(ax, rc.shard.resolve(mesh),
                                            mesh, shape))
    idx = dict(zip(ax, pl.index(shape, mesh.rank)))
    return CacheBlock(idx["kv_seq"], idx["kv_heads"],
                      pl.dim_axes(ax.index("kv_seq")))


# ---------------------------------------------------------------------------
# decode step with KV cache
# ---------------------------------------------------------------------------

def decode_apply(params, x, cache_k, cache_v, pos, cfg: ModelConfig,
                 rc: RunConfig, *, window: Optional[int] = None,
                 cross: bool = False, cross_len: Optional[int] = None,
                 use_rope: bool = True, block: Optional[CacheBlock] = None):
    """One-token decode.

    x        [B, 1, d_model] (on a mesh, this rank's rows)
    cache_k/v: layout per rc.kv_layout —
               bshd: [B, S_max, Kh, D]; bhsd: [B, Kh, S_max, D]
    pos      int scalar OR [B] vector — tokens already in each cache row
             (continuous batching runs every slot at its own position).
    cross    : cross-attention (the cache holds the encoder memory, of
               which the first ``cross_len`` rows are visible; no update).
    block    : on a mesh, the caches' :class:`CacheBlock` (this rank's
               blocks of them); None: the whole caches.
    Returns (out [B,1,d_model], cache_k, cache_v); the caches are updated
    in place.

    The rank's q heads (all of them off tensor parallelism; a cut head
    gathered whole, as in training) and the new token's k / v at the
    cache block's kv heads (``_kv_block``: a few KB gathered over the
    model axis where the cache is whole over it but the k / v columns
    are cut) are rotated at each row's position and the token is written
    into the block that holds that position (under ``shard_kv_seq`` one
    data rank's).  The q heads attend over only the kv heads they read,
    none widened (:func:`_per_kv_head`).  With the sequence split over
    ``block.seq_axes`` each rank scores its rows of the cache, and the
    flash-decode combine makes the softmax whole: one MAX all-reduce of
    the row maxima, then one sum all-reduce of the numerator and the
    denominator, each rank's exponentials taken against the global
    maximum (so the probabilities that meet the values are not
    normalised, as the one-block softmax's are, before a bf16 or int8
    cache rounds them).  The rank's output columns enter the
    row-parallel o projection.
    """
    mesh = ambient_mesh()
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    red = common.reduce_dtype(rc)
    tp = _tensor_parallel(cfg, rc)
    if block is None:
        block = CacheBlock(slice(0, _cache_rows(cache_k, rc)),
                           slice(0, cfg.n_kv_heads), ())
    pos = torch.as_tensor(pos, device=x.device)
    pos_vec = pos.reshape(-1).expand(B) if pos.dim() <= 1 else pos
    positions = pos_vec[:, None]

    def rope(t):
        return apply_rope(t, positions, cfg.rope_theta,
                          cfg.mrope_sections) if use_rope else t
    q = dense_apply(params["q"], x)
    c0, c1 = (0, cfg.q_dim) if tp is None else tp[1]
    h_lo, h_hi = c0 // hd, -(-c1 // hd)
    if c0 % hd or c1 % hd:                      # a cut head, gathered whole
        q = collectives.all_gather(q, 2, ("model",), mesh)[
            ..., h_lo * hd:h_hi * hd]
    q = rope(q.reshape(B, 1, h_hi - h_lo, hd))
    S_c = block.seq.stop - block.seq.start
    n_seq = 1                   # the ranks the cache's sequence spans
    for a in block.seq_axes:
        n_seq *= mesh.shape[a]
    if cross:
        kv_len = torch.full((B,), int(cross_len), device=x.device)
    else:
        k_new = rope(_kv_block(params["k"], x, tp, block.heads, cfg))
        v_new = _kv_block(params["v"], x, tp, block.heads, cfg)
        at = torch.clamp(pos_vec, 0, S_c * n_seq - 1) - block.seq.start
        _cache_insert(cache_k, k_new, at, rc)
        _cache_insert(cache_v, v_new, at, rc)
        kv_len = pos_vec + 1

    rep = cfg.n_heads // cfg.n_kv_heads
    kv_lo, kv_hi = h_lo // rep, (h_hi - 1) // rep + 1
    heads = slice(kv_lo - block.heads.start, kv_hi - block.heads.start)
    k = _cache_read(cache_k, rc, heads)       # [B, S_c, Kn, D] bf16/f32
    v = _cache_read(cache_v, rc, heads)
    s = _per_kv_head(q[:, 0].float(), k.float(), h_lo, rep, kv_lo, True) \
        / math.sqrt(hd)                                   # [B, Hl, S_c]
    s = common.softcap(s, cfg.logit_softcap)
    kidx = block.seq.start + torch.arange(S_c, device=x.device)
    m = kidx[None, :] < kv_len[:, None]                   # [B, S_c]
    if window is not None and not cross:
        m &= kidx[None, :] > (kv_len[:, None] - 1 - window)
    s = s.masked_fill(~m[:, None, :], NEG_INF)
    if n_seq > 1:
        top = collectives.all_reduce(s.amax(dim=-1), block.seq_axes, mesh,
                                     op="max")
        e = torch.exp(s - top[..., None])
        num = _per_kv_head(e.to(v.dtype).float(), v.float(), h_lo, rep,
                           kv_lo, False)                  # [B, Hl, D]
        both = collectives.all_reduce(
            torch.cat([num, e.sum(dim=-1, keepdim=True)], dim=-1),
            block.seq_axes, mesh)
        out = both[..., :hd] / both[..., hd:]
    else:
        p = torch.softmax(s, dim=-1)
        out = _per_kv_head(p.to(v.dtype).float(), v.float(), h_lo, rep,
                           kv_lo, False)
    out = out.to(x.dtype).reshape(B, 1, (h_hi - h_lo) * hd)
    out = out[..., c0 - h_lo * hd:c1 - h_lo * hd]
    return dense_apply(params["o"], out, preferred=red,
                       row_parallel=tp is not None), cache_k, cache_v


def _per_kv_head(a, kv, h_lo: int, rep: int, kv_lo: int, scores: bool):
    """The local q heads [h_lo, h_lo + Hl) against the kv heads they read,
    ``kv`` [B, S, Kn, D] (from kv head ``kv_lo``): with ``scores``, ``a``
    is q [B, Hl, D] and the result the scores [B, Hl, S]; else ``a`` is the
    probabilities [B, Hl, S] and the result [B, Hl, D].  Where every kv
    head serves the same number of local q heads one product reads them
    all (a view of ``a``, no copy of ``kv``); else one product a kv
    head."""
    B, Hl = a.shape[:2]
    Kn = kv.shape[2]
    runs = [(j, max((kv_lo + j) * rep, h_lo) - h_lo,
             min((kv_lo + j + 1) * rep, h_lo + Hl) - h_lo)
            for j in range(Kn)]
    r = Hl // Kn
    if all(lo == j * r and hi - lo == r for j, lo, hi in runs):
        eq = "bjrd,bkjd->bjrk" if scores else "bjrk,bkjd->bjrd"
        return torch.einsum(eq, a.reshape(B, Kn, r, -1), kv) \
            .reshape(B, Hl, -1)
    eq = "bhd,bkd->bhk" if scores else "bhk,bkd->bhd"
    return torch.cat([torch.einsum(eq, a[:, lo:hi], kv[:, :, j])
                      for j, lo, hi in runs], dim=1)


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
    """Write new [B,1,Kh,D] at per-row position pos [B] of this cache
    block, in place.  A row whose position lies outside the block (a
    block of a cache split along the sequence) writes nothing: its row
    keeps what it held (no host synchronisation decides which rows
    write).  The caller clamps a position past the whole cache's end to
    its last row, as the reference's ``dynamic_update_slice`` clamps its
    start index (idle engine slots keep advancing until they are
    recycled)."""
    if cache.dtype == torch.int8:
        new = _quantize(new)
    else:
        new = new.to(cache.dtype)
    B = cache.shape[0]
    rows = torch.arange(B, device=cache.device)
    pos = pos.to(cache.device).reshape(-1).expand(B)
    at = torch.clamp(pos, 0, _cache_rows(cache, rc) - 1)
    inside = (pos >= 0) & (pos < _cache_rows(cache, rc))
    old = cache[rows, :, at] if rc.kv_layout == "bhsd" else cache[rows, at]
    new = torch.where(inside[:, None, None], new[:, 0], old)  # [B, Kh, D]
    if rc.kv_layout == "bhsd":
        cache[rows, :, at] = new
    else:
        cache[rows, at] = new
    return cache


def _cache_rows(cache, rc: RunConfig) -> int:
    """The sequence rows a cache (or a block of one) holds."""
    return cache.shape[2 if rc.kv_layout == "bhsd" else 1]


def _cache_read(cache, rc: RunConfig, heads: slice = slice(None)):
    """Return cache as [B, S_max, Kh, D] in a compute dtype, only its kv
    heads ``heads`` (sliced before an int8-sim cache is dequantized)."""
    x = cache
    if rc.kv_layout == "bhsd":
        x = x[:, heads].transpose(1, 2)
    else:
        x = x[:, :, heads]
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

"""Mamba block in the chunked state-space-dual form (from
``repro.models.ssm``; ``axes`` and ``state_axes`` give the reference's
logical axes).  Autograd differentiates it for training.  On a process
mesh the train step runs it on each rank's block of ``ssm_inner``
(``_apply_tp``).

Mamba-2 / SSD (arXiv:2405.21060): per-head scalar decay, intra-chunk
attention-like products under a decay mask, and an inter-chunk carried
state of shape [heads, N, P].  ``ssm_chunk`` (the chunk length) is a
SAPPHIRE knob.  The reference's ``lax.scan`` over chunks is a Python loop
over chunks here (16 iterations at S 4096, chunk 256).  The sequential
recurrence is kept as the oracle (``ssd_reference``, tests only) and for
single-token decode (``decode_step``, which updates the state it is given
in place, as the attention caches are updated).

There is no kernel on this path: the reference computes it in jnp, the
port in plain torch.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (column_input, dense_apply,
                                       dense_axes, dense_init, inner_split,
                                       norm_apply, norm_init,
                                       regroup_halves, replicated,
                                       replicated_block, rms_norm_split,
                                       row_parallel_psum, trunc_normal)
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import ambient_mesh
from repro_torch.runconfig import RunConfig

HEAD_P = 64          # per-head channel width (mamba-2 default)


def dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_inner, n_heads, state N)."""
    di = cfg.d_inner
    nh = max(1, di // HEAD_P)
    return di, nh, cfg.ssm_state_dim


def init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
         stack: int = 0):
    """The reference's tree; ``a_log`` and ``d_skip`` are float32."""
    di, nh, N = dims(cfg)
    d, dev = cfg.d_model, gen.device
    lead = (stack,) if stack else ()
    kw = dict(dtype=dtype, stack=stack)
    return {
        "in_proj": dense_init(gen, d, 2 * di, **kw),               # x, z
        "conv_w": trunc_normal(gen, lead + (cfg.ssm_conv_width, di), 1.0,
                               dtype, fan_in=cfg.ssm_conv_width),
        "conv_b": torch.zeros(lead + (di,), dtype=dtype, device=dev),
        "bc_proj": dense_init(gen, di, 2 * N, **kw),               # B, C
        "dt_proj": dense_init(gen, di, nh, bias=True, **kw),
        "a_log": torch.zeros(lead + (nh,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones(lead + (nh,), dtype=torch.float32, device=dev),
        "out_norm": norm_init(di, "rmsnorm", dtype, device=dev, stack=stack),
        "out_proj": dense_init(gen, di, d,
                               scale=1.0 / math.sqrt(2 * cfg.n_layers), **kw),
    }


def axes(cfg: ModelConfig):
    return {
        "in_proj": dense_axes("ssm_in", "ssm_inner"),
        "conv_w": (None, "ssm_inner"),
        "conv_b": ("ssm_inner",),
        "bc_proj": dense_axes("ssm_inner", None),
        "dt_proj": dense_axes("ssm_inner", None, bias=True),
        "a_log": (None,),
        "d_skip": (None,),
        "out_norm": {"scale": ("ssm_inner",)},
        "out_proj": dense_axes("ssm_inner", "o_out"),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv1d in float32.  x [B,S,di], w [W,di]."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):   # W is tiny (4): unrolled adds, as the reference
        out = out + xp[:, i: i + S].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


class SsmState(NamedTuple):
    s: torch.Tensor       # [B, H, N, P] carried SSD state (float32)
    conv: torch.Tensor    # [B, W-1, di] conv tail (bf16)


def init_state(batch: int, cfg: ModelConfig, dtype=torch.float32, *,
               device=None, stack: int = 0) -> SsmState:
    """Zero state; ``stack`` > 0 adds a leading ``[stack]`` axis, one state
    per pattern group.  The conv tail is bf16, as in the reference."""
    di, nh, N = dims(cfg)
    lead = (stack,) if stack else ()
    return SsmState(
        s=torch.zeros(lead + (batch, nh, N, di // nh), dtype=dtype,
                      device=device),
        conv=torch.zeros(lead + (batch, cfg.ssm_conv_width - 1, di),
                         dtype=torch.bfloat16, device=device),
    )


def state_axes(cfg: ModelConfig):
    return SsmState(
        s=("batch", None, "ssm_state", None),
        conv=("batch", None, "ssm_inner"),
    )


def _project(params, u, cfg: ModelConfig):
    """Shared front half: in_proj split into x and z.  u [B,S,d]."""
    di, nh, N = dims(cfg)
    xz = dense_apply(params["in_proj"], u)
    x, z = torch.split(xz, di, dim=-1)
    return x, z, di, nh, N, di // nh


def _post(params, y, z, cfg: ModelConfig):
    y = norm_apply(params["out_norm"], y * F.silu(z.float()).to(y.dtype),
                   kind="rmsnorm", eps=cfg.norm_eps)
    return dense_apply(params["out_proj"], y)


def _gates(params, xc, nh):
    """dt (softplus) and per-head log-decay from conv'd activations."""
    dt = F.softplus(dense_apply(params["dt_proj"], xc).float())   # [B,S,H]
    a = -torch.exp(params["a_log"].float())                       # [H] < 0
    return dt, dt * a[None, None, :]                              # <= 0


def _conv_act(params, x):
    """silu of the causal conv, in x's dtype."""
    return F.silu(_causal_conv(x, params["conv_w"], params["conv_b"])
                  .float()).to(x.dtype)


def _chunk(rc: RunConfig, S: int) -> int:
    c = min(rc.ssm_chunk, S)
    if S % c:
        raise ValueError(f"ssm_chunk {rc.ssm_chunk} must divide the "
                         f"sequence length {S} (padded by the caller)")
    return c


def _ssd(xh, dt, log_decay, Bm, Cm, d_skip, c: int):
    """The chunked SSD over heads: xh [B,S,H,P] (the conv'd input's head
    view), dt and log_decay [B,S,H], Bm and Cm [B,S,N], d_skip [H].
    Returns y [B,S,H,P] float32, the D skip added.  The channels of a head
    are independent (only its dt and decay couple them), so any block of
    a head's channels is computed here as a head of its own."""
    B, S, nh, P = xh.shape
    N = Bm.shape[-1]
    xin = xh * dt[..., None].to(xh.dtype)          # dt-scaled input
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                 device=xh.device))
    s = torch.zeros((B, nh, N, P), dtype=torch.float32, device=xh.device)
    ys = []
    for c0 in range(0, S, c):
        xin_i = xin[:, c0:c0 + c].float()                          # [B,c,H,P]
        B_i = Bm[:, c0:c0 + c].float()                             # [B,c,N]
        C_i = Cm[:, c0:c0 + c].float()
        # cumulative log decay within the chunk, inclusive: [B,c,H]
        cum = torch.cumsum(log_decay[:, c0:c0 + c], dim=1)
        # intra-chunk: sc[b,i,j,h] = exp(cum_i - cum_j) (C_i . B_j), j <= i.
        # The hidden entries (j > i) are set to -inf before the exp: their
        # exp(cum_i - cum_j) overflows float32 once a chunk's decay sums
        # past ~88 (at the default chunk of 256 over 512 tokens already),
        # and a where() after the exp, as the reference writes it, passes
        # 0 * inf = NaN to the gradient.  The values are the same
        diff = cum[:, :, None, :] - cum[:, None, :, :]             # [B,i,j,H]
        L = torch.exp(diff.masked_fill(~mask[None, :, :, None], -math.inf))
        cb = torch.einsum("bin,bjn->bij", C_i, B_i)
        y_intra = torch.einsum("bijh,bjhp->bihp", cb[..., None] * L, xin_i)
        # inter-chunk: exp(cum_i) C_i s_prev
        y_inter = torch.einsum("bin,bhnp->bihp", C_i, s) \
            * torch.exp(cum)[..., None]
        # s = exp(total) s_prev + sum_j exp(total - cum_j) B_j x_j
        total = cum[:, -1:, :]                                     # [B,1,H]
        w = torch.exp(total - cum)                                 # [B,c,H]
        s = s * torch.exp(total)[:, 0, :, None, None] + torch.einsum(
            "bjn,bjhp->bhnp", B_i, xin_i * w[..., None])
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)                                       # [B,S,H,P]
    return y + xh.float() * d_skip.float()[None, None, :, None]


def apply(params, u, cfg: ModelConfig, rc: RunConfig,
          seq_parallel: bool = False, gathered=None):
    """Full-sequence chunked SSD.  u [B,S,d] -> [B,S,d].  Raises
    ``ValueError`` where the chunk does not divide S (the reference
    asserts).

    On a mesh whose model axis splits ``ssm_inner`` the block runs on
    this rank's channels (:func:`_apply_tp`); elsewhere every model rank
    runs it whole (``common.replicated_block``).  With ``seq_parallel``
    ``u`` is this rank's block of the sequence and so is the result;
    ``gathered`` is then the whole sequence where the caller has already
    all-gathered it (a prefill, which reads it for the final state too;
    no gradient reaches ``u`` through it)."""
    tp = inner_split(cfg.d_model, cfg.d_inner, rc)
    if tp is not None:
        return _apply_tp(params, u, cfg, rc, tp, seq_parallel, gathered)
    if gathered is not None:
        return collectives.split(_apply(params, gathered, cfg, rc), 1,
                                 "model", ambient_mesh())
    return replicated_block(lambda t: _apply(params, t, cfg, rc), u,
                            ambient_mesh(), seq_parallel)


def _apply(params, u, cfg: ModelConfig, rc: RunConfig):
    """``apply`` on one process (or whole on every model rank)."""
    B, S, _ = u.shape
    c = _chunk(rc, S)
    x, z, di, nh, N, P = _project(params, u, cfg)
    xc = _conv_act(params, x)
    Bm, Cm = torch.split(dense_apply(params["bc_proj"], xc), N, dim=-1)
    dt, log_decay = _gates(params, xc, nh)
    y = _ssd(xc.reshape(B, S, nh, P), dt, log_decay, Bm, Cm,
             params["d_skip"], c)
    return _post(params, y.to(u.dtype).reshape(B, S, di), z, cfg)


def _head_view(lo: int, hi: int, P: int) -> Tuple[int, int, int]:
    """(first head, heads, channels a head) of channels [lo, hi) of heads
    of width P: the whole heads they hold, or, where the model axis cuts
    a head, the one head they lie in, its block of channels taken as a
    head of ``hi - lo`` channels.  Raises ``ValueError`` for a block that
    is neither."""
    c = hi - lo
    if lo % P == 0 and c % P == 0:
        return lo // P, c // P, P
    if P % c == 0 and lo // P == (hi - 1) // P:
        return lo // P, 1, c
    raise ValueError(f"channels [{lo}, {hi}) are neither whole heads of "
                     f"{P} nor one head's block")


def _apply_tp(params, u, cfg: ModelConfig, rc: RunConfig, tp,
              seq_parallel: bool, gathered=None):
    """``apply`` with ``ssm_inner`` split over the model axis: this rank
    holds channels [lo, hi) of the inner width (the conv, the out norm's
    scale, ``bc_proj``'s and ``dt_proj``'s rows, ``out_proj``'s rows) and
    its storage block of ``in_proj``'s ``[x | z]`` columns.

    ``in_proj`` is column-parallel on the block input under Megatron's f
    (the gathered sequence under ``seq_parallel``), and its output is
    regrouped to the rank's x and z channels (``common.regroup_halves``).
    The conv is local to the channels.  ``bc_proj`` and ``dt_proj`` are
    row-parallel and every rank reads its part of their whole result (B
    and C whole, dt at its heads): ``common.row_parallel_psum``.  The SSD
    runs on the rank's heads, or on its channels of a cut head
    (:func:`_head_view`), with its heads of the replicated ``a_log`` and
    ``d_skip`` (under ``common.replicated``: each rank's gradient is its
    heads').  The out norm sums its squares over the model axis
    (``common.rms_norm_split``) and ``out_proj`` is row-parallel, its sums
    reduce-scattered along the sequence under ``seq_parallel``."""
    mesh, lo, hi = tp
    di, nh, N = dims(cfg)
    P = di // nh
    h0, H, Pl = _head_view(lo, hi, P)
    col = column_input(u, torch.float32, mesh, seq_parallel) \
        if gathered is None else (lambda: gathered)
    x, z = regroup_halves(dense_apply(params["in_proj"], col()), mesh)
    B, S, _ = x.shape
    c = _chunk(rc, S)
    xc = _conv_act(params, x)
    Bm, Cm = torch.split(row_parallel_psum(params["bc_proj"], xc), N,
                         dim=-1)
    heads = slice(h0, h0 + H)
    dt = F.softplus(row_parallel_psum(params["dt_proj"], xc)[..., heads]
                    .float())
    rep = replicated({"a_log": params["a_log"],
                      "d_skip": params["d_skip"]}, mesh)
    log_decay = dt * -torch.exp(rep["a_log"][heads].float())[None, None, :]
    y = _ssd(xc.reshape(B, S, H, Pl), dt, log_decay, Bm, Cm,
             rep["d_skip"][heads], c)
    y = y.to(u.dtype).reshape(B, S, hi - lo)
    y = rms_norm_split(params["out_norm"],
                       y * F.silu(z.float()).to(y.dtype), di, mesh,
                       eps=cfg.norm_eps)
    return dense_apply(params["out_proj"], y, row_parallel=True,
                       seq_parallel=seq_parallel)


def ssd_reference(params, u, cfg: ModelConfig):
    """Sequential-recurrence oracle (slow; tests only)."""
    B, S, _ = u.shape
    x, z, di, nh, N, P = _project(params, u, cfg)
    xc = _conv_act(params, x)
    Bm, Cm = torch.split(dense_apply(params["bc_proj"], xc), N, dim=-1)
    dt, log_decay = _gates(params, xc, nh)
    xh = (xc.reshape(B, S, nh, P) * dt[..., None].to(xc.dtype)).float()
    s = torch.zeros((B, nh, N, P), dtype=torch.float32, device=u.device)
    ys = []
    for t in range(S):
        a = torch.exp(log_decay[:, t])                             # [B,H]
        s = s * a[:, :, None, None] + torch.einsum(
            "bn,bhp->bhnp", Bm[:, t].float(), xh[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t].float(), s))
    y = torch.stack(ys, dim=1)                                     # [B,S,H,P]
    # D-skip, same convention as the chunked path (on the head view of xc)
    y = y + xc.reshape(B, S, nh, P).float() \
        * params["d_skip"].float()[None, None, :, None]
    return _post(params, y.to(u.dtype).reshape(B, S, di), z, cfg)


def decode_step(params, u, state: SsmState, cfg: ModelConfig,
                rc: RunConfig):
    """One-token decode.  u [B,1,d] -> (y [B,1,d], state); the state is
    updated in place and returned.  On a mesh whose model axis splits
    ``ssm_inner`` the conv tail is this rank's channels and the SSD state
    whole (:func:`_decode_tp`); elsewhere every rank steps the whole
    block."""
    tp = inner_split(cfg.d_model, cfg.d_inner, rc)
    if tp is not None:
        return _decode_tp(params, u, state, cfg, tp)
    B = u.shape[0]
    x, z, di, nh, N, P = _project(params, u, cfg)
    # conv over (tail ++ current)
    window = torch.cat([state.conv.to(x.dtype), x], dim=1)        # [B,W,di]
    xc = torch.einsum("bwd,wd->bd", window.float(),
                      params["conv_w"].float()) + params["conv_b"].float()
    xc = F.silu(xc).to(x.dtype)[:, None, :]                       # [B,1,di]
    state.conv.copy_(window[:, 1:, :])

    Bm, Cm = torch.split(dense_apply(params["bc_proj"], xc)[:, 0], N, dim=-1)
    dt, log_decay = _gates(params, xc, nh)                         # [B,1,H]
    y = _state_step(params, state, xc, Bm, Cm, dt, log_decay, nh, P)
    return _post(params, y.to(u.dtype).reshape(B, 1, di), z, cfg), state


def _state_step(params, state: SsmState, xc, Bm, Cm, dt, log_decay,
                nh: int, P: int):
    """The SSD state's one-token update (in place) from the whole conv'd
    input ``xc`` [B,1,di], B and C [B,N], dt and the log decay [B,1,H];
    returns y [B,H,P] float32 with the D skip."""
    B = xc.shape[0]
    a = torch.exp(log_decay[:, 0])                                 # [B,H]
    xh = xc.reshape(B, nh, P).float() * dt[:, 0, :, None]
    s = state.s * a[:, :, None, None] + torch.einsum(
        "bn,bhp->bhnp", Bm.float(), xh)
    state.s.copy_(s)
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), s)
    return y + xc.reshape(B, nh, P).float() \
        * params["d_skip"].float()[None, :, None]


def _decode_tp(params, u, state: SsmState, cfg: ModelConfig, tp):
    """``decode_step`` with ``ssm_inner`` split over the model axis: the
    rank's ``[x | z]`` channels (``common.regroup_halves``) and its conv
    tail; B, C and dt whole (``common.row_parallel_psum``).  The SSD
    state is whole on every rank, as the reference keeps it (its ``s``
    has no model axis), and every rank updates it whole from the conv'd
    input gathered over the model axis (B x d_inner in the activation
    dtype: the state itself is never gathered); the rank keeps its
    channels of y, whose out norm sums its squares over the model axis,
    into the row-parallel ``out_proj``."""
    mesh, lo, hi = tp
    di, nh, N = dims(cfg)
    P = di // nh
    B = u.shape[0]
    x, z = regroup_halves(dense_apply(params["in_proj"], u), mesh)
    window = torch.cat([state.conv.to(x.dtype), x], dim=1)
    xc = torch.einsum("bwd,wd->bd", window.float(),
                      params["conv_w"].float()) + params["conv_b"].float()
    xc = F.silu(xc).to(x.dtype)[:, None, :]                       # [B,1,c]
    state.conv.copy_(window[:, 1:, :])
    Bm, Cm = torch.split(row_parallel_psum(params["bc_proj"], xc)[:, 0], N,
                         dim=-1)
    dt = F.softplus(row_parallel_psum(params["dt_proj"], xc).float())
    log_decay = dt * -torch.exp(params["a_log"].float())[None, None, :]
    xw = collectives.all_gather(xc, 2, ("model",), mesh)          # [B,1,di]
    y = _state_step(params, state, xw, Bm, Cm, dt, log_decay, nh, P)
    y = y.reshape(B, 1, di)[..., lo:hi].to(u.dtype)
    y = rms_norm_split(params["out_norm"],
                       y * F.silu(z.float()).to(y.dtype), di, mesh,
                       eps=cfg.norm_eps)
    return dense_apply(params["out_proj"], y, row_parallel=True), state


def final_state(params, u, cfg: ModelConfig, rc: RunConfig) -> SsmState:
    """(s, conv tail) after the whole prompt ``u`` [B,S,d]: the carried
    state from one product over S, the last W-1 inputs of the conv in
    bf16.

    On a mesh whose model axis splits ``ssm_inner`` each rank forms the
    state of its channels (a cut head's block of channels is a head of
    its own to the product, as in :func:`_ssd`) and the state, whole over
    the model axis in the reference's layout, is all-gathered (B x H x N
    x P float32 a layer), not its inputs (the projected sequence, ~1000
    times larger at jamba's prefill_32k); the conv tail stays the rank's
    channels."""
    mesh = ambient_mesh()
    tp = inner_split(cfg.d_model, cfg.d_inner, rc)
    di, nh, N = dims(cfg)
    P = di // nh
    if tp is None:
        x, lo, proj = _project(params, u, cfg)[0], 0, dense_apply
    else:
        x = regroup_halves(dense_apply(params["in_proj"], u), mesh)[0]
        lo, proj = tp[1], row_parallel_psum
    B, S, c = x.shape
    xc = _conv_act(params, x)
    Bm = torch.split(proj(params["bc_proj"], xc), N, dim=-1)[0]
    dt = F.softplus(proj(params["dt_proj"], xc).float())          # [B,S,H]
    log_decay = dt * -torch.exp(params["a_log"].float())[None, None, :]
    cum = torch.cumsum(log_decay, dim=1)                          # [B,S,H]
    w = torch.exp(cum[:, -1:, :] - cum)                           # [B,S,H]
    head = (lo + torch.arange(c, device=x.device)) // P          # [c]
    xh = xc.float() * dt[..., head] * w[..., head]                # [B,S,c]
    s = torch.einsum("bsn,bsc->bnc", Bm.float(), xh)
    if tp is not None:
        s = collectives.all_gather(s, 2, ("model",), mesh)
    s = s.reshape(B, N, nh, P).transpose(1, 2)
    conv_tail = x[:, S - (cfg.ssm_conv_width - 1):, :].to(torch.bfloat16)
    return SsmState(s=s, conv=conv_tail)

"""Mamba block in the chunked state-space-dual form (from
``repro.models.ssm``; ``axes`` and ``state_axes`` give the reference's
logical axes, and the sharded train step refuses the block on a mesh of
more than one rank: its ``ssm_inner`` split is not ported).  Autograd differentiates it for training.

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

from repro_torch.models.common import (dense_apply, dense_axes, dense_init,
                                       norm_apply, norm_init, trunc_normal)
from repro_torch.models.config import ModelConfig
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


def apply(params, u, cfg: ModelConfig, rc: RunConfig):
    """Full-sequence chunked SSD.  u [B,S,d] -> [B,S,d].  Raises
    ``ValueError`` where the chunk does not divide S (the reference
    asserts)."""
    B, S, _ = u.shape
    c = min(rc.ssm_chunk, S)
    if S % c:
        raise ValueError(f"ssm_chunk {rc.ssm_chunk} must divide the "
                         f"sequence length {S} (padded by the caller)")
    x, z, di, nh, N, P = _project(params, u, cfg)
    xc = _conv_act(params, x)
    Bm, Cm = torch.split(dense_apply(params["bc_proj"], xc), N, dim=-1)
    dt, log_decay = _gates(params, xc, nh)

    xh = xc.reshape(B, S, nh, P)
    xin = xh * dt[..., None].to(xh.dtype)          # dt-scaled input
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                 device=u.device))
    s = torch.zeros((B, nh, N, P), dtype=torch.float32, device=u.device)
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
    y = y + xh.float() * params["d_skip"].float()[None, None, :, None]
    return _post(params, y.to(u.dtype).reshape(B, S, di), z, cfg)


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
    updated in place and returned."""
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
    a = torch.exp(log_decay[:, 0])                                 # [B,H]
    xh = xc.reshape(B, nh, P).float() * dt[:, 0, :, None]
    s = state.s * a[:, :, None, None] + torch.einsum(
        "bn,bhp->bhnp", Bm.float(), xh)
    state.s.copy_(s)
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), s)
    y = y + xc.reshape(B, nh, P).float() \
        * params["d_skip"].float()[None, :, None]
    return _post(params, y.to(u.dtype).reshape(B, 1, di), z, cfg), state

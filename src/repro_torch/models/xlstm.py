"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory), from
``repro.models.xlstm`` (the ``*_axes`` functions give the reference's
logical axes; the sharded train step refuses the family on a mesh of
more than one rank: its ``ssm_inner`` split is not ported).  Autograd differentiates it: on the card the mLSTM
sequence pass through its backward kernel (``ops.mlstm_chunk``'s
``autograd.Function``), on CPU tensors through the plain version.

arXiv:2405.04517.  The 1.3B config interleaves 7 mLSTM : 1 sLSTM.

The mLSTM's sequence pass is the stabilised chunkwise form in the
hand-written CUDA kernel (``kernels/mlstm_chunk``) on a CUDA tensor and its
plain version on a CPU tensor; ``mlstm_chunk`` is a SAPPHIRE knob.  The
sequential oracle (``mlstm_reference``) backs the tests and single-token
decode.  sLSTM is a hidden-state recurrence: a plain time loop with
block-diagonal recurrent weights (4 blocks), as the reference's scan.

Recurrence (per head, stabilised):
    C_t = f_t C_{t-1} + i_t v_t k_t^T        (matrix memory  [P, P_k])
    n_t = f_t n_{t-1} + i_t k_t              (normalizer     [P_k])
    m_t = max(log f_t + m_{t-1}, log i_t)    (stabilizer)
    h_t = (C_t q_t) / max(|n_t . q_t|, exp(-m_t))
with f = sigmoid(f~) (log f = -softplus(-f~)) and i = exp(i~) folded into
the stabilised weights.

Parameters take a ``stack`` (the transformer's per-position group axis),
as ``attention.init`` does.  The ``*_decode_step`` functions update the
state they are given in place and return it, as the attention caches are
updated.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops
from repro_torch.kernels.mlstm_chunk.ref import mlstm_sequential
from repro_torch.models.common import (activation, dense_apply, dense_axes,
                                       dense_init, norm_apply, norm_init,
                                       trunc_normal)
from repro_torch.models.config import ModelConfig
from repro_torch.runconfig import RunConfig

NEG_INF = -1e30


def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    di = int(cfg.mlstm_expand * cfg.d_model)
    nh = cfg.n_heads
    return di, nh, di // nh


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
               stack: int = 0):
    di, nh, P = mlstm_dims(cfg)
    d = cfg.d_model
    kw = dict(dtype=dtype, stack=stack)
    gate = dict(bias=True, dtype=torch.float32, stack=stack)
    return {
        "up": dense_init(gen, d, 2 * di, **kw),                # x, z
        "q": dense_init(gen, di, di, **kw),
        "k": dense_init(gen, di, di, **kw),
        "v": dense_init(gen, di, di, **kw),
        "igate": dense_init(gen, di, nh, **gate),
        "fgate": dense_init(gen, di, nh, **gate),
        "out_norm": norm_init(di, "rmsnorm", dtype, device=gen.device,
                              stack=stack),
        "down": dense_init(gen, di, d, scale=1.0 / math.sqrt(2 * cfg.n_layers),
                           **kw),
    }


def mlstm_axes(cfg: ModelConfig):
    return {
        "up": dense_axes("ssm_in", "ssm_inner"),
        "q": dense_axes("ssm_inner", "ssm_inner"),
        "k": dense_axes("ssm_inner", "ssm_inner"),
        "v": dense_axes("ssm_inner", "ssm_inner"),
        "igate": dense_axes("ssm_inner", None, bias=True),
        "fgate": dense_axes("ssm_inner", None, bias=True),
        "out_norm": {"scale": ("ssm_inner",)},
        "down": dense_axes("ssm_inner", "o_out"),
    }


class MlstmState(NamedTuple):
    c: torch.Tensor    # [B, H, P, P]
    n: torch.Tensor    # [B, H, P]
    m: torch.Tensor    # [B, H]


def mlstm_init_state(batch: int, cfg: ModelConfig, *, device,
                     stack: int = 0) -> MlstmState:
    _, nh, P = mlstm_dims(cfg)
    lead = (stack,) if stack else ()
    f32 = dict(dtype=torch.float32, device=device)
    return MlstmState(
        c=torch.zeros(lead + (batch, nh, P, P), **f32),
        n=torch.zeros(lead + (batch, nh, P), **f32),
        m=torch.full(lead + (batch, nh), NEG_INF, **f32),
    )


def mlstm_state_axes(cfg: ModelConfig):
    return MlstmState(c=("batch", None, None, None),
                      n=("batch", None, None),
                      m=("batch", None))


def _mlstm_qkvg(params, u, cfg: ModelConfig):
    """Project inputs.  u [B,S,d] -> q,k,v [B,S,H,P], logi/logf [B,S,H], z."""
    di, nh, P = mlstm_dims(cfg)
    B, S, _ = u.shape
    xz = dense_apply(params["up"], u)
    x, z = torch.split(xz, di, dim=-1)
    q = dense_apply(params["q"], x).reshape(B, S, nh, P)
    k = dense_apply(params["k"], x).reshape(B, S, nh, P) / math.sqrt(P)
    v = dense_apply(params["v"], x).reshape(B, S, nh, P)
    logi = dense_apply(params["igate"], x).float()                 # i~
    logf = -F.softplus(-dense_apply(params["fgate"], x).float())
    return q, k, v, logi, logf, z


def _mlstm_out(params, h, z, u, cfg: ModelConfig):
    """h [B,S,H,P] -> down(rmsnorm(h * silu(z))) [B,S,d]."""
    B, S, _ = u.shape
    h = h.reshape(B, S, -1).to(u.dtype)
    h = norm_apply(params["out_norm"],
                   h * F.silu(z.float()).to(u.dtype),
                   kind="rmsnorm", eps=cfg.norm_eps)
    return dense_apply(params["down"], h)


def mlstm_chunked(params, u, qkvg, cfg: ModelConfig, rc: RunConfig):
    """The sequence pass on projected inputs ``qkvg`` (``_mlstm_qkvg``):
    the chunkwise kernel at ``rc.mlstm_chunk``, then the output gate."""
    q, k, v, logi, logf, z = qkvg
    h = mlstm_ops.mlstm_chunk(q, k, v, logi, logf, chunk=rc.mlstm_chunk)
    return _mlstm_out(params, h, z, u, cfg)


def mlstm_apply(params, u, cfg: ModelConfig, rc: RunConfig):
    """Chunkwise-parallel stabilised mLSTM.  u [B,S,d] -> [B,S,d].

    The chunk recurrence runs in ``ops.mlstm_chunk`` on every device: the
    CUDA kernel on a CUDA tensor, ``ref.mlstm_chunkwise`` (the reference's
    jnp scan body) on a CPU tensor.  The chunk is ``min(rc.mlstm_chunk,
    S)`` and must divide S, as in the reference."""
    return mlstm_chunked(params, u, _mlstm_qkvg(params, u, cfg), cfg, rc)


def mlstm_reference(params, u, cfg: ModelConfig):
    """Sequential stabilised recurrence (oracle)."""
    q, k, v, logi, logf, z = _mlstm_qkvg(params, u, cfg)
    return _mlstm_out(params, mlstm_sequential(q, k, v, logi, logf), z, u,
                      cfg)


def mlstm_decode_step(params, u, state: MlstmState, cfg: ModelConfig,
                      rc: RunConfig):
    """One-token mLSTM decode.  u [B,1,d].  ``state`` is updated in place
    and returned."""
    B = u.shape[0]
    di, nh, P = mlstm_dims(cfg)
    q, k, v, logi, logf, z = _mlstm_qkvg(params, u, cfg)
    qf, kf, vf = (t[:, 0].float() for t in (q, k, v))
    lf_t, li_t = logf[:, 0], logi[:, 0]
    m_new = torch.maximum(lf_t + state.m, li_t)
    fw = torch.exp(lf_t + state.m - m_new)
    iw = torch.exp(li_t - m_new)
    c = state.c.mul_(fw[..., None, None]).add_(
        iw[..., None, None] * torch.einsum("bhp,bhr->bhpr", kf, vf))
    n = state.n.mul_(fw[..., None]).add_(iw[..., None] * kf)
    state.m.copy_(m_new)
    num = torch.einsum("bhp,bhpr->bhr", qf, c)
    den = torch.maximum(torch.abs(torch.einsum("bhp,bhp->bh", n, qf)),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, 1, nh, P)
    return _mlstm_out(params, h, z, u, cfg), state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

N_SLSTM_BLOCKS = 4


def slstm_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
               stack: int = 0):
    d = cfg.d_model
    dp = int(cfg.slstm_proj * d)
    nb = N_SLSTM_BLOCKS
    bs = d // nb
    lead = (stack,) if stack else ()
    return {
        # input weights for 4 gates (i, f, z, o) at once
        "w_in": trunc_normal(gen, lead + (d, 4 * d), 1.0, dtype, fan_in=d),
        # block-diagonal recurrent weights [4, nb, bs, bs]; the reference
        # scales by its leading axis (4)
        "w_rec": trunc_normal(gen, lead + (4, nb, bs, bs), 1.0, dtype,
                              fan_in=4),
        "bias": torch.zeros(lead + (4 * d,), dtype=torch.float32,
                            device=gen.device),
        "out_norm": norm_init(d, "rmsnorm", dtype, device=gen.device,
                              stack=stack),
        "ffn_up": dense_init(gen, d, dp, dtype=dtype, stack=stack),
        "ffn_down": dense_init(gen, dp, d, dtype=dtype, stack=stack,
                               scale=1.0 / math.sqrt(2 * cfg.n_layers)),
    }


def slstm_axes(cfg: ModelConfig):
    return {
        "w_in": ("ssm_in", None),
        "w_rec": (None, None, None, None),
        "bias": (None,),
        "out_norm": {"scale": ("embed",)},
        "ffn_up": dense_axes("ff_in", "ff"),
        "ffn_down": dense_axes("ff", "o_out"),
    }


class SlstmState(NamedTuple):
    c: torch.Tensor    # [B, d]
    n: torch.Tensor    # [B, d]
    h: torch.Tensor    # [B, d]
    m: torch.Tensor    # [B, d]


def slstm_init_state(batch: int, cfg: ModelConfig, *, device,
                     stack: int = 0) -> SlstmState:
    shape = ((stack,) if stack else ()) + (batch, cfg.d_model)
    f32 = dict(dtype=torch.float32, device=device)
    return SlstmState(c=torch.zeros(shape, **f32),
                      n=torch.zeros(shape, **f32),
                      h=torch.zeros(shape, **f32),
                      m=torch.full(shape, NEG_INF, **f32))


def slstm_state_axes(cfg: ModelConfig):
    return SlstmState(c=("batch", "embed"), n=("batch", "embed"),
                      h=("batch", "embed"), m=("batch", "embed"))


def _rec_weight(params):
    """The recurrent weights [4, nb, bs, bs] in float32, laid out for the
    cell's batched product: [nb, bs, 4 bs], block n's four gates side by
    side."""
    w = params["w_rec"].float()
    g, nb, bs, _ = w.shape
    return w.permute(1, 2, 0, 3).reshape(nb, bs, g * bs)


def _slstm_cell(params, x_t, state: SlstmState, cfg: ModelConfig,
                w_rec=None):
    """One sLSTM step.  x_t [B, 4d] (pre-projected input gates).
    ``w_rec`` is ``_rec_weight(params)``, laid out once by a caller that
    loops over time: an einsum against ``params["w_rec"]`` copies the
    permuted weight at every step, and autograd keeps every copy (16 MB a
    step at xlstm-1.3b's width, 64 GB over 4096 steps)."""
    d = cfg.d_model
    nb = N_SLSTM_BLOCKS
    bs = d // nb
    B = state.h.shape[0]
    if w_rec is None:
        w_rec = _rec_weight(params)
    hb = state.h.float().reshape(B, nb, bs).transpose(0, 1)   # [nb, B, bs]
    rec = torch.bmm(hb, w_rec).reshape(nb, B, 4, bs)          # n b g l
    rec = rec.permute(1, 2, 0, 3).reshape(B, 4 * d)           # b (g n l)
    g = x_t.float() + rec + params["bias"]
    gi, gf, gz, go = torch.split(g, d, dim=-1)
    log_f = -F.softplus(-gf)                          # log sigmoid(f)
    m_new = torch.maximum(log_f + state.m, gi)
    i_w = torch.exp(gi - m_new)
    f_w = torch.exp(log_f + state.m - m_new)
    c = f_w * state.c + i_w * torch.tanh(gz)
    n = f_w * state.n + i_w
    h = torch.sigmoid(go) * c / torch.clamp_min(n, 1.0)
    return SlstmState(c=c, n=n, h=h, m=m_new)


def slstm_scan(params, u, cfg: ModelConfig):
    """The time loop.  u [B,S,d] -> (h [B,S,d] float32, final state)."""
    B, S, _ = u.shape
    x_gates = dense_apply({"w": params["w_in"]}, u)      # [B,S,4d]
    w_rec = _rec_weight(params)                          # hoisted
    state = slstm_init_state(B, cfg, device=u.device)
    hs = []
    for t in range(S):
        state = _slstm_cell(params, x_gates[:, t], state, cfg, w_rec)
        hs.append(state.h)
    return torch.stack(hs, dim=1), state


def _slstm_out(params, h, cfg: ModelConfig):
    """rmsnorm, then the gelu FFN (proj factor 4/3)."""
    h = norm_apply(params["out_norm"], h, kind="rmsnorm", eps=cfg.norm_eps)
    return dense_apply(params["ffn_down"], activation("gelu")(
        dense_apply(params["ffn_up"], h).float()).to(h.dtype))


def slstm_apply(params, u, cfg: ModelConfig, rc: RunConfig):
    """Sequence sLSTM via a time loop.  u [B,S,d] -> [B,S,d]."""
    hs, _ = slstm_scan(params, u, cfg)
    return _slstm_out(params, hs.to(u.dtype), cfg)


def slstm_decode_step(params, u, state: SlstmState, cfg: ModelConfig,
                      rc: RunConfig):
    """One-token sLSTM decode.  u [B,1,d].  ``state`` is updated in place
    and returned."""
    x_gates = dense_apply({"w": params["w_in"]}, u)[:, 0]
    new = _slstm_cell(params, x_gates, state, cfg)
    for dst, src in zip(state, new):
        dst.copy_(src)
    return _slstm_out(params, state.h[:, None, :].to(u.dtype), cfg), state

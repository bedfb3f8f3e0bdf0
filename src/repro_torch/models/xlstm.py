"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory), from
``repro.models.xlstm`` (the ``*_axes`` functions give the reference's
logical axes).  Autograd differentiates it: on the card the mLSTM
sequence pass through its backward kernel (``ops.mlstm_chunk``'s
``autograd.Function``), on CPU tensors through the plain version.  On a
process mesh the train step runs the mLSTM on each rank's block of
``ssm_inner`` (``_mlstm_qkvg_tp``) and the sLSTM's recurrence whole on
every model rank, as the reference's layout resolves it
(``slstm_apply``).

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
from repro_torch.models.common import (_matmul_to, activation, column_input,
                                       dense_apply, dense_axes, dense_init,
                                       inner_split, norm_apply, norm_init,
                                       regroup_halves, replicated_block,
                                       rms_norm_split, row_parallel_psum,
                                       trunc_normal)
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import ambient_mesh, compute_range
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


def mlstm_apply(params, u, cfg: ModelConfig, rc: RunConfig,
                seq_parallel: bool = False):
    """Chunkwise-parallel stabilised mLSTM.  u [B,S,d] -> [B,S,d].

    The chunk recurrence runs in ``ops.mlstm_chunk`` on every device: the
    CUDA kernel on a CUDA tensor, ``ref.mlstm_chunkwise`` (the reference's
    jnp scan body) on a CPU tensor.  The chunk is ``min(rc.mlstm_chunk,
    S)`` and must divide S, as in the reference.  On a mesh whose model
    axis splits ``ssm_inner`` the block runs on this rank's channels
    (:func:`_mlstm_apply_tp`); elsewhere every model rank runs it whole
    (``common.replicated_block``).  With ``seq_parallel`` ``u`` is this
    rank's block of the sequence and so is the result."""
    di = mlstm_dims(cfg)[0]
    tp = inner_split(cfg.d_model, di, rc)
    if tp is not None:
        return _mlstm_apply_tp(params, u, cfg, rc, tp, seq_parallel)
    return replicated_block(
        lambda t: mlstm_chunked(params, t, _mlstm_qkvg(params, t, cfg), cfg,
                                rc), u, ambient_mesh(), seq_parallel)


def _head_columns(y, lo: int, hi: int, P: int, mesh):
    """The columns of this rank's heads from its float32 partial product
    ``y`` [B, S, di] of a row-parallel projection into heads: the sum over
    the model axis reduce-scattered to the rank's columns [lo, hi) (its
    backward all-gathers the gradient: every rank's partial product gets
    the whole); where the model axis cuts a head, those columns are
    all-gathered over the model axis again and the head's whole columns
    taken (the gather moves every rank's columns, of which the head needs
    its group's: ROADMAP C)."""
    y = collectives.reduce_scatter(y, 2, "model", mesh)
    if lo % P or (hi - lo) % P:
        h = lo // P
        y = collectives.all_gather(y, 2, ("model",), mesh,
                                   sum_axes=("model",))
        y = y[..., h * P:(h + 1) * P]
    return y


def _mlstm_qkvg_tp(params, u, cfg: ModelConfig, tp, seq_parallel: bool):
    """``_mlstm_qkvg`` on this rank's channels [lo, hi) of ``ssm_inner``:
    q, k, v [B,S,H,P] and the gates [B,S,H] at the heads its channels
    touch (a cut head whole), and z at its channels.

    ``up`` is column-parallel on the block input under Megatron's f (the
    gathered sequence under ``seq_parallel``), its ``[x | z]`` output
    regrouped to the rank's channels (``common.regroup_halves``).  q, k
    and v are tagged ``("ssm_inner", "ssm_inner")``, which the reference's
    guard resolves to ``(model, None)``: the rank holds their rows
    ``[lo, hi)``, so each is row-parallel, its sum reduced to the rank's
    heads (:func:`_head_columns`).  ``igate`` and ``fgate`` (float32) are
    row-parallel into every head, of which each rank reads its own
    (``common.row_parallel_psum``)."""
    mesh, lo, hi = tp
    di, nh, P = mlstm_dims(cfg)
    col = column_input(u, torch.float32, mesh, seq_parallel)
    x, z = regroup_halves(dense_apply(params["up"], col()), mesh)
    B, S, _ = x.shape
    h0, h1 = lo // P, -(-hi // P)

    def heads(name):
        y = _head_columns(_matmul_to(x, params[name]["w"], torch.float32),
                          lo, hi, P, mesh)
        return y.to(x.dtype).contiguous().reshape(B, S, h1 - h0, P)
    q = heads("q")
    k = heads("k") / math.sqrt(P)
    v = heads("v")
    logi = row_parallel_psum(params["igate"], x)[..., h0:h1].float()
    logf = -F.softplus(-row_parallel_psum(params["fgate"], x)[..., h0:h1]
                       .float())
    return q, k, v, logi, logf, z


def _mlstm_apply_tp(params, u, cfg: ModelConfig, rc: RunConfig, tp,
                    seq_parallel: bool, qkvg=None):
    """``mlstm_apply`` with ``ssm_inner`` split over the model axis
    (:func:`_mlstm_qkvg_tp`): the kernel runs on the rank's heads (a cut
    head whole, on every rank of its group: ROADMAP C), the rank keeps its
    channels of h, the out norm sums its squares over the model axis
    (``common.rms_norm_split``) and ``down`` is row-parallel, its sums
    reduce-scattered along the sequence under ``seq_parallel``.  ``qkvg``
    is :func:`_mlstm_qkvg_tp`'s result when the caller has it (prefill
    shares it with the final state)."""
    mesh, lo, hi = tp
    di, nh, P = mlstm_dims(cfg)
    q, k, v, logi, logf, z = qkvg if qkvg is not None else _mlstm_qkvg_tp(
        params, u, cfg, tp, seq_parallel)
    B, S = q.shape[:2]
    h = mlstm_ops.mlstm_chunk(q, k, v, logi, logf, chunk=rc.mlstm_chunk)
    base = (lo // P) * P
    h = h.reshape(B, S, -1)[..., lo - base:hi - base].to(z.dtype)
    h = rms_norm_split(params["out_norm"],
                       h * F.silu(z.float()).to(z.dtype), di, mesh,
                       eps=cfg.norm_eps)
    return dense_apply(params["down"], h, row_parallel=True,
                       seq_parallel=seq_parallel)


def mlstm_reference(params, u, cfg: ModelConfig):
    """Sequential stabilised recurrence (oracle)."""
    q, k, v, logi, logf, z = _mlstm_qkvg(params, u, cfg)
    return _mlstm_out(params, mlstm_sequential(q, k, v, logi, logf), z, u,
                      cfg)


def mlstm_decode_step(params, u, state: MlstmState, cfg: ModelConfig,
                      rc: RunConfig):
    """One-token mLSTM decode.  u [B,1,d].  ``state`` is updated in place
    and returned.  On a mesh whose model axis splits ``ssm_inner`` the
    projections are the rank's and the state whole
    (:func:`_mlstm_decode_tp`)."""
    B = u.shape[0]
    di, nh, P = mlstm_dims(cfg)
    tp = inner_split(cfg.d_model, di, rc)
    if tp is not None:
        return _mlstm_decode_tp(params, u, state, cfg, tp)
    q, k, v, logi, logf, z = _mlstm_qkvg(params, u, cfg)
    h = _mlstm_state_step(state, q, k, v, logi, logf)
    return _mlstm_out(params, h.reshape(B, 1, nh, P), z, u, cfg), state


def _mlstm_state_step(state: MlstmState, q, k, v, logi, logf):
    """The (C, n, m) update of one token (in place) at every head:
    q, k, v [B,1,H,P], the gates [B,1,H]; returns h [B,H,P] float32."""
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
    return num / den[..., None]


def _mlstm_decode_tp(params, u, state: MlstmState, cfg: ModelConfig, tp):
    """``mlstm_decode_step`` with ``ssm_inner`` split over the model
    axis.  The state (C, n, m) has no model axis in the reference's
    layout: every rank updates it whole, from the token's q, k and v at
    every head and the gates, each the row-parallel float32 sum whole on
    every rank (``common.row_parallel_psum``: B x d_inner each); the rank
    keeps its channels of h into the split out norm and the row-parallel
    ``down``."""
    mesh, lo, hi = tp
    di, nh, P = mlstm_dims(cfg)
    B = u.shape[0]
    x, z = regroup_halves(dense_apply(params["up"], u), mesh)

    def every_head(name):
        return row_parallel_psum(params[name], x).reshape(B, 1, nh, P)
    q = every_head("q")
    k = every_head("k") / math.sqrt(P)
    v = every_head("v")
    logi = row_parallel_psum(params["igate"], x).float()
    logf = -F.softplus(-row_parallel_psum(params["fgate"], x).float())
    h = _mlstm_state_step(state, q, k, v, logi, logf)
    h = h.reshape(B, 1, di)[..., lo:hi].to(z.dtype)
    h = rms_norm_split(params["out_norm"],
                       h * F.silu(z.float()).to(z.dtype), di, mesh,
                       eps=cfg.norm_eps)
    return dense_apply(params["down"], h, row_parallel=True), state


def mlstm_final_state(qkvg) -> MlstmState:
    """(C, n, m) after the whole prompt, from one product over S, at the
    heads of the projected inputs ``qkvg`` (``_mlstm_qkvg``'s, or a
    rank's ``_mlstm_qkvg_tp``'s)."""
    q, k, v, logi, logf, z = qkvg
    kf, vf = k.float(), v.float()
    cum = torch.cumsum(logf, dim=1)                         # [B,S,H]
    total = cum[:, -1, :]                                   # [B,H]
    scores = total[:, None, :] - cum + logi                 # [B,S,H]
    m = scores.amax(dim=1)                                  # [B,H]
    wk = torch.exp(scores - m[:, None, :])
    c = torch.einsum("bshp,bshr->bhpr", kf * wk[..., None], vf)
    n = torch.einsum("bshp,bsh->bhp", kf, wk)
    return MlstmState(c=c, n=n, m=m)


def mlstm_prefill(params, u, cfg: ModelConfig, rc: RunConfig,
                  seq_parallel: bool = False):
    """The mLSTM sequence pass and its final state (the projections
    computed once and shared; the reference computes the same
    deterministic values twice).  On a mesh whose model axis splits
    ``ssm_inner`` the rank's heads' state (a cut head's whole, on every
    rank of its group) is all-gathered over the model axis into the
    whole state of the reference's layout (its heads a rank, or one of
    each group's copies of a cut head); elsewhere every rank runs the
    block whole."""
    di, nh, P = mlstm_dims(cfg)
    tp = inner_split(cfg.d_model, di, rc)
    mesh = ambient_mesh()
    if tp is None:
        def whole(t):
            qkvg = _mlstm_qkvg(params, t, cfg)
            return mlstm_chunked(params, t, qkvg, cfg, rc), \
                mlstm_final_state(qkvg)
        if not seq_parallel:
            return whole(u)
        y, st = whole(collectives.all_gather(u, 1, ("model",), mesh))
        return collectives.split(y, 1, "model", mesh), st
    qkvg = _mlstm_qkvg_tp(params, u, cfg, tp, seq_parallel)
    y = _mlstm_apply_tp(params, u, cfg, rc, tp, seq_parallel, qkvg)
    st = mlstm_final_state(qkvg)
    _, lo, hi = tp
    stride = max(P // (hi - lo), 1)          # ranks a cut head spans
    st = MlstmState(*(collectives.all_gather(t, 1, ("model",), mesh)
                      [:, ::stride] for t in st))
    return y, st


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


def _slstm_out(params, h, cfg: ModelConfig, rc: RunConfig = None):
    """rmsnorm, then the gelu FFN (proj factor 4/3).  On a mesh whose
    model axis splits the FFN's width (``ff``, ``rc``'s rules) ``ffn_up``
    is column-parallel under Megatron's f and ``ffn_down`` row-parallel;
    ``h`` is whole on every model rank."""
    h = norm_apply(params["out_norm"], h, kind="rmsnorm", eps=cfg.norm_eps)
    split = rc is not None and compute_range(
        ("ff_in", "ff"), (cfg.d_model, int(cfg.slstm_proj * cfg.d_model)), 1,
        rc.shard) is not None
    if split:
        h = collectives.copy_to(h, "model", ambient_mesh(), torch.float32)
    return dense_apply(params["ffn_down"], activation("gelu")(
        dense_apply(params["ffn_up"], h).float()).to(h.dtype),
        row_parallel=split)


def slstm_apply(params, u, cfg: ModelConfig, rc: RunConfig,
                seq_parallel: bool = False):
    """Sequence sLSTM via a time loop.  u [B,S,d] -> [B,S,d].

    On a mesh the block runs whole on every model rank, as the reference's
    layout resolves it: ``w_in`` is split over the data axes only (FSDP,
    gathered before the block), ``w_rec``, ``bias`` and ``out_norm`` are
    replicated, so every rank computes the whole recurrence from the same
    input and its gradients are whole, summed over the model axis
    nowhere (``common.replicated_block``, which under ``seq_parallel``
    gathers the sequence and keeps this rank's block of the result).
    Where the model axis splits the FFN's ``ff``, the FFN is Megatron's
    column and row pair inside that whole computation."""
    def whole(t):
        hs, _ = slstm_scan(params, t, cfg)
        return _slstm_out(params, hs.to(t.dtype), cfg, rc)
    return replicated_block(whole, u, ambient_mesh(), seq_parallel)


def slstm_decode_step(params, u, state: SlstmState, cfg: ModelConfig,
                      rc: RunConfig):
    """One-token sLSTM decode.  u [B,1,d].  ``state`` is updated in place
    and returned."""
    x_gates = dense_apply({"w": params["w_in"]}, u)[:, 0]
    new = _slstm_cell(params, x_gates, state, cfg)
    for dst, src in zip(state, new):
        dst.copy_(src)
    return _slstm_out(params, state.h[:, None, :].to(u.dtype), cfg,
                      rc), state


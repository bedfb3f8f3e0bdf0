"""Composable decoder LM over the repeating block pattern (from
``repro.models.transformer``).

Parameters keep the reference's layout: each position of the repeating
pattern stacks its leaves over groups (``[n_groups, ...]``), so a JAX
parameter tree carries across unchanged (``Model.params_from_numpy``).
The reference's ``lax.scan`` over groups is a Python loop over groups
here, and its remat policy (``rc.remat_policy``) wraps each group in
``torch.utils.checkpoint`` (non-reentrant; ``_remat_wrap``).

Under an ambient process mesh (``launch.mesh.ProcessMesh``; ``with
mesh:``) the parameters are this rank's blocks of the reference's layout
(``axes``, ``parallel.sharding.shardings_for``) and the forward is the
reference's function computed across the ranks: each layer position's
weights are gathered over the data axes inside the remat group
(``gather_weights_for_compute``, ZeRO-3), attention and the MLP run
Megatron's column- and row-parallel forms over the model axis, the
embedding is a vocab-parallel lookup and the cross entropy a
vocab-parallel one.  Only the dense family is sharded: a MoE, mamba or
xLSTM block on a mesh of more than one rank raises ``ValueError``.  Off a
mesh every path is the one-process one.

Every block kind of the reference is ported: ``ATTN`` (the flash kernel
under ``attention_impl="flash"``), ``MAMBA`` (the chunked SSD of
``models/ssm.py``), and the xLSTM family's ``MLSTM`` and ``SLSTM``
(``models/xlstm.py``), each with a dense MLP, an MoE MLP
(``models/moe.py``) or none.  The MoE auxiliary loss is summed over the
stack by ``forward``; the serving paths drop it, as the reference's do.

Exposes:
    init / axes            — random parameters on a ``torch.Generator``,
                             and their logical sharding axes
    param_shapes           — the parameters as meta tensors (no storage)
    forward                — full-sequence logits and MoE aux loss
    loss_fn                — next-token cross-entropy (+ MoE aux)
    init_decode_state      — per-position stacked caches / states
    prefill                — fill caches from a prompt, return state
    decode_step            — one-token step through the whole stack
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.models import attention, mlp, moe, ssm, xlstm
from repro_torch.models.common import (MetaGenerator, dense_apply,
                                       norm_apply, norm_axes, norm_init,
                                       reduce_dtype, stack_axes, trunc_normal,
                                       tree_map)
from repro_torch.models.config import (ATTN, MAMBA, MLP_DENSE, MLP_MOE,
                                       MLSTM, SLSTM, LayerSpec, ModelConfig)
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import (EP_ITEM, SSM_ITEM, ambient_mesh,
                                           check_layout, compute_range,
                                           gather_weights_for_compute,
                                           shard_activation, world_of)
from repro_torch.runconfig import RunConfig

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _pos_init(gen: torch.Generator, spec: LayerSpec, cfg: ModelConfig,
              dtype):
    G, dev = cfg.n_groups, gen.device
    p: Dict[str, Any] = {"norm1": norm_init(cfg.d_model, cfg.norm, dtype,
                                            device=dev, stack=G)}
    if spec.kind == ATTN:
        p["attn"] = attention.init(gen, cfg, dtype, stack=G)
    elif spec.kind == MAMBA:
        p["mamba"] = ssm.init(gen, cfg, dtype, stack=G)
    elif spec.kind == MLSTM:
        p["mlstm"] = xlstm.mlstm_init(gen, cfg, dtype, stack=G)
    elif spec.kind == SLSTM:
        p["slstm"] = xlstm.slstm_init(gen, cfg, dtype, stack=G)
    else:
        raise ValueError(spec.kind)
    if spec.mlp == MLP_DENSE:
        p["norm2"] = norm_init(cfg.d_model, cfg.norm, dtype, device=dev,
                               stack=G)
        p["mlp"] = mlp.init(gen, cfg, dtype=dtype, stack=G)
    elif spec.mlp == MLP_MOE:
        p["norm2"] = norm_init(cfg.d_model, cfg.norm, dtype, device=dev,
                               stack=G)
        p["moe"] = moe.init(gen, cfg, dtype, stack=G)
    return p


def init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16):
    """Random parameters on ``gen``'s device, in the reference's tree."""
    params: Dict[str, Any] = {
        "embed": {"tok": trunc_normal(gen, (cfg.vocab_size, cfg.d_model),
                                      1.0, dtype)},
        "final_norm": norm_init(cfg.d_model, cfg.norm, dtype,
                                device=gen.device),
        "layers": [_pos_init(gen, spec, cfg, dtype) for spec in cfg.pattern],
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": trunc_normal(
            gen, (cfg.d_model, cfg.vocab_size), 1.0, dtype)}
    return params


def _pos_axes(spec: LayerSpec, cfg: ModelConfig):
    ax: Dict[str, Any] = {}
    if spec.kind == ATTN:
        ax["norm1"] = norm_axes(cfg.norm)
        ax["attn"] = attention.axes(cfg)
    elif spec.kind == MAMBA:
        ax["norm1"] = norm_axes(cfg.norm)
        ax["mamba"] = ssm.axes(cfg)
    elif spec.kind == MLSTM:
        ax["norm1"] = norm_axes(cfg.norm)
        ax["mlstm"] = xlstm.mlstm_axes(cfg)
    elif spec.kind == SLSTM:
        ax["norm1"] = norm_axes(cfg.norm)
        ax["slstm"] = xlstm.slstm_axes(cfg)
    if spec.mlp == MLP_DENSE:
        ax["norm2"] = norm_axes(cfg.norm)
        ax["mlp"] = mlp.axes(cfg)
    elif spec.mlp == MLP_MOE:
        ax["norm2"] = norm_axes(cfg.norm)
        ax["moe"] = moe.axes(cfg)
    return ax


def axes(cfg: ModelConfig):
    """The logical sharding axes of ``init``'s tree (the reference's)."""
    ax: Dict[str, Any] = {
        "embed": {"tok": ("vocab", "emb_embed")},
        "final_norm": norm_axes(cfg.norm),
        "layers": [stack_axes(_pos_axes(spec, cfg)) for spec in cfg.pattern],
    }
    if not cfg.tie_embeddings:
        ax["head"] = {"w": ("emb_embed", "vocab")}
    return ax


@functools.lru_cache(maxsize=None)
def param_shapes(cfg: ModelConfig, dtype=torch.bfloat16):
    """``init``'s tree as meta tensors: every leaf's global shape and
    dtype, no storage (the reference's ``Model.param_shapes``)."""
    return init(MetaGenerator(), cfg, dtype)


def _group(stacked, g: int):
    """One group's slice (views) of a position's stacked leaves."""
    return tree_map(lambda t: t[g], stacked)


# ---------------------------------------------------------------------------
# full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------

def _mixer(spec: LayerSpec, p, h, positions, cfg: ModelConfig,
           rc: RunConfig):
    """The block's sequence mixer on the normed input (full sequence)."""
    if spec.kind == ATTN:
        return attention.apply(p["attn"], h, positions, cfg, rc,
                               causal=True, window=spec.sliding_window)
    if spec.kind == MAMBA:
        return ssm.apply(p["mamba"], h, cfg, rc)
    if spec.kind == MLSTM:
        return xlstm.mlstm_apply(p["mlstm"], h, cfg, rc)
    return xlstm.slstm_apply(p["slstm"], h, cfg, rc)


def _block_mlp(spec: LayerSpec, p, x, cfg: ModelConfig, rc: RunConfig):
    """The block's MLP half (pre-norm residual).  Returns (x, aux): the
    MoE auxiliary loss, 0.0 for a dense MLP or none."""
    aux = 0.0
    if spec.mlp == MLP_DENSE:
        h = norm_apply(p["norm2"], x, kind=cfg.norm, eps=cfg.norm_eps)
        x = x + mlp.apply(p["mlp"], h, cfg, rc)
    elif spec.mlp == MLP_MOE:
        h = norm_apply(p["norm2"], x, kind=cfg.norm, eps=cfg.norm_eps)
        y, aux = moe.apply(p["moe"], h, cfg, rc)
        x = x + y
    return x, aux


def _block_forward(spec: LayerSpec, p, x, positions, cfg: ModelConfig,
                   rc: RunConfig):
    """One block (pre-norm residual).  Returns (x, aux_loss)."""
    h = norm_apply(p["norm1"], x, kind=cfg.norm, eps=cfg.norm_eps)
    x = x + _mixer(spec, p, h, positions, cfg, rc)
    return _block_mlp(spec, p, x, cfg, rc)


# matmuls without batch dims (weight products: ``torch.matmul`` of
# [..., in] by [in, out] dispatches to ``mm``); attention's einsums are
# batched (``bmm``) and recomputed, as under the reference's
# ``checkpoint_dots_with_no_batch_dims``
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return _ckpt.CheckpointPolicy.MUST_SAVE if op in _DOT_OPS \
        else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, rc: RunConfig):
    """The reference's remat policy around one group's body.

    ``none``: no wrapper.  ``full`` and ``block``: the group is recomputed
    in the backward and only its input (the bf16 carry, the reference's
    ``block_input``) is kept; a checkpointed function's inputs are its
    only residuals in torch, as the scan carry is under the reference's
    ``nothing_saveable``.  ``dots``: a selective checkpoint that also
    keeps every matmul output without batch dims.  Without grad the body
    runs as it is."""
    policy = rc.remat_policy
    if policy not in ("none", "full", "block", "dots"):
        raise ValueError(policy)
    if policy == "none":
        return fn
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _dots_policy)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return _ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


def check_mesh(cfg: ModelConfig, rc: RunConfig):
    """The ambient mesh, after refusing (``ValueError`` naming the ROADMAP
    item) what the sharded forward does not implement on a mesh of more
    than one rank: MoE, mamba and xLSTM blocks, and the layouts
    ``parallel.sharding.check_layout`` refuses."""
    mesh = ambient_mesh()
    if mesh is None or world_of(mesh) == 1:
        return mesh
    check_layout(rc.shard, mesh)
    for spec in cfg.pattern:
        if spec.mlp == MLP_MOE:
            raise ValueError(f"{cfg.name}: a MoE block on a mesh of "
                             f"{world_of(mesh)} ranks is not implemented: "
                             f"{EP_ITEM}")
        if spec.kind != ATTN:
            raise ValueError(f"{cfg.name}: a {spec.kind} block on a mesh "
                             f"of {world_of(mesh)} ranks is not "
                             f"implemented: {SSM_ITEM}")
    return mesh


def _grad_dtype(rc: RunConfig) -> torch.dtype:
    return torch.bfloat16 if rc.grad_allreduce_dtype == "bfloat16" \
        else torch.float32


def backbone(params, x, positions, cfg: ModelConfig, rc: RunConfig):
    """Embedded activations -> (final hidden states, summed aux loss).
    x [B,S,d].  The carried activation is cast to ``rc.activation_dtype``
    at every group boundary, as the reference's scan carry is; each group
    runs under ``rc.remat_policy``.  On a mesh each position's weights
    are gathered inside the group, so a recompute gathers them again."""
    act_dtype = torch.bfloat16 if rc.activation_dtype == "bfloat16" \
        else torch.float32
    mesh = check_mesh(cfg, rc)
    if mesh is not None:
        pattern_axes = [_pos_axes(spec, cfg) for spec in cfg.pattern]
        pattern_shapes = [_group(s, 0) for s in param_shapes(cfg)["layers"]]

    def group_body(x, aux, g: int):
        x = shard_activation(x, ("batch", "seq", "embed"), rc.shard)
        for p_i, spec in enumerate(cfg.pattern):
            p = _group(params["layers"][p_i], g)
            if mesh is not None:
                # ZeRO-3: stream this position's weights in
                p = gather_weights_for_compute(
                    p, pattern_axes[p_i], rc.shard, pattern_shapes[p_i],
                    _grad_dtype(rc))
            x, a = _block_forward(spec, p, x, positions, cfg, rc)
            aux = aux + a
        return x.to(act_dtype), aux

    body = _remat_wrap(group_body, rc)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(cfg.n_groups):
        x, aux = body(x.to(act_dtype), aux, g)
    return norm_apply(params["final_norm"], x, kind=cfg.norm,
                      eps=cfg.norm_eps), aux


def _vocab_range(cfg: ModelConfig, rc: Optional[RunConfig]):
    """This rank's vocab rows [lo, hi) when the vocab is split over the
    model axis, else None."""
    if rc is None:
        return None
    return compute_range(("vocab", "emb_embed"),
                         (cfg.vocab_size, cfg.d_model), 0, rc.shard)


def embed(params, tokens, cfg: ModelConfig, rc: Optional[RunConfig] = None):
    """Token embeddings.  With the vocab split over the model axis, a
    vocab-parallel lookup: each rank looks up the tokens in its rows
    (zeros elsewhere) and the sum over the model axis is the embedding."""
    rows = _vocab_range(cfg, rc)
    tok = params["embed"]["tok"]
    if rows is None:
        x = tok[tokens.long()]
    else:
        lo, hi = rows
        t = tokens.long() - lo
        inside = (t >= 0) & (t < hi - lo)
        x = tok[t.clamp(0, hi - lo - 1)] * inside[..., None].to(tok.dtype)
        x = collectives.reduce_from(x, "model", ambient_mesh())
    if cfg.embedding_multiplier:
        x = x * torch.tensor(cfg.embedding_multiplier, dtype=x.dtype,
                             device=x.device)
    return x


def unembed(params, x, cfg: ModelConfig, rc: Optional[RunConfig] = None):
    """Hidden states -> float32 logits.  Without the bf16 reduce knob the
    product is taken in float32, as the reference's float32-accumulated
    einsum returns it (a bf16 product would round the logits to bf16).
    With the vocab split over the model axis the logits are this rank's
    vocab columns [B, S, V/M] (column-parallel)."""
    if cfg.tie_embeddings:
        w = params["embed"]["tok"].T
    else:
        w = params["head"]["w"]
    if _vocab_range(cfg, rc) is not None:
        x = collectives.copy_to(x, "model", ambient_mesh(), reduce_dtype(rc))
    if rc is not None and reduce_dtype(rc) == torch.bfloat16:
        return dense_apply({"w": w}, x, preferred=torch.bfloat16).float()
    return torch.matmul(x.float(), w.float())


def _default_positions(B: int, S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None] \
        .expand(B, S)


def forward(params, tokens, cfg: ModelConfig, rc: RunConfig,
            positions: Optional[torch.Tensor] = None):
    """tokens [B,S] int -> (logits [B,S,V] f32, MoE aux loss)."""
    B, S = tokens.shape
    if positions is None:
        positions = _default_positions(B, S, tokens.device)
    if check_mesh(cfg, rc) is not None:
        top = {k: v for k, v in params.items() if k != "layers"}
        top_axes = {k: v for k, v in axes(cfg).items() if k != "layers"}
        top_shapes = {k: v for k, v in param_shapes(cfg).items()
                      if k != "layers"}
        params = {**params, **gather_weights_for_compute(
            top, top_axes, rc.shard, top_shapes, _grad_dtype(rc))}
    x = embed(params, tokens, cfg, rc)
    x = shard_activation(x, ("batch", "seq", "embed"), rc.shard)
    x, aux = backbone(params, x, positions, cfg, rc)
    return unembed(params, x, cfg, rc), aux


def xent(logits, labels):
    """Mean next-token cross-entropy of float32 logits [B,S,V]: logsumexp
    minus the label's logit.  The reference contracts with a one-hot (it
    partial-sums over vocab shards); a gather gives the same value
    exactly without the [B,S,V] one-hot."""
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None]).squeeze(-1)
    return torch.mean(logz - ll)


def xent_vocab_parallel(logits, labels, rows, mesh):
    """``xent`` of logits whose vocab is split over the model axis:
    ``logits`` [B,S,V/M] are this rank's columns [lo, hi) = ``rows``.
    The row max (a stabiliser: no gradient), the sum of exponentials and
    the label's logit are each reduced over the model axis."""
    lo, hi = rows
    m = collectives.all_reduce(logits.detach().amax(dim=-1), "model", mesh,
                               op="max")
    se = collectives.reduce_from(
        torch.exp(logits - m[..., None]).sum(dim=-1), "model", mesh)
    t = labels.long() - lo
    inside = (t >= 0) & (t < hi - lo)
    ll = logits.gather(-1, t.clamp(0, hi - lo - 1)[..., None]).squeeze(-1)
    ll = collectives.reduce_from(ll * inside.to(ll.dtype), "model", mesh)
    return torch.mean(torch.log(se) + m - ll)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            rc: RunConfig):
    """Next-token cross-entropy plus the MoE aux loss.  batch: tokens
    [B,S], labels [B,S], and ``positions`` [3,B,S] for M-RoPE.  Returns
    (loss, {"nll", "aux"}).  On a mesh the batch is this data rank's
    slice and the loss its mean (``train_loop`` averages the ranks)."""
    logits, aux = forward(params, batch["tokens"], cfg, rc,
                          positions=batch.get("positions"))
    rows = _vocab_range(cfg, rc)
    if rows is None:
        nll = xent(logits, batch["labels"])
    else:
        nll = xent_vocab_parallel(logits, batch["labels"], rows,
                                  ambient_mesh())
    return nll + aux, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# decode state
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    """Per-pattern-position stacked caches / states + current length."""
    slots: Tuple[Any, ...]      # one entry per pattern position, every
                                # leaf [n_groups, B, ...]: (k, v) caches
                                # (layout per rc), an SsmState, an
                                # MlstmState or an SlstmState
    pos: torch.Tensor           # [B] int32: tokens consumed per slot


def _pos_state(spec: LayerSpec, batch: int, s_max: int, cfg: ModelConfig,
               rc: RunConfig, device):
    G = cfg.n_groups
    if spec.kind == ATTN:
        return attention.init_cache(batch, s_max, cfg, rc, device=device,
                                    stack=G)
    if spec.kind == MAMBA:
        return ssm.init_state(batch, cfg, device=device, stack=G)
    if spec.kind == MLSTM:
        return xlstm.mlstm_init_state(batch, cfg, device=device, stack=G)
    if spec.kind == SLSTM:
        return xlstm.slstm_init_state(batch, cfg, device=device, stack=G)
    raise ValueError(spec.kind)


def _pos_state_axes(spec: LayerSpec, cfg: ModelConfig, rc: RunConfig):
    if spec.kind == ATTN:
        return attention.cache_axes(rc)
    if spec.kind == MAMBA:
        return ssm.state_axes(cfg)
    if spec.kind == MLSTM:
        return xlstm.mlstm_state_axes(cfg)
    if spec.kind == SLSTM:
        return xlstm.slstm_state_axes(cfg)
    raise ValueError(spec.kind)


def decode_state_axes(cfg: ModelConfig, rc: RunConfig) -> DecodeState:
    slots = [stack_axes(_pos_state_axes(spec, cfg, rc))
             for spec in cfg.pattern]
    return DecodeState(slots=tuple(slots), pos=("batch",))


def init_decode_state(batch: int, s_max: int, cfg: ModelConfig,
                      rc: RunConfig, *, device) -> DecodeState:
    slots = tuple(_pos_state(spec, batch, s_max, cfg, rc, device)
                  for spec in cfg.pattern)
    return DecodeState(slots=slots,
                       pos=torch.zeros((batch,), dtype=torch.int32,
                                       device=device))


# ---------------------------------------------------------------------------
# decode step (and prefill)
# ---------------------------------------------------------------------------

def _block_decode(spec: LayerSpec, p, x, slot, pos, cfg: ModelConfig,
                  rc: RunConfig):
    """One block of one token; ``slot`` (this group's views of the
    position's cache or state) is updated in place."""
    h = norm_apply(p["norm1"], x, kind=cfg.norm, eps=cfg.norm_eps)
    if spec.kind == ATTN:
        h, _, _ = attention.decode_apply(p["attn"], h, *slot, pos, cfg, rc,
                                         window=spec.sliding_window)
    elif spec.kind == MAMBA:
        h, _ = ssm.decode_step(p["mamba"], h, slot, cfg, rc)
    elif spec.kind == MLSTM:
        h, _ = xlstm.mlstm_decode_step(p["mlstm"], h, slot, cfg, rc)
    else:
        h, _ = xlstm.slstm_decode_step(p["slstm"], h, slot, cfg, rc)
    return _block_mlp(spec, p, x + h, cfg, rc)[0]


def decode_step(params, token, state: DecodeState, cfg: ModelConfig,
                rc: RunConfig):
    """token [B,1] int -> (logits [B,1,V], new state).  The caches and
    recurrent states are updated in place; the new state shares them and
    has ``pos + 1``."""
    x = embed(params, token, cfg)
    pos = state.pos
    for g in range(cfg.n_groups):
        for p_i, spec in enumerate(cfg.pattern):
            x = _block_decode(spec, _group(params["layers"][p_i], g), x,
                              _group(state.slots[p_i], g), pos, cfg, rc)
    x = norm_apply(params["final_norm"], x, kind=cfg.norm, eps=cfg.norm_eps)
    logits = unembed(params, x, cfg)
    return logits, DecodeState(slots=state.slots, pos=pos + 1)


def prefill(params, tokens, s_max: int, cfg: ModelConfig, rc: RunConfig):
    """Run the prompt through the stack, filling caches and states.

    Returns (last-token logits [B,1,V], DecodeState at pos=S).
    Full-sequence attention (``rc.attention_impl``; the flash kernel under
    ``"flash"``) plus a per-layer cache fill, as in the reference; a mamba
    layer's chunked SSD and its final state from one product over S; an
    mLSTM layer's sequence pass is the chunkwise kernel and its final
    state comes from one product over S; an sLSTM layer's time loop
    leaves its final state.  The states are written into the slots in
    place; the MoE aux loss is dropped.
    """
    B, S = tokens.shape
    dev = tokens.device
    positions = _default_positions(B, S, dev)
    x = embed(params, tokens, cfg)
    state = init_decode_state(B, s_max, cfg, rc, device=dev)
    for g in range(cfg.n_groups):
        for p_i, spec in enumerate(cfg.pattern):
            p = _group(params["layers"][p_i], g)
            slot = _group(state.slots[p_i], g)
            h = norm_apply(p["norm1"], x, kind=cfg.norm, eps=cfg.norm_eps)
            if spec.kind == ATTN:
                k, v = attention.project_kv(p["attn"], h, positions, cfg)
                attention.fill_cache(slot[0], k, rc)
                attention.fill_cache(slot[1], v, rc)
                y = attention.apply(p["attn"], h, positions, cfg, rc,
                                    causal=True, window=spec.sliding_window)
            else:
                prefill_fn = {MAMBA: _ssm_prefill, MLSTM: _mlstm_prefill,
                              SLSTM: _slstm_prefill}[spec.kind]
                y, final = prefill_fn(p[spec.kind], h, cfg, rc)
                for dst, src in zip(slot, final):
                    dst.copy_(src)
            x, _ = _block_mlp(spec, p, x + y, cfg, rc)
    x = norm_apply(params["final_norm"], x, kind=cfg.norm, eps=cfg.norm_eps)
    logits = unembed(params, x[:, -1:], cfg)
    return logits, DecodeState(
        slots=state.slots,
        pos=torch.full((B,), S, dtype=torch.int32, device=dev))


def _ssm_prefill(p, h, cfg: ModelConfig, rc: RunConfig):
    """The chunked SSD sequence pass and its final state."""
    return ssm.apply(p, h, cfg, rc), _ssm_final_state(p, h, cfg, rc)


def _ssm_final_state(p, h, cfg: ModelConfig, rc: RunConfig) -> ssm.SsmState:
    """(s, conv tail) after the whole prompt: the carried state from one
    product over S, the last W-1 inputs of the conv in bf16."""
    B, S, _ = h.shape
    x, z, di, nh, N, P = ssm._project(p, h, cfg)
    xc = ssm._conv_act(p, x)
    Bm = torch.split(dense_apply(p["bc_proj"], xc), N, dim=-1)[0]
    dt, log_decay = ssm._gates(p, xc, nh)
    xh = xc.reshape(B, S, nh, P).float() * dt[..., None]
    cum = torch.cumsum(log_decay, dim=1)                    # [B,S,H]
    w = torch.exp(cum[:, -1:, :] - cum)                     # [B,S,H]
    s = torch.einsum("bsn,bshp->bhnp", Bm.float(), xh * w[..., None])
    conv_tail = x[:, S - (cfg.ssm_conv_width - 1):, :].to(torch.bfloat16)
    return ssm.SsmState(s=s, conv=conv_tail)


def _mlstm_prefill(p, h, cfg: ModelConfig, rc: RunConfig):
    """The mLSTM sequence pass and its final state.  The projections are
    computed once and shared; the reference computes the same
    deterministic values twice."""
    qkvg = xlstm._mlstm_qkvg(p, h, cfg)
    y = xlstm.mlstm_chunked(p, h, qkvg, cfg, rc)
    return y, _mlstm_final_state(p, h, cfg, qkvg)


def _mlstm_final_state(p, h, cfg: ModelConfig, qkvg=None) -> xlstm.MlstmState:
    """(C, n, m) after the whole prompt, from one product over S."""
    q, k, v, logi, logf, z = qkvg if qkvg is not None \
        else xlstm._mlstm_qkvg(p, h, cfg)
    kf, vf = k.float(), v.float()
    cum = torch.cumsum(logf, dim=1)                         # [B,S,H]
    total = cum[:, -1, :]                                   # [B,H]
    scores = total[:, None, :] - cum + logi                 # [B,S,H]
    m = scores.amax(dim=1)                                  # [B,H]
    wk = torch.exp(scores - m[:, None, :])
    c = torch.einsum("bshp,bshr->bhpr", kf * wk[..., None], vf)
    n = torch.einsum("bshp,bsh->bhp", kf, wk)
    return xlstm.MlstmState(c=c, n=n, m=m)


def _slstm_prefill(p, h, cfg: ModelConfig, rc: RunConfig):
    """The sLSTM time loop; returns its output and final state."""
    hs, final = xlstm.slstm_scan(p, h, cfg)
    return xlstm._slstm_out(p, hs.to(h.dtype), cfg), final

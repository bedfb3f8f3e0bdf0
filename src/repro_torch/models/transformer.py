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
vocab-parallel one, a MoE block's experts split over the model axis
(``models/moe.py``), a mamba or mLSTM block's inner width
(``ssm_inner``) over it (``models/ssm.py``, ``models/xlstm.py``), and
an sLSTM block runs whole on every model rank; under sequence
parallelism the stream between blocks is each model rank's block of
the sequence (``backbone``, ``embed``, ``unembed``).  Off a mesh every
path is the one-process one.

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
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.models import attention, mlp, moe, ssm, xlstm
from repro_torch.models.common import (MetaGenerator, Static, dense_apply,
                                       norm_apply, norm_axes, norm_init,
                                       reduce_dtype, replicated, stack_axes,
                                       tree_flatten_with_path, tree_map,
                                       tree_unflatten, trunc_normal)
from repro_torch.models.config import (ATTN, MAMBA, MLP_DENSE, MLP_MOE,
                                       MLSTM, SLSTM, LayerSpec, ModelConfig)
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import (Placement, ambient_mesh,
                                           compute_range,
                                           data_parallel_size,
                                           gather_weights_for_compute,
                                           logical_to_spec,
                                           sequence_parallel_on,
                                           shard_activation, shardings_for)
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
           rc: RunConfig, sp: bool = False):
    """The block's sequence mixer on the normed input (full sequence, or
    this rank's block of it under sequence parallelism: ``sp``)."""
    if spec.kind == ATTN:
        return attention.apply(p["attn"], h, positions, cfg, rc,
                               causal=True, window=spec.sliding_window,
                               seq_parallel=sp)
    if spec.kind == MAMBA:
        return ssm.apply(p["mamba"], h, cfg, rc, seq_parallel=sp)
    if spec.kind == MLSTM:
        return xlstm.mlstm_apply(p["mlstm"], h, cfg, rc, seq_parallel=sp)
    return xlstm.slstm_apply(p["slstm"], h, cfg, rc, seq_parallel=sp)


def _norm(p, x, cfg: ModelConfig, sp: bool):
    """``norm_apply``; under sequence parallelism (``sp``: ``x`` is this
    rank's block of the sequence) its weights under
    ``common.replicated``, so that their gradient is the model ranks'
    sum."""
    if sp:
        p = replicated(p, ambient_mesh())
    return norm_apply(p, x, kind=cfg.norm, eps=cfg.norm_eps)


def _block_mlp(spec: LayerSpec, p, x, cfg: ModelConfig, rc: RunConfig,
               sp: bool = False, moe_axes=None):
    """The block's MLP half (pre-norm residual).  Returns (x, aux): the
    MoE auxiliary loss, 0.0 for a dense MLP or none.  ``moe_axes`` are
    the data axes whose ranks hold other tokens (``moe.apply``'s
    ``data_axes``; None: the batch's axes)."""
    aux = 0.0
    if spec.mlp == MLP_DENSE:
        h = _norm(p["norm2"], x, cfg, sp)
        x = x + mlp.apply(p["mlp"], h, cfg, rc, seq_parallel=sp)
    elif spec.mlp == MLP_MOE:
        h = _norm(p["norm2"], x, cfg, sp)
        y, aux = moe.apply(p["moe"], h, cfg, rc, seq_parallel=sp,
                           data_axes=moe_axes)
        x = x + y
    return x, aux


def _block_forward(spec: LayerSpec, p, x, positions, cfg: ModelConfig,
                   rc: RunConfig, sp: bool = False):
    """One block (pre-norm residual).  Returns (x, aux_loss).  Under
    sequence parallelism (``sp``) ``x`` is this rank's block of the
    sequence, and so is the result."""
    h = _norm(p["norm1"], x, cfg, sp)
    x = x + _mixer(spec, p, h, positions, cfg, rc, sp)
    return _block_mlp(spec, p, x, cfg, rc, sp)


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


def _grad_dtype(rc: RunConfig) -> torch.dtype:
    return torch.bfloat16 if rc.grad_allreduce_dtype == "bfloat16" \
        else torch.float32


def backbone(params, x, positions, cfg: ModelConfig, rc: RunConfig):
    """Embedded activations -> (final hidden states, summed aux loss).
    x [B,S,d].  The carried activation is cast to ``rc.activation_dtype``
    at every group boundary, as the reference's scan carry is; each group
    runs under ``rc.remat_policy``.  On a mesh each position's weights
    are gathered inside the group, so a recompute gathers them again.
    Under sequence parallelism (``parallel.sharding.sequence_parallel_on``
    for the positions' length) ``x`` is this rank's block of the sequence
    [B, S/M, d] and the carry between groups (a remat group's saved
    input) stays that block; the positions are whole."""
    act_dtype = torch.bfloat16 if rc.activation_dtype == "bfloat16" \
        else torch.float32
    S = positions.shape[-1]
    sp = sequence_parallel_on(rc.shard, ambient_mesh(), S)

    def group_body(x, aux, g: int):
        x = shard_activation(x, ("batch", "seq", "embed"), rc.shard, S)
        for p_i, spec in enumerate(cfg.pattern):
            # ZeRO-3: stream this position's weights in
            p = _layer_weights(params, p_i, g, cfg, rc)
            x, a = _block_forward(spec, p, x, positions, cfg, rc, sp)
            aux = aux + a
        return x.to(act_dtype), aux

    body = _remat_wrap(group_body, rc)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(cfg.n_groups):
        x, aux = body(x.to(act_dtype), aux, g)
    return _norm(params["final_norm"], x, cfg, sp), aux


def _vocab_range(cfg: ModelConfig, rc: Optional[RunConfig]):
    """This rank's vocab rows [lo, hi) when the vocab is split over the
    model axis, else None."""
    if rc is None:
        return None
    return compute_range(("vocab", "emb_embed"),
                         (cfg.vocab_size, cfg.d_model), 0, rc.shard)


def embed(params, tokens, cfg: ModelConfig, rc: Optional[RunConfig] = None,
          sp: bool = False):
    """Token embeddings.  With the vocab split over the model axis, a
    vocab-parallel lookup: each rank looks up the tokens in its rows
    (zeros elsewhere) and the sum over the model axis is the embedding;
    under sequence parallelism (``sp``) that sum is reduce-scattered
    along the sequence, and the result is this rank's block of it.  A
    whole table under ``sp`` is looked up whole, under
    ``common.replicated`` (``forward``'s ``shard_activation`` takes the
    block, so the table's gradient is the model ranks' sum)."""
    rows = _vocab_range(cfg, rc)
    tok = params["embed"]["tok"]
    if rows is None:
        if sp:
            tok = replicated(tok, ambient_mesh())
        x = tok[tokens.long()]
    else:
        lo, hi = rows
        t = tokens.long() - lo
        inside = (t >= 0) & (t < hi - lo)
        x = tok[t.clamp(0, hi - lo - 1)] * inside[..., None].to(tok.dtype)
        if sp:
            x = collectives.reduce_scatter(x, 1, "model", ambient_mesh())
        else:
            x = collectives.reduce_from(x, "model", ambient_mesh())
    if cfg.embedding_multiplier:
        x = x * torch.tensor(cfg.embedding_multiplier, dtype=x.dtype,
                             device=x.device)
    return x


def unembed(params, x, cfg: ModelConfig, rc: Optional[RunConfig] = None,
            sp: bool = False):
    """Hidden states -> float32 logits.  Without the bf16 reduce knob the
    product is taken in float32, as the reference's float32-accumulated
    einsum returns it (a bf16 product would round the logits to bf16).
    With the vocab split over the model axis the logits are this rank's
    vocab columns [B, S, V/M] (column-parallel).

    Under sequence parallelism (``sp``: ``x`` is this rank's block of the
    sequence) the sequence is gathered first and the logits are those
    vocab columns of every position, as without it: the reference pins
    its logits to the sequence's block and the whole vocab, which would
    gather the head's [d, V] weight instead of the [B, S, d] hidden
    states, for the same per-chip FLOPs.  Where the vocab is whole, every
    model rank computes the whole logits of the gathered sequence (its
    gradient is then whole on every rank, so the gather's backward takes
    the block and sums nothing)."""
    if cfg.tie_embeddings:
        w = params["embed"]["tok"].T
    else:
        w = params["head"]["w"]
    split = _vocab_range(cfg, rc) is not None
    if sp and split:
        x = collectives.gather_seq(x, ambient_mesh(), reduce_dtype(rc))
    elif sp:
        x = collectives.all_gather(x, 1, ("model",), ambient_mesh())
    elif split:
        x = collectives.copy_to(x, "model", ambient_mesh(), reduce_dtype(rc))
    if rc is not None and reduce_dtype(rc) == torch.bfloat16:
        return dense_apply({"w": w}, x, preferred=torch.bfloat16).float()
    return torch.matmul(x.float(), w.float())


def _default_positions(B: int, S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None] \
        .expand(B, S)


def _gather_top(params, cfg: ModelConfig, rc: RunConfig):
    """``params`` with the embedding, the head and the final norm
    gathered for compute on a mesh (ZeRO-3; the layers are gathered one
    position at a time where they run); ``params`` off a mesh."""
    if ambient_mesh() is None:
        return params
    top = {k: v for k, v in params.items() if k != "layers"}
    top_axes = {k: v for k, v in axes(cfg).items() if k != "layers"}
    top_shapes = {k: v for k, v in param_shapes(cfg).items()
                  if k != "layers"}
    return {**params, **gather_weights_for_compute(
        top, top_axes, rc.shard, top_shapes, _grad_dtype(rc))}


def _layer_weights(params, p_i: int, g: int, cfg: ModelConfig,
                   rc: RunConfig):
    """Group ``g``'s weights of pattern position ``p_i``, gathered for
    compute on a mesh (``gather_weights_for_compute``)."""
    p = _group(params["layers"][p_i], g)
    if ambient_mesh() is None:
        return p
    return gather_weights_for_compute(
        p, _pos_axes(cfg.pattern[p_i], cfg), rc.shard,
        _group(param_shapes(cfg)["layers"][p_i], 0), _grad_dtype(rc))


def forward(params, tokens, cfg: ModelConfig, rc: RunConfig,
            positions: Optional[torch.Tensor] = None):
    """tokens [B,S] int -> (logits [B,S,V] f32, MoE aux loss)."""
    B, S = tokens.shape
    if positions is None:
        positions = _default_positions(B, S, tokens.device)
    sp = sequence_parallel_on(rc.shard, ambient_mesh(), S)
    params = _gather_top(params, cfg, rc)
    x = embed(params, tokens, cfg, rc, sp)
    x = shard_activation(x, ("batch", "seq", "embed"), rc.shard, S)
    x, aux = backbone(params, x, positions, cfg, rc)
    return unembed(params, x, cfg, rc, sp), aux


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

@dataclass(frozen=True)
class ServeShape(Static):
    """The global batch and cache length whose blocks a decode state on a
    mesh holds: a rank's leaves are blocks, and which rows, positions and
    heads they are follows from the global shape through the placements
    (the reference's arrays carry it; a block cannot say it)."""
    batch: int
    s_max: int


class DecodeState(NamedTuple):
    """Per-pattern-position stacked caches / states + current length."""
    slots: Tuple[Any, ...]      # one entry per pattern position, every
                                # leaf [n_groups, B, ...]: (k, v) caches
                                # (layout per rc), an SsmState, an
                                # MlstmState or an SlstmState
    pos: torch.Tensor           # [B] int32: tokens consumed per slot


class MeshDecodeState(NamedTuple):
    """A rank's blocks of a ``DecodeState`` on a mesh: the same leaves,
    and the global shape they are blocks of (a ``Static`` node, no
    leaf)."""
    slots: Tuple[Any, ...]
    pos: torch.Tensor
    global_shape: ServeShape


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


def decode_state_placements(batch: int, s_max: int, cfg: ModelConfig,
                            rc: RunConfig, mesh) -> DecodeState:
    """Each leaf's ``Placement`` in a decode state of ``batch`` rows and
    ``s_max`` positions on ``mesh``: the reference's ``shardings_for(
    decode_state_axes)`` under its guard (a dim that does not divide its
    mesh axes is whole and releases them: ``kv_seq`` takes ``data`` under
    ``shard_kv_seq`` only where ``batch`` did not)."""
    shapes = init_decode_state(batch, s_max, cfg, rc, device="meta")
    return shardings_for(shapes, decode_state_axes(cfg, rc),
                         rc.shard.resolve(mesh), mesh)


def init_local_decode_state(batch: int, s_max: int, cfg: ModelConfig,
                            rc: RunConfig, mesh, *,
                            device) -> MeshDecodeState:
    """This rank's blocks of the empty decode state of ``batch`` rows and
    ``s_max`` positions on ``mesh``, each leaf made at its
    ``Placement.local_shape`` (no global leaf is built): zeros, the
    xLSTM stabilisers ``m`` at ``xlstm.NEG_INF``, as
    :func:`init_decode_state` fills them."""
    shapes = init_decode_state(batch, s_max, cfg, rc, device="meta")
    pairs, treedef = tree_flatten_with_path(shapes)
    pls = tree_flatten_with_path(decode_state_placements(
        batch, s_max, cfg, rc, mesh))[0]
    out = [torch.full(pl.local_shape(tuple(sh.shape)),
                      xlstm.NEG_INF if path[-1] == "m" else 0,
                      dtype=sh.dtype, device=device)
           for (path, sh), (_, pl) in zip(pairs, pls)]
    return MeshDecodeState(*tree_unflatten(treedef, out),
                           ServeShape(batch, s_max))


def serve_rows(batch: int, rc: RunConfig, mesh) -> slice:
    """The rows of a global ``batch`` a rank of ``mesh`` serves: its data
    block where the batch divides the batch's mesh axes, else every row
    (the guard: long_500k's B = 1 is whole on every data rank)."""
    spec = logical_to_spec(("batch",), rc.shard.resolve(mesh), mesh,
                           (batch,))
    return Placement.of(mesh, spec).index((batch,), mesh.rank)[0]


class _Serving(NamedTuple):
    """Where a rank's serving blocks lie on the ambient mesh: its attention
    caches' ``CacheBlock`` and the data axes whose ranks hold other rows
    (``moe.apply``'s ``data_axes``: none where the batch is whole on
    every data rank)."""
    block: Optional[attention.CacheBlock]
    moe_axes: Optional[Tuple[str, ...]]


def _serving(shape: ServeShape, rows: int, cfg: ModelConfig,
             rc: RunConfig) -> _Serving:
    """The ambient mesh's ``_Serving`` for a state of global ``shape``
    whose rank holds ``rows`` rows (checked); off a mesh, none."""
    mesh = ambient_mesh()
    if mesh is None:
        return _Serving(None, None)
    if shape is None:
        raise ValueError("a decode state on a mesh holds blocks of a global "
                         "shape: make it with init_local_decode_state or "
                         "prefill on the mesh")
    want = serve_rows(shape.batch, rc, mesh)
    if want.stop - want.start != rows:
        raise ValueError(f"{rows} rows on rank {mesh.rank}; a global batch "
                         f"of {shape.batch} gives it rows [{want.start}, "
                         f"{want.stop})")
    split = want.stop - want.start < shape.batch
    return _Serving(attention.cache_block(cfg, rc, mesh, shape.batch,
                                          shape.s_max),
                    None if split else ())


def _serve_logits(params, x, cfg: ModelConfig, rc: RunConfig):
    """float32 logits [B, 1, V] of the last hidden states ``x``, over the
    whole vocab (the reference's ``unembed`` without a run config: a
    float32 product): with the vocab split over the model axis, the
    rank's columns all-gathered over it, so a caller's argmax is one
    process's."""
    y = unembed(params, x, cfg)
    if _vocab_range(cfg, rc) is not None:
        y = collectives.all_gather(y, y.dim() - 1, ("model",),
                                   ambient_mesh())
    return y


# ---------------------------------------------------------------------------
# decode step (and prefill)
# ---------------------------------------------------------------------------

def _block_decode(spec: LayerSpec, p, x, slot, pos, cfg: ModelConfig,
                  rc: RunConfig, serving: _Serving):
    """One block of one token; ``slot`` (this group's views of the
    position's cache or state) is updated in place."""
    h = norm_apply(p["norm1"], x, kind=cfg.norm, eps=cfg.norm_eps)
    if spec.kind == ATTN:
        h, _, _ = attention.decode_apply(p["attn"], h, *slot, pos, cfg, rc,
                                         window=spec.sliding_window,
                                         block=serving.block)
    elif spec.kind == MAMBA:
        h, _ = ssm.decode_step(p["mamba"], h, slot, cfg, rc)
    elif spec.kind == MLSTM:
        h, _ = xlstm.mlstm_decode_step(p["mlstm"], h, slot, cfg, rc)
    else:
        h, _ = xlstm.slstm_decode_step(p["slstm"], h, slot, cfg, rc)
    return _block_mlp(spec, p, x + h, cfg, rc, moe_axes=serving.moe_axes)[0]


def decode_step(params, token, state: DecodeState, cfg: ModelConfig,
                rc: RunConfig):
    """token [B,1] int -> (logits [B,1,V], new state).  The caches and
    recurrent states are updated in place; the new state shares them and
    has ``pos + 1``.

    Under an ambient mesh ``params`` are this rank's blocks, ``state`` a
    ``MeshDecodeState`` (from ``init_local_decode_state`` or ``prefill``
    on the mesh: its blocks of a state of ``state.global_shape``) and
    ``token``
    its rows (``serve_rows``); each layer's weights are gathered for
    compute where FSDP stores them split, the blocks run their
    tensor-parallel decode forms, and the logits are the rank's rows over
    the whole vocab (``_serve_logits``)."""
    pos = state.pos
    serving = _serving(getattr(state, "global_shape", None), token.shape[0],
                       cfg, rc)
    params = _gather_top(params, cfg, rc)
    x = embed(params, token, cfg, rc)
    for g in range(cfg.n_groups):
        for p_i, spec in enumerate(cfg.pattern):
            x = _block_decode(spec, _layer_weights(params, p_i, g, cfg, rc),
                              x, _group(state.slots[p_i], g), pos, cfg, rc,
                              serving)
    x = norm_apply(params["final_norm"], x, kind=cfg.norm, eps=cfg.norm_eps)
    return _serve_logits(params, x, cfg, rc), state._replace(pos=pos + 1)


def prefill(params, tokens, s_max: int, cfg: ModelConfig, rc: RunConfig,
            batch: Optional[int] = None):
    """Run the prompt through the stack, filling caches and states.

    Returns (last-token logits [B,1,V], DecodeState at pos=S).
    Full-sequence attention (``rc.attention_impl``; the flash kernel under
    ``"flash"``) plus a per-layer cache fill, as in the reference; a mamba
    layer's chunked SSD and its final state from one product over S; an
    mLSTM layer's sequence pass is the chunkwise kernel and its final
    state comes from one product over S; an sLSTM layer's time loop
    leaves its final state.  The states are written into the slots in
    place; the MoE aux loss is dropped.

    Under an ambient mesh ``tokens`` are this rank's rows of a global
    batch of ``batch`` rows (default: the rows times the data-parallel
    size, as a train step's batch; ``serve_rows`` decides, and the rows
    given are checked against it), ``params`` its blocks; the state
    comes back as its blocks (``init_local_decode_state``) and the logits
    as its rows over the whole vocab.  Each layer runs its train-path
    form (FSDP's gathers, the column- and row-parallel projections, the
    vocab-parallel embedding, sequence parallelism where the knob and
    the length ask for it); the cache block is filled with the kv heads
    it holds (``attention.project_kv``), and a recurrent layer's final
    state is its reference layout's block (``ssm.final_state``,
    ``xlstm.mlstm_prefill``, ``xlstm.slstm_prefill``).
    """
    B, S = tokens.shape
    dev = tokens.device
    mesh = ambient_mesh()
    if mesh is None:
        state = init_decode_state(B, s_max, cfg, rc, device=dev)
    else:
        batch = batch if batch is not None \
            else B * data_parallel_size(rc.shard)
        state = init_local_decode_state(batch, s_max, cfg, rc, mesh,
                                        device=dev)
    serving = _serving(getattr(state, "global_shape", None), B, cfg, rc)
    positions = _default_positions(B, S, dev)
    sp = sequence_parallel_on(rc.shard, mesh, S)
    params = _gather_top(params, cfg, rc)
    x = embed(params, tokens, cfg, rc, sp)
    for g in range(cfg.n_groups):
        x = shard_activation(x, ("batch", "seq", "embed"), rc.shard, S)
        for p_i, spec in enumerate(cfg.pattern):
            p = _layer_weights(params, p_i, g, cfg, rc)
            slot = _group(state.slots[p_i], g)
            h = _norm(p["norm1"], x, cfg, sp)
            if spec.kind == ATTN:
                heads = None if serving.block is None else serving.block.heads
                k, v = attention.project_kv(p["attn"], h, positions, cfg,
                                            rc=rc, heads=heads,
                                            seq_parallel=sp)
                if serving.block is not None:
                    k, v = (t[:, serving.block.seq] for t in (k, v))
                attention.fill_cache(slot[0], k, rc)
                attention.fill_cache(slot[1], v, rc)
                y = attention.apply(p["attn"], h, positions, cfg, rc,
                                    causal=True, window=spec.sliding_window,
                                    seq_parallel=sp)
            else:
                # the whole sequence, where the rank holds a block of it
                hw = collectives.all_gather(h, 1, ("model",), mesh) \
                    if sp and spec.kind != MLSTM else h
                if spec.kind == MAMBA:
                    y = ssm.apply(p["mamba"], h, cfg, rc, seq_parallel=sp,
                                  gathered=hw if sp else None)
                    final = _ssm_final_state(p["mamba"], hw, cfg, rc)
                elif spec.kind == MLSTM:
                    y, final = xlstm.mlstm_prefill(p["mlstm"], h, cfg, rc, sp)
                else:
                    y, final = _slstm_prefill(p["slstm"], hw, cfg, rc)
                    if sp:
                        y = collectives.split(y, 1, "model", mesh)
                for dst, src in zip(slot, final):
                    dst.copy_(src)
            x, _ = _block_mlp(spec, p, x + y, cfg, rc, sp, serving.moe_axes)
    x = _norm(params["final_norm"], x, cfg, sp)[:, -1:]
    if sp:              # the last model rank's block holds the last token
        x = collectives.all_gather(x, 1, ("model",), mesh)[:, -1:]
    logits = _serve_logits(params, x, cfg, rc)
    return logits, state._replace(
        pos=torch.full((B,), S, dtype=torch.int32, device=dev))


def _ssm_final_state(p, h, cfg: ModelConfig, rc: RunConfig) -> ssm.SsmState:
    """A mamba layer's state after the whole prompt ``h``
    (``ssm.final_state``)."""
    return ssm.final_state(p, h, cfg, rc)


def _mlstm_final_state(p, h, cfg: ModelConfig, qkvg=None) -> xlstm.MlstmState:
    """(C, n, m) after the whole prompt, from one product over S
    (``xlstm.mlstm_final_state``; ``qkvg`` the projections when the
    caller has them)."""
    return xlstm.mlstm_final_state(
        qkvg if qkvg is not None else xlstm._mlstm_qkvg(p, h, cfg))


def _slstm_prefill(p, h, cfg: ModelConfig, rc: RunConfig):
    """The sLSTM time loop over the whole prompt ``h``; returns its output
    and final state.  On a mesh every model rank runs it whole, as in
    training (``xlstm.slstm_apply``)."""
    hs, final = xlstm.slstm_scan(p, h, cfg)
    return xlstm._slstm_out(p, hs.to(h.dtype), cfg, rc), final

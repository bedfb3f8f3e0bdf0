"""Product-cluster run of one (arch × shape) cell: build its step on the
card, run it, time it (from ``repro.launch.dryrun``).

The reference lowers and compiles every cell on a forced 512-device CPU
mesh and reads three roofline terms out of the compiled HLO: per-device
FLOPs, HBM bytes and collective bytes of the SPMD program.  The port has
one real card instead, so it runs the configured step there, as
Sapphire's product cluster (the paper's Ceph deployment) runs a
recommended config, at one of two shares of the production mesh
(``make_production_mesh``: 16 x 16, or 2 x 16 x 16):

* ``"chip"``: one chip's share, the program that chip (0, 0) (pod 0 on
  the multi-pod mesh) runs: its blocks of the state
  (``train_loop.init_local_state``; no global leaf is built), its data
  rank's rows, its local heads, ff and vocab, its FSDP gathers, under a
  virtual mesh (``launch.mesh.make_virtual_mesh``) whose collectives act
  locally and are counted by kind (``parallel.collectives``).  The
  record's ``collective_s`` prices those bytes at ``ici_bw``, and its
  ``scored_step_s`` is the reference's combine rule with the measured
  step in place of the compute and memory terms.  Only what the port's
  layout implements runs this way: every train, prefill and decode cell
  of the decoder-only families (:func:`layout_covers`; a serving cell's
  chip holds its blocks of the decode state,
  ``models.model.init_local_decode_state``);
* ``"replica"``: one data-parallel replica's share, every other cell
  (whisper's) and wherever the caller asks for it:
  ``global_batch // data_parallel_size`` sequences, the replica's whole
  model work on the card, no collective (``scored_step_s`` is the
  measured step).

For a cell:

  1. the full (paper-exact) ModelConfig, cut in depth where the card
     asks for it (:func:`cell_depth`: one depth for every config of a
     cell, from :func:`estimate_bytes` at the share), and the per-arch
     default RunConfig (:func:`default_runconfig`, the reference's, with
     each config's ``RUN_OVERRIDES`` and the caller's knobs);
  2. the share's batch: ``global_batch // data_parallel_size(shard,
     production mesh)`` sequences (``train_4k``: 16 x 4096 tokens on the
     16 x 16 mesh; a chip's model axis replicates its data rank's rows);
  3. the step for the cell's mode with weights, state and inputs made on
     the device from a seed (:func:`lower_cell`): ``make_train_step``
     (donated state), ``Model.prefill``, or one ``Model.decode_step``
     against an S-long cache;
  4. one warm-up step, counted (``roofline.count_step``: FLOPs, an HBM
     bytes proxy, the kernels' own work, the collectives' bytes by kind)
     and timed with the build as ``compile_s``; then ``steps`` timed
     steps, each ending in a synchronise, whose median is
     ``measured_step_s``;
  5. the record (:func:`compile_cell`): the reference's keys, the
     roofline terms against ``roofline.H100``, and what was measured.
     :func:`run_cell` writes it to
     ``artifacts/dryrun/<arch>.<shape>[.multi-pod].<mesh>-chip.1xH100.json``
     (a chip) or ``...<shape>[.multi-pod].1xH100.json`` (a replica); the
     reference's records are ``...16x16.json`` and are never
     overwritten.

This module sets no ``XLA_FLAGS`` and imports no JAX.

CLI:
    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
        [--device cpu] [--layers 2] [--multi-pod] [--share chip|replica]
        [--knob sequence_parallel=true ...]
    python -m repro_torch.launch.dryrun --all [--skip-existing]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import importlib
import json
import math
import statistics
import subprocess
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs import ARCH_IDS, canonical, get_config
from repro_torch.core.costmodel import REMAT_ACT_FRACTION, _bytes_of
from repro_torch.device import resolve_device
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import (VirtualMesh, make_production_mesh,
                                     make_virtual_mesh)
from repro_torch.launch.serve import parse_knobs
from repro_torch.models.common import tree_flatten
from repro_torch.models.config import (SHAPES_BY_NAME, ModelConfig,
                                       ShapeCell, applicable_shapes)
from repro_torch.models import attention, transformer, xlstm
from repro_torch.models.model import Model, init_local_decode_state
from repro_torch.parallel.sharding import (WHISPER_ITEM, compute_range,
                                           data_parallel_size,
                                           sequence_parallel_on)
from repro_torch.runconfig import RunConfig, runconfig_from_knobs
from repro_torch.train.train_loop import (init_local_state, init_state,
                                          make_train_step, param_placements,
                                          state_placements, state_shapes)

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun"
# the share of the card estimate_bytes may take when fit_depth picks the
# depth; the rest is slack for what the estimate leaves out
FIT_FRACTION = 0.9
SEED = 0                 # of the weights, the optimizer state and the tokens
SHARES = ("chip", "replica")


def default_runconfig(cfg: ModelConfig, cell: ShapeCell,
                      knobs: Optional[Dict] = None) -> RunConfig:
    """Per-arch default RunConfig (+ optional SAPPHIRE knob overrides)."""
    # the framework's shipped family defaults: memory-safe but untuned
    # (the SAPPHIRE baseline; the paper's "default configuration")
    over: Dict = {}
    if cell.mode == "train":
        over.update(remat_policy="block", microbatch=4)
    if cell.mode == "decode":
        # serving keeps weights data-replicated: ZeRO-3 storage would
        # re-gather every weight on every token (measured 9.3 GB/step)
        over.update(fsdp_shard_params=False)
    if cfg.has_attention:
        # chunked online-softmax everywhere: never materializes [S, S]
        over.update(attention_impl="chunked", chunk_size_k=2048)
    try:
        mod = importlib.import_module(
            f"repro_torch.configs.{canonical(cfg.name)}")
        over.update(getattr(mod, "RUN_OVERRIDES", {}))
    except ModuleNotFoundError:
        pass
    if cell.name == "long_500k":
        over.setdefault("shard_kv_seq", True)
    if knobs:
        over.update(knobs)
    rc = runconfig_from_knobs(over)
    # non-shard fields live on the flat RunConfig
    fields = {k: v for k, v in over.items() if hasattr(rc, k)}
    return rc.replace(**fields)


def _state_bytes_per_param(rc: RunConfig, train: bool) -> int:
    """Bytes a parameter holds on the card: the weight, and in training
    its float32 master, AdamW's two float32 moments (Adafactor's are
    factored: a row and a column per matrix, not counted) and its
    gradient (a float32 accumulator and one microbatch's bf16 gradient)."""
    n = 4 if rc.param_dtype == "float32" else 2
    if train:
        n += 4 if rc.master_weights_f32 else 0
        n += 8 if rc.optimizer == "adamw" else 0
        n += 6
    return n


# float32 temporaries of the largest parameter leaf that the optimizer's
# update holds at once beside the state (the clipped gradient, the new
# moments, the update's chain of elementwise results); read off the card's
# allocator around ``opt_update`` (AdamW: 16.6 GB over qwen2-moe's 2.77 GB
# expert leaf at 4 layers; Adafactor: 17.2 GB over the jamba cut's 2.15 GB
# embedding)
UPDATE_TEMPORARIES = {"adamw": 6, "adafactor": 8}


def _largest_leaf(cfg: ModelConfig) -> int:
    """Elements of the largest parameter leaf: the embedding (or the head)
    or a pattern position's largest matrix stacked over the groups."""
    d, big = cfg.d_model, 0
    for spec in cfg.pattern:
        mixer = {"attn": d * cfg.q_dim, "mamba": 2 * d * cfg.d_inner,
                 "mlstm": 2 * d * int(cfg.mlstm_expand * d),
                 "slstm": 4 * d * d}.get(spec.kind, 0)
        ff = cfg.moe_d_ff if cfg.moe_d_ff is not None else cfg.d_ff
        mlp = {"dense": d * cfg.d_ff,
               "moe": cfg.n_experts * d * ff}.get(spec.mlp, 0)
        big = max(big, mixer, mlp)
    return max(cfg.vocab_size * d, cfg.n_groups * big)


def _chip_state(cfg: ModelConfig, rc: RunConfig, mesh, train: bool):
    """(state bytes, parameters, elements of the largest parameter block)
    of one chip of ``mesh``: each leaf's ``Placement.local_shape`` in its
    own dtype (the weights, and in training the optimizer state and the
    gradients, as :func:`_state_bytes_per_param` counts them)."""
    model = Model(cfg, device="cpu")
    shapes, pls = state_shapes(model, rc), state_placements(model, rc, mesh)

    def local(tree, pl_tree):
        return [(math.prod(pl.local_shape(tuple(sh.shape))),
                 sh.element_size()) for sh, pl in
                zip(tree_flatten(tree)[0], tree_flatten(pl_tree)[0])]
    params = local(shapes.params, pls.params)
    n = sum(k for k, _ in params)
    if train:
        state = sum(k * b for k, b in local(shapes, pls)) + 6 * n
    else:
        state = sum(k * b for k, b in params)
    return state, n, max(k for k, _ in params)


# copies of a MoE layer's expert hidden activations that its forward keeps
# for the backward: the gate and up products, the activation, its product
# with the up projection and the routing-scaled copy the down projection
# reads
MOE_HIDDEN_COPIES = 5


def _moe_layer_bytes(cfg: ModelConfig, rc: RunConfig, tokens: int,
                     mesh) -> float:
    """One MoE layer's expert activations on one chip of ``mesh``, for a
    microbatch of ``tokens`` (the whole sequence: the experts read it
    gathered under sequence parallelism): the routing's float32 [T, E]
    (probabilities, weights and their gradients), and under ``dense``
    ``MOE_HIDDEN_COPIES`` of the [T, E_loc·f_loc] hidden in the
    activation dtype; under ``dropping`` the [E_loc, C + 1, d] buffer
    (C the capacity of every data rank's tokens), that many copies of its
    [E_loc, C, f_loc] hidden and its float32 [E_loc, C, d] output."""
    from repro_torch.models.moe import EXPERT_AXES, _capacity, _expert_ff
    E, d, f = cfg.n_experts, cfg.d_model, _expert_ff(cfg)

    def share(dim, n):
        rng = compute_range(EXPERT_AXES, (E, d, f), dim, rc.shard, mesh)
        return n if rng is None else rng[1] - rng[0]
    e_loc, f_loc = share(0, E), share(2, f)
    act = _bytes_of(rc.activation_dtype)
    n = 4 * tokens * E * 4
    if rc.moe_impl == "dropping":
        cap = _capacity(tokens * data_parallel_size(rc.shard, mesh.shape),
                        cfg, rc)
        return n + e_loc * ((cap + 1) * d * act
                            + MOE_HIDDEN_COPIES * cap * f_loc * act
                            + cap * d * 4)
    return n + MOE_HIDDEN_COPIES * tokens * e_loc * f_loc * act


def _tp_splits(cfg: ModelConfig, rc: RunConfig, mesh) -> Tuple[int, int]:
    """How many ways the model axis splits the heads and the vocab on
    ``mesh`` (1 where tensor parallelism is off or a dim does not divide,
    as ``logical_to_spec``'s guard replicates it).  Where the pattern has
    an mLSTM block the heads split at most ``n_heads`` ways: a head the
    axis cuts is whole (its q, k, v and h) on every rank of its group
    (``models/xlstm.py``)."""
    m = mesh.shape.get("model", 1) if rc.shard.tensor_parallel else 1
    heads = m if cfg.q_dim % m == 0 else 1
    if any(s.kind == "mlstm" for s in cfg.pattern):
        heads = min(heads, cfg.n_heads)
    return heads, m if cfg.vocab_size % m == 0 else 1


# a serving layer's copies of its [B, S, d] stream, counted as if all
# were live at once (an upper bound): the stream, the norm's output, a
# row-parallel projection's cast result and the residual sum in the
# activation dtype; the norm's upcast and normalised product, the
# projection's partial sums and their sum over the model axis in float32
SERVE_STREAM_COPIES = {"activation": 4, "float32": 4}


# float32 copies of a layer's recurrent state a decode step holds beside
# the state: mamba's decayed state, its input's outer product and their sum
# (an mLSTM step's outer product and its gated copy are two)
DECODE_STATE_COPIES = 3
# bytes a parameter's element takes while it is drawn beside the state:
# the float32 draw and its scaled float32 copy (``trunc_normal_std``), the
# cast leaf itself being state; a serving cell's peak can be its build
INIT_TEMPORARIES = 8


def _recurrent_state_bytes(cfg: ModelConfig, batch: int) -> int:
    """Bytes of the largest per-layer recurrent state of ``batch`` rows
    (mamba's ``s``, an mLSTM's ``c``; whole over the model axis in the
    reference's layout), 0 where the pattern has none."""
    di, nh, P = xlstm.mlstm_dims(cfg)
    per_row = {"mamba": cfg.d_inner * cfg.ssm_state_dim, "mlstm": nh * P * P}
    return max((batch * per_row.get(s.kind, 0) * 4 for s in cfg.pattern),
               default=0)


def _serve_layer_bytes(cfg: ModelConfig, rc: RunConfig, tokens: int,
                       heads: int, split: int) -> float:
    """One serving layer's live temporaries at its peak for ``tokens``
    rows times positions: ``SERVE_STREAM_COPIES`` of the stream (divided
    by ``split``, the model axis under sequence parallelism) and the
    widest per-token block a layer of the pattern forms, at the chip's
    share of the heads (``heads``; an sLSTM block is whole): attention's
    q and its output at the chip's heads and k and v at every kv head (a
    cache whole over the model axis), an MLP's gate, up and their
    product, a mamba block's x, z, conv'd x and float32 output, an mLSTM
    block's x, z, q, k, v and h, an sLSTM block's four float32 gates."""
    act = _bytes_of(rc.activation_dtype)
    d = cfg.d_model
    stream = tokens * d * (SERVE_STREAM_COPIES["activation"] * act
                           + SERVE_STREAM_COPIES["float32"] * 4) / split
    widths = {"attn": 2 * cfg.q_dim / heads + 2 * cfg.kv_dim,
              "mamba": 5 * cfg.d_inner / heads,
              "mlstm": 6 * int(cfg.mlstm_expand * d) / heads,
              "slstm": 4 * d * 4 / act}
    widest = max(max(widths[s.kind], 3 * cfg.d_ff / heads
                     if s.mlp == "dense" else 0) for s in cfg.pattern)
    return stream + tokens * widest * act


def estimate_bytes(cfg: ModelConfig, rc: RunConfig, mode: str,
                   batch: int, seq: int, mesh=None,
                   global_batch: Optional[int] = None) -> float:
    """An estimate of the step's peak bytes on the card, for choosing the
    depth: the state (:func:`_state_bytes_per_param`); in training the
    cost model's live activations of a microbatch under ``rc``'s remat
    policy and its float32 logits with their gradient; in serving the KV
    cache, the logits and one layer's live temporaries
    (:func:`_serve_layer_bytes`); and one layer's attention temporaries:
    unless attention is flash, its float32 scores (training keeps every
    chunk's for the layer's backward, scores, probabilities and their
    gradient; prefill four copies of one chunk's: the scores, the masked
    scores, their difference from the row maxima and its exponential),
    and in decode the keys and values of the kv heads the chip's q heads
    read, in float32 (and dequantized from an int8-sim cache), and three
    float32 copies of the scores, and a recurrent layer's state update
    (``DECODE_STATE_COPIES``).  A train step's update can peak above its
    backward (a wide MoE's expert leaves): there the state and the
    optimizer's float32 temporaries of the largest leaf
    (``UPDATE_TEMPORARIES``), or, with microbatches, the accumulated
    gradients' divided float32 copy; a serving cell's build can peak
    above its step: the state and the largest leaf's draw
    (``INIT_TEMPORARIES``).  The larger of the two phases is returned.

    With ``mesh`` (a virtual mesh: one chip's share) the state is the
    chip's blocks exactly (:func:`_chip_state`; in serving, of the decode
    state of ``global_batch`` rows too, whose caches are whole over the
    model axis where the kv heads do not divide it:
    :func:`_chip_decode_state_bytes`; ``batch`` is then the chip's rows
    and its logits the last token's, its vocab columns and the gathered
    whole vocab), and the activations
    beyond one whole block input a layer, the scores and the logits are
    divided where the model axis splits the heads (an SSM block's inner
    width: :func:`_tp_splits`; an sLSTM block's are whole) and the vocab;
    under
    sequence parallelism (``sequence_parallel_on`` for ``seq``) the block
    inputs (the stream between blocks) are divided by the model axis
    too; a MoE layer adds its experts' activations on the chip
    (:func:`_moe_layer_bytes`): every MoE layer's under remat ``none``,
    else the remat policy's fraction of them, and at least the one layer
    the backward recomputes (one layer in serving)."""
    train = mode == "train"
    if mesh is None:
        n_params = cfg.param_count()
        state = n_params * _state_bytes_per_param(rc, train)
        largest, heads, vocab = _largest_leaf(cfg), 1, 1
    else:
        state, n_params, largest = _chip_state(cfg, rc, mesh, train)
        heads, vocab = _tp_splits(cfg, rc, mesh)
    n = state
    micro = min(rc.microbatch or batch, batch) if train else batch
    if train:
        layer_io = 12 if cfg.has_attention else 8
        unit = micro * seq * cfg.d_model * _bytes_of(rc.activation_dtype)
        act = (unit * layer_io * REMAT_ACT_FRACTION[rc.remat_policy]
               * cfg.n_layers)
        if heads > 1:       # the block input is whole on every model rank
            whole = unit * cfg.n_layers * min(
                layer_io * REMAT_ACT_FRACTION[rc.remat_policy], 1.0)
            # but for sequence parallelism's: the rank's block of it
            split = mesh.shape["model"] if sequence_parallel_on(
                rc.shard, mesh, seq) else 1
            # an sLSTM block runs whole on every model rank
            n_whole = sum(s.kind == "slstm" for s in cfg.pattern) \
                * cfg.n_groups
            kept = (act - whole) * n_whole / cfg.n_layers
            act = whole / split + kept + (act - whole - kept) / heads
        if mesh is not None and cfg.has_moe:
            n_moe = sum(s.mlp == "moe" for s in cfg.pattern) * cfg.n_groups
            act += _moe_layer_bytes(cfg, rc, micro * seq, mesh) * max(
                n_moe * REMAT_ACT_FRACTION[rc.remat_policy], 1.0)
        n += act
        n += micro * seq * cfg.vocab_size * 4 * 2 / vocab
    else:
        tokens = batch * (1 if mode == "decode" else seq)
        split = mesh.shape["model"] if mesh is not None and mode != "decode" \
            and sequence_parallel_on(rc.shard, mesh, seq) else 1
        n += _serve_layer_bytes(cfg, rc, tokens, heads, split)
        if mesh is None:
            n += (2 * batch * seq * cfg.kv_dim
                  * _bytes_of(rc.kv_cache_dtype) * cfg.attn_layer_count)
            n += tokens * cfg.vocab_size * 4
        else:
            glob = global_batch or batch * data_parallel_size(rc.shard,
                                                              mesh.shape)
            n += _chip_decode_state_bytes(cfg, rc, mesh, glob, seq)
            n += batch * cfg.vocab_size * 4 * (1 + 1 / vocab)
            if cfg.has_moe:
                n += _moe_layer_bytes(cfg, rc, tokens, mesh)
    if cfg.has_attention:
        if mode == "decode":
            rows = seq if mesh is None else _cache_rows(cfg, rc, mesh, glob,
                                                        seq)
            q_heads = -(-cfg.n_heads // heads)
            kv_read = min(-(-q_heads * cfg.n_kv_heads // cfg.n_heads),
                          cfg.n_kv_heads)
            wide = 4 + (2 if rc.kv_cache_dtype == "int8" else 0)
            n += batch * rows * (2 * kv_read * cfg.resolved_head_dim * wide
                                 + 3 * q_heads * 4)
        elif rc.attention_impl != "flash":
            keys = seq if train or rc.attention_impl == "reference" \
                else min(seq, rc.chunk_size_k)
            n += ((3 if train else 4) * micro * -(-cfg.n_heads // heads)
                  * seq * keys * 4)
    if not train:
        if mode == "decode":
            n += DECODE_STATE_COPIES * _recurrent_state_bytes(cfg, batch)
        return max(n, state + INIT_TEMPORARIES * largest)
    divided = 4 * n_params if batch // micro > 1 else 0
    update = state + max(divided, UPDATE_TEMPORARIES[rc.optimizer] * 4
                         * largest)
    return max(n, update)


def _cache_rows(cfg: ModelConfig, rc: RunConfig, mesh, batch: int,
                seq: int) -> int:
    """The sequence rows of one chip's block of a cache of ``batch`` rows
    and ``seq`` positions (``attention.cache_block``)."""
    block = attention.cache_block(cfg, rc, mesh, batch, seq)
    return block.seq.stop - block.seq.start


def _chip_decode_state_bytes(cfg: ModelConfig, rc: RunConfig, mesh,
                             batch: int, seq: int) -> int:
    """Bytes of one chip's blocks of the decode state of ``batch`` rows
    and ``seq`` positions (``decode_state_placements``' local shapes)."""
    shapes = transformer.init_decode_state(batch, seq, cfg, rc,
                                           device="meta")
    pls = transformer.decode_state_placements(batch, seq, cfg, rc, mesh)
    return sum(math.prod(pl.local_shape(tuple(sh.shape))) * sh.element_size()
               for sh, pl in zip(tree_flatten(shapes)[0],
                                 tree_flatten(pls)[0]))


def mesh_batch(cell: ShapeCell, rc: RunConfig, mesh: Dict[str, int],
               rows: int) -> int:
    """The global batch of which one chip serves ``rows`` rows: ``rows``
    times the data-parallel size where the cell's batch divides it (the
    guard splits it over the data axes), else ``rows`` (every data rank
    serves the whole batch: long_500k's B = 1)."""
    dp = data_parallel_size(rc.shard, mesh)
    return rows * dp if cell.global_batch % dp == 0 else rows


class DoesNotFit(RuntimeError):
    """One layer period of a config needs more than ``FIT_FRACTION`` of
    the card (:func:`estimate_bytes`): the cell cannot run at any depth.
    ``need_bytes`` is the one-period estimate, ``room_bytes`` the share
    of the card it was held to."""

    def __init__(self, cfg: ModelConfig, mode: str, batch: int, seq: int,
                 need_bytes: float, room_bytes: float):
        self.need_bytes, self.room_bytes = need_bytes, room_bytes
        super().__init__(
            f"{cfg.name} {mode} B={batch} S={seq}: one period of "
            f"{len(cfg.pattern)} layer(s) needs {need_bytes / 1e9:.2f} GB "
            f"(estimate_bytes), above {FIT_FRACTION} of the card "
            f"({room_bytes / 1e9:.2f} GB)")


def fit_depth(cfg: ModelConfig, rc: RunConfig, hbm_bytes: float, *,
              mode: str = "train", batch: int = 1, seq: int = 1,
              mesh=None, global_batch: Optional[int] = None) -> int:
    """The deepest whole number of layer periods (at most the config's)
    whose :func:`estimate_bytes` under ``rc`` (at one chip's share of
    ``mesh`` when given) fits in ``FIT_FRACTION`` of ``hbm_bytes``;
    returned as a layer count.  Raises :class:`DoesNotFit` when not even
    one period fits."""
    period, room = len(cfg.pattern), FIT_FRACTION * hbm_bytes
    for groups in range(cfg.n_groups, 0, -1):
        need = estimate_bytes(cfg.scaled(n_layers=groups * period), rc,
                              mode, batch, seq, mesh, global_batch)
        if need <= room:
            return groups * period
    raise DoesNotFit(cfg, mode, batch, seq, need, room)


def replica_shape(cell: ShapeCell, rc: RunConfig, mesh: Dict[str, int],
                  reduce: Optional[Dict[str, int]] = None):
    """(batch, seq, cuts): one data-parallel replica's share of the cell,
    and ``reduce``'s cuts of it.  It is one chip's rows too: the model
    axis replicates its data rank's batch."""
    B = max(cell.global_batch // data_parallel_size(rc.shard, mesh), 1)
    S = cell.seq_len
    reduce = reduce or {}
    cuts = []
    if "batch" in reduce and reduce["batch"] != B:
        cuts.append(f"batch {B} -> {reduce['batch']}")
        B = reduce["batch"]
    if "seq" in reduce and reduce["seq"] != S:
        cuts.append(f"seq_len {S} -> {reduce['seq']}")
        S = reduce["seq"]
    return B, S, cuts


def production_chip(multi_pod: bool = False, device="cpu") -> VirtualMesh:
    """Chip (0, 0) (pod 0) of the production mesh, as a virtual mesh."""
    return make_virtual_mesh(make_production_mesh(multi_pod=multi_pod),
                             device=device)


def layout_covers(cfg: ModelConfig, cell: ShapeCell, rc: RunConfig, *,
                  multi_pod: bool = False) -> Optional[str]:
    """None when the port's layout runs this cell's step under ``rc`` on
    one chip of the production mesh, else the ROADMAP item it lacks: the
    item the step raises there (whisper's, in every mode).  Every block
    kind and every layout knob of a decoder-only family's train, prefill
    and decode cells is covered (``shard_kv_seq`` splits a decode cache's
    sequence over the data axis where its batch does not divide it).
    Decided from the config alone, before anything is built."""
    if cfg.is_encoder_decoder:
        return WHISPER_ITEM
    return None


def resolve_share(cfg: ModelConfig, cell: ShapeCell,
                  share: Optional[str] = None, *,
                  multi_pod: bool = False) -> str:
    """The share a cell runs at: ``share`` when given, else ``"chip"``
    where :func:`layout_covers` the cell under its family default (no
    knobs) and ``"replica"`` otherwise.  ``share="chip"`` on a cell the
    layout does not cover raises ``ValueError`` naming the item."""
    if share not in (None,) + SHARES:
        raise ValueError(f"share must be one of {SHARES} or None, got "
                         f"{share!r}")
    if share == "replica":
        return share
    item = layout_covers(cfg, cell, default_runconfig(cfg, cell),
                         multi_pod=multi_pod)
    if item is None:
        return "chip"
    if share == "chip":
        raise ValueError(f"{cfg.name} {cell.name}: one chip's share is not "
                         f"implemented: {item}")
    return "replica"


def cell_depth(cfg: ModelConfig, cell: ShapeCell, *,
               multi_pod: bool = False,
               reduce: Optional[Dict[str, int]] = None,
               hbm_bytes: float = rl.H100.hbm_bytes,
               share: Optional[str] = None) -> int:
    """The depth one cell is measured at when none is given: what
    :func:`fit_depth` picks for the family default (``default_runconfig``
    with no knobs) at the cell's share (:func:`resolve_share`).  It does
    not depend on the knobs, so every config of a cell runs the same
    model; a config whose step needs more than the family default's may
    run out of the card's memory at this depth (a failed evaluation).
    Raises :class:`DoesNotFit` when one period of the family default does
    not fit."""
    rc = default_runconfig(cfg, cell)
    chip = resolve_share(cfg, cell, share, multi_pod=multi_pod) == "chip"
    prod = make_production_mesh(multi_pod=multi_pod)
    B, S, _ = replica_shape(cell, rc, prod, reduce)
    return fit_depth(cfg, rc, hbm_bytes, mode=cell.mode, batch=B, seq=S,
                     mesh=production_chip(multi_pod) if chip else None,
                     global_batch=mesh_batch(cell, rc, prod, B))


@dataclasses.dataclass
class Lowered:
    """One cell's step built on the device: ``step()`` runs one step and
    returns the loss (train) or the logits."""
    step: Callable[[], torch.Tensor]
    cfg: ModelConfig                 # at the cut
    batch: int
    seq_len: int
    tokens: int                      # per step
    state_bytes: int                 # weights + optimizer or decode state
    batch_bytes: int
    reduced: List[str]
    grad_norms: List[torch.Tensor] = dataclasses.field(default_factory=list)
    # tokens of one step of the whole mesh (a chip's share), else None
    mesh_tokens: Optional[int] = None


def _nbytes(*trees) -> int:
    return sum(t.numel() * t.element_size() for tree in trees
               for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


def lower_cell(cfg: ModelConfig, cell: ShapeCell, rc: RunConfig,
               mesh, *, device, n_layers: int,
               reduce: Optional[Dict[str, int]] = None) -> Lowered:
    """Build one cell's step on ``device``: the model cut to ``n_layers``,
    weights (and optimizer state) from ``SEED``, and the share's batch
    (``reduce`` may cut its ``"batch"`` and ``"seq"``) as seeded random
    tokens.  ``mesh`` is the production mesh's axis sizes (a replica's
    share) or a virtual mesh (one chip's share: its blocks of the
    weights and of the optimizer or decode state, drawn alone, its rows
    of the batch, and every step run under it)."""
    dev = resolve_device(device)
    chip = isinstance(mesh, VirtualMesh)
    reduced = []
    if n_layers != cfg.n_layers:
        reduced.append(f"n_layers {cfg.n_layers} -> {n_layers}")
        cfg = cfg.scaled(n_layers=n_layers)
    B, S, cuts = replica_shape(cell, rc, mesh.shape if chip else mesh,
                               reduce)
    reduced += cuts
    model = Model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    width = 1 if cell.mode == "decode" else S + 1
    # a chip draws its tokens from its own vocab rows: a token outside
    # them would embed to zeros under the virtual reduce (its sum over the
    # model axis is this chip's share alone), whose RMS norm's gradient
    # overflows a few layers down; any tokens give the same shapes, FLOPs,
    # bytes and launches
    lo, hi = (compute_range(("vocab", "emb_embed"),
                            (cfg.vocab_size, cfg.d_model), 0, rc.shard, mesh)
              if chip else None) or (0, cfg.vocab_size)
    toks = torch.randint(lo, hi, (B, width), generator=gen, device=dev,
                         dtype=torch.int32)
    inputs = {"tokens": toks[:, :S]}
    if cfg.is_encoder_decoder:
        inputs["frames"] = torch.randn(
            (B, cfg.encoder_seq, cfg.d_model), generator=gen, device=dev,
            dtype=torch.bfloat16)
    on_mesh = mesh if chip else contextlib.nullcontext()
    # the global batch whose share the chip's B rows are
    B_g = mesh_batch(cell, rc, mesh.shape, B) if chip else B

    if cell.mode == "train":
        inputs["labels"] = toks[:, 1:]
        step_fn = make_train_step(model, rc, donate=True)
        box = [init_local_state(model, SEED, rc, mesh) if chip
               else init_state(model, SEED, rc)]
        state_bytes = _nbytes(box[0])
        norms: List[torch.Tensor] = []

        def step():
            with on_mesh:
                box[0], metrics = step_fn(box[0], inputs)
            norms.append(metrics["grad_norm"])
            return metrics["loss"]
        return Lowered(step, cfg, B, S, B * S, state_bytes,
                       _nbytes(inputs), reduced, norms,
                       mesh_tokens=B_g * S if chip else None)

    params = model.init_blocks(SEED, param_placements(model, rc, mesh),
                               mesh.rank) if chip else model.init(SEED)
    if cell.mode == "prefill":
        @torch.no_grad()
        def step():
            with on_mesh:
                return model.prefill(params, inputs, S, rc, batch=B_g)[0]
        return Lowered(step, cfg, B, S, B * S, _nbytes(params),
                       _nbytes(inputs), reduced,
                       mesh_tokens=B_g * S if chip else None)

    # decode: one token against an S-long cache (S - 1 tokens already in)
    if cfg.is_encoder_decoder:
        state = model.init_decode_state(inputs, B, S, rc, params)
    elif chip:
        state = init_local_decode_state(model, B_g, S, rc, mesh)
    else:
        state = model.init_decode_state(B, S, rc)
    state = state._replace(pos=torch.full_like(state.pos, S - 1))

    @torch.no_grad()
    def step():
        with on_mesh:
            return model.decode_step(params, toks, state, rc)[0]
    return Lowered(step, cfg, B, S, B, _nbytes(params, state),
                   _nbytes(toks), reduced,
                   mesh_tokens=B_g if chip else None)


@functools.lru_cache(maxsize=None)
def card_name(index: int = 0) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(index)}, power limit unknown"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _measure(cfg, cell, rc, mesh, dev, n_layers, steps, reduce) -> Dict:
    """Build, warm up (counted), time; the record's measured part.  Every
    tensor of the cell lives in this frame and goes when it returns."""
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    low = lower_cell(cfg, cell, rc, mesh, device=dev, n_layers=n_layers,
                     reduce=reduce)
    counts, first = rl.count_step(low.step)
    _sync(dev)
    compile_s = time.monotonic() - t0
    finite = bool(torch.isfinite(first).all())
    train = cell.mode == "train"
    losses, times = [first], []         # train: each step's scalar loss
    for _ in range(steps):
        t = time.perf_counter()
        out = low.step()
        _sync(dev)
        times.append(time.perf_counter() - t)
        if train:
            losses.append(out)
    finite = finite and bool(torch.isfinite(out).all())
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    return {"low": dataclasses.replace(low, step=None, grad_norms=[]),
            "counts": counts, "compile_s": compile_s, "times": times,
            "losses": [float(x) for x in losses] if train else None,
            "grad_norm": float(low.grad_norms[0]) if train else None,
            "outputs_finite": finite, "peak": peak}


def compile_cell(cfg: ModelConfig, cell: ShapeCell,
                 knobs: Optional[Dict] = None, *, multi_pod: bool = False,
                 device="cuda", n_layers: Optional[int] = None,
                 steps: int = 2, reduce: Optional[Dict[str, int]] = None,
                 verbose: bool = False, share: Optional[str] = None) -> Dict:
    """Build, run and time one cell on ``device`` at its share
    (:func:`resolve_share`: one chip's where the layout covers the cell,
    else one replica's); return the record.

    Under the chip share a config whose layout the port does not
    implement there (``layout_covers``: whisper's) raises ``ValueError``
    naming the ROADMAP item, before anything is built.  With no ``n_layers``, a cell one period of which does not fit
    the card raises :class:`DoesNotFit` (with the bytes it would need)
    before anything is allocated.  A step that runs out of the card's
    memory raises ``torch.cuda.OutOfMemoryError`` (its state is dropped,
    never reused); every tensor of the cell is freed and the allocator's
    cache emptied before this returns or raises."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    dev = resolve_device(device)
    share = resolve_share(cfg, cell, share, multi_pod=multi_pod)
    prod = make_production_mesh(multi_pod=multi_pod)
    rc = default_runconfig(cfg, cell, knobs)
    train = cell.mode == "train"
    mesh = prod
    if share == "chip":
        item = layout_covers(cfg, cell, rc, multi_pod=multi_pod)
        if item is not None:
            raise ValueError(f"{cfg.name} {cell.name}: this config's layout "
                             f"on one chip of the {_mesh_tag(multi_pod)} "
                             f"mesh is not implemented: {item}")
        mesh = make_virtual_mesh(prod, device=dev)
    if n_layers is None:
        n_layers = cell_depth(cfg, cell, multi_pod=multi_pod, reduce=reduce,
                              share=share)
    failure = None
    try:
        m = _measure(cfg, cell, rc, mesh, dev, n_layers, steps, reduce)
    except Exception as e:            # noqa: BLE001 -- re-raised below
        # the traceback holds the step's frames (and their tensors): keep
        # its text, drop the frames so the memory goes before the error
        # travels on (an evaluation service keeps the exception)
        text = "".join(traceback.format_exception(e))
        failure = e.with_traceback(None)
        failure.add_note(f"raised in the step:\n{text}")
    finally:
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if failure is not None:
        raise failure

    low, counts = m["low"], m["counts"]
    report = rl.report_from_counts(counts.flops, counts.hbm_bytes,
                                   counts.coll_by_kind, rl.H100)
    measured = statistics.median(m["times"])
    chip = share == "chip"
    # the chips the step's work is spread over, and the tokens of one
    # step of the whole mesh (the reference's 6ND)
    chips = (512 if multi_pod else 256) if chip else 1
    tokens = low.mesh_tokens if chip else low.tokens
    mflops = rl.model_flops(low.cfg.active_param_count(), tokens, train)
    cuda = dev.type == "cuda"
    fast, slow = sorted((measured, report.collective_s))
    record = {
        "arch": cfg.name, "shape": cell.name,
        "mesh": _mesh_tag(multi_pod) if chip else _device_tag(dev),
        "chips": chips,
        "chip": mesh.coords if chip else None,
        "share": share,
        # whether the chip's stream was split along the sequence (the
        # knob, and the sequence a multiple of the model axis; a decode
        # step's one token never is)
        "sequence_parallel": chip and cell.mode != "decode"
        and sequence_parallel_on(rc.shard, mesh, low.seq_len),
        "mode": cell.mode,
        "compile_s": m["compile_s"],
        "memory": {
            "state_size_gb": low.state_bytes / 2**30,
            "batch_size_gb": low.batch_bytes / 2**30,
            "max_memory_allocated_gb":
                m["peak"] / 2**30 if m["peak"] is not None else None,
            "estimated_gb": estimate_bytes(
                low.cfg, rc, cell.mode, low.batch, low.seq_len,
                mesh if chip else None,
                mesh_batch(cell, rc, prod, low.batch)) / 2**30,
        },
        "roofline": {
            "flops_per_device": report.flops,
            "hbm_bytes_per_device": report.bytes_proxy,
            "collective_bytes_per_device": report.collective_bytes,
            "coll_by_kind": report.coll_by_kind,
            "compute_s": report.compute_s,
            "memory_s": report.memory_s,
            "collective_s": report.collective_s,
            "step_s": report.step_s,
            "dominant": report.dominant,
            "trip_counts": report.trip_counts,
            "kernel_flops": counts.kernel_flops,
            "kernel_bytes": counts.kernel_bytes,
            "hbm_bytes_by_device": counts.bytes_by_device,
        },
        "model_flops_6nd": mflops,
        "useful_flops_ratio": mflops / (counts.flops * chips)
        if counts.flops else None,
        "raw_cost_analysis_flops": None,      # no XLA cost analysis
        "runconfig": {k: getattr(rc, k) for k in
                      ("microbatch", "remat_policy", "attention_impl",
                       "optimizer", "master_weights_f32",
                       "grad_allreduce_dtype")},
        "measured_step_s": measured,
        # the reference's combine rule over the measured step (in place
        # of its compute and memory terms) and the priced collectives
        "scored_step_s": slow + 0.15 * fast,
        "step_times_s": m["times"],
        "tokens_per_s": low.tokens / measured,
        # a CPU time is no card's utilisation
        "mfu": mflops / chips / (measured * rl.H100.peak_flops)
        if cuda else None,
        # every step's loss on the one batch, the warm-up's (step 1's,
        # before any update) first, and step 1's gradient norm
        "step1_loss": m["losses"][0] if train else None,
        "step_losses": m["losses"],
        "step1_grad_norm": m["grad_norm"],
        "outputs_finite": m["outputs_finite"],
        "batch": low.batch, "seq_len": low.seq_len, "tokens": low.tokens,
        "n_layers": low.cfg.n_layers,
        "reduced": low.reduced,
        "card": card_name(dev.index or 0) if cuda else "cpu",
    }
    if verbose:
        print(json.dumps(record, indent=1, default=str))
    return record


def _mesh_tag(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _device_tag(dev: torch.device) -> str:
    return "1xH100" if dev.type == "cuda" else "1xCPU"


def _artifact(arch: str, shape: str, multi_pod: bool, share: str,
              dev: torch.device) -> Path:
    """A record's file: ``<arch>.<shape>[.multi-pod].<mesh>-chip.1xH100``
    for a chip's share, ``<arch>.<shape>[.multi-pod].1xH100`` for a
    replica's (``1xCPU`` off the card); never the reference's
    ``<mesh>.json``."""
    pod = ".multi-pod" if multi_pod else ""
    chip = f".{_mesh_tag(multi_pod)}-chip" if share == "chip" else ""
    return ARTIFACTS / (f"{canonical(arch)}.{shape}{pod}{chip}."
                        f"{_device_tag(dev)}.json")


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             knobs: Optional[Dict] = None, save: bool = True,
             verbose: bool = True, device="cuda",
             n_layers: Optional[int] = None,
             share: Optional[str] = None) -> Dict:
    cfg = get_config(arch)
    cell = SHAPES_BY_NAME[shape]
    if cell not in applicable_shapes(cfg):
        rec = {"arch": cfg.name, "shape": shape, "skipped": True,
               "reason": "full-attention arch skips long_500k (DESIGN.md §6)"}
        print(f"SKIP {arch} {shape}: {rec['reason']}")
        return rec
    rec = compile_cell(cfg, cell, knobs, multi_pod=multi_pod, device=device,
                       n_layers=n_layers, verbose=verbose, share=share)
    if save:
        ARTIFACTS.mkdir(parents=True, exist_ok=True)
        out = _artifact(arch, shape, multi_pod, rec["share"],
                        resolve_device(device))
        out.write_text(json.dumps(rec, indent=1, default=str))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth to cut to (default: what fits the card)")
    ap.add_argument("--share", choices=SHARES, default=None,
                    help="one chip's share of the mesh or one replica's "
                         "(default: the chip's where the port's layout "
                         "covers the cell)")
    ap.add_argument("--knob", action="append", default=[],
                    help="a SAPPHIRE knob over the family default, e.g. "
                         "--knob sequence_parallel=true (the record keeps "
                         "its file name: the knobs are in its runconfig)")
    args = ap.parse_args(argv)
    knobs = parse_knobs(args.knob) or None

    cells = []
    if args.all:
        for a in ARCH_IDS:
            cfg = get_config(a)
            for cell in applicable_shapes(cfg):
                cells.append((a, cell.name))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]
    dev = resolve_device(args.device)

    failures = []
    for mp in meshes:
        for arch, shape in cells:
            tag = f"{arch} {shape} {_device_tag(dev)}" \
                  f"{' multi-pod' if mp else ''}"
            try:
                share = resolve_share(get_config(arch), SHAPES_BY_NAME[shape],
                                      args.share, multi_pod=mp)
                if args.skip_existing and _artifact(arch, shape, mp, share,
                                                    dev).exists():
                    print(f"SKIP (cached) {tag}")
                    continue
                print(f"=== {tag} ({share} share) ===", flush=True)
                rec = run_cell(arch, shape, multi_pod=mp, verbose=False,
                               device=args.device, n_layers=args.layers,
                               share=share, knobs=knobs)
                if not rec.get("skipped"):
                    r, mem = rec["roofline"], rec["memory"]
                    mfu, peak = rec["mfu"], mem["max_memory_allocated_gb"]
                    print(f"  ok mesh={rec['mesh']} chips={rec['chips']} "
                          f"n_layers={rec['n_layers']} "
                          f"compile={rec['compile_s']:.2f}s "
                          f"measured={rec['measured_step_s']:.4f}s "
                          f"scored={rec['scored_step_s']:.4f}s "
                          f"tokens/s={rec['tokens_per_s']:.1f} "
                          f"mfu={'n/a' if mfu is None else f'{mfu:.4f}'} "
                          f"roofline step={r['step_s']:.4f}s "
                          f"dominant={r['dominant']} "
                          f"(c={r['compute_s']:.4f} m={r['memory_s']:.4f} "
                          f"x={r['collective_s']:.4f}; {r['coll_by_kind']}) "
                          f"peak={'n/a' if peak is None else f'{peak:.2f}'}"
                          f" GiB (estimated {mem['estimated_gb']:.2f}) "
                          f"reduced={rec['reduced']}", flush=True)
            except Exception as e:
                failures.append((tag, repr(e)))
                print(f"  FAIL: {e}\n{traceback.format_exc()}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e)
        raise SystemExit(1)
    print("\nall cells ran")


if __name__ == "__main__":
    main()

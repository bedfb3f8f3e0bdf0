"""Unified Model API over decoder-only LMs and the encoder-decoder
(whisper) family (from ``repro.models.model``).

The serving engine and the launchers talk to this facade:

    m = Model(cfg, device="cuda")
    params            = m.init(seed)                  # or params_from_numpy
    loss, metrics     = m.loss(params, batch, rc)
    logits, state     = m.prefill(params, inputs, s_max, rc)
    logits, state     = m.decode_step(params, token, state, rc)

``inputs`` holds ``"tokens"`` [B, S], and for whisper also ``"frames"``
[B, T_enc, d_model] (the stub frontend's frame embeddings).  Tensors live
on ``m.device``: the card unless the caller asks for the CPU, and never a
silent fallback.  Every family of the reference is served: the dense,
MoE, hybrid (mamba) and xLSTM decoder stacks (``models/transformer.py``)
and whisper (``models/whisper.py``); decode states hold attention caches
or recurrent states, updated in place.  ``loss`` is the training
objective (``train/train_loop.py`` differentiates it with autograd): the
decoder stacks' next-token cross-entropy plus the MoE aux loss, whisper's
teacher-forced cross-entropy over its encoder.

``param_axes`` / ``decode_state_axes`` are the reference's logical axes
and ``param_shapes`` the parameters as meta tensors; ``init_blocks``
draws one rank's blocks of random parameters without building the
global leaves (a chip of a model no card holds whole); ``shard_tree`` and
``gather_tree`` take a global tree (the reference's numpy parameters, a
one-process state) to a rank's blocks of its ``Placement`` s and back,
and ``gather_tree_to_host`` builds the global tree on rank 0's host
alone (a checkpoint's save).
Under an ambient mesh (a process mesh, or a virtual one: one chip's
share) ``loss``, ``prefill`` and ``decode_step`` of a decoder stack are
the reference's functions computed across the ranks
(``models/transformer.py``): the parameters are this rank's blocks, the
inputs its rows, the decode state its blocks of a global one
(:func:`decode_state_placements`, drawn by
:func:`init_local_decode_state` or left by ``prefill``) and the logits its
rows over the whole vocab.  Whisper raises ``ValueError`` there
(``WHISPER_ITEM``).
"""

from __future__ import annotations

import hashlib
from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer, whisper
from repro_torch.models import attention
from repro_torch.models.common import (InitRecorder, MetaGenerator,
                                       tree_flatten, tree_map, tree_unflatten,
                                       trunc_normal_std)
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import WHISPER_ITEM, ambient_mesh, world_of
from repro_torch.runconfig import RunConfig


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: exact through f32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self._ed = cfg.is_encoder_decoder
        self.device = resolve_device(device)

    # ---- parameters -------------------------------------------------------

    def init(self, seed: int = 0, dtype=torch.bfloat16):
        """Random parameters made on ``self.device`` from a
        ``torch.Generator`` seeded with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        mod = whisper if self._ed else transformer
        return mod.init(gen, self.cfg, dtype)

    def init_blocks(self, seed: int, placements, rank: int,
                    dtype=torch.bfloat16):
        """Rank ``rank``'s blocks of random parameters laid out by
        ``placements`` (``init``'s structure, one ``Placement`` per leaf),
        made on ``self.device`` with no global leaf built: each block of a
        truncated-normal leaf is drawn at its block's shape with the
        global leaf's scale (its fan-in from the global shape), from a
        generator seeded by ``seed``, the leaf and the block, so ranks
        that hold the same block hold the same numbers; the constant
        leaves (zeros, ones) are built whole on the host and sliced.  The
        numbers are not ``init``'s."""
        rec = InitRecorder()
        mod = whisper if self._ed else transformer
        leaves, treedef = tree_flatten(mod.init(rec, self.cfg, dtype))
        pls = tree_flatten(placements)[0]
        if len(pls) != len(leaves):
            raise ValueError(f"{len(leaves)} leaves, {len(pls)} placements")
        out = []
        for i, (x, pl) in enumerate(zip(leaves, pls)):
            shape = tuple(x.shape)
            if id(x) not in rec.std:
                out.append(x[pl.index(shape, rank)].to(self.device).clone(
                    memory_format=torch.contiguous_format))
                continue
            blocks = tuple(pl.block(d, rank) for d in range(len(shape)))
            key = hashlib.sha256(repr((seed, i, blocks)).encode()).digest()
            gen = torch.Generator(device=self.device).manual_seed(
                int.from_bytes(key[:8], "little") >> 1)
            out.append(trunc_normal_std(gen, pl.local_shape(shape),
                                        rec.std[id(x)], x.dtype))
        return tree_unflatten(treedef, out)

    def param_axes(self):
        """The logical sharding axes of ``init``'s tree."""
        mod = whisper if self._ed else transformer
        return mod.axes(self.cfg)

    def param_shapes(self, dtype=torch.bfloat16):
        """``init``'s tree as meta tensors (global shapes, no storage)."""
        if self._ed:
            return whisper.init(MetaGenerator(), self.cfg, dtype)
        return transformer.param_shapes(self.cfg, dtype)

    def params_from_numpy(self, tree):
        """Load a reference parameter tree (leaves as numpy arrays, bf16
        included) onto ``self.device``, unchanged in layout and dtype: a
        decoder stack's ``{"embed", "final_norm", "layers": [stacked per
        pattern position], "head"}`` or whisper's ``{"embed", "encoder",
        "enc_norm", "decoder", "final_norm"}``; float32 leaves (the xLSTM's
        gates and sLSTM bias, the MoE router, mamba's ``a_log`` and
        ``d_skip``) stay float32."""
        return tree_map(lambda a: _tensor(a).to(self.device), tree)

    def _on_device(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return _tensor(x).to(self.device)

    # ---- training ---------------------------------------------------------

    def loss(self, params, batch: Dict[str, object], rc: RunConfig):
        """(loss, {"nll", "aux"}) of a batch: tokens and labels [B, S],
        ``positions`` [3, B, S] for M-RoPE, whisper's ``frames``
        [B, T_enc, d_model]; numpy leaves are moved to ``self.device``."""
        batch = {k: self._on_device(v) for k, v in batch.items()}
        mod = whisper if self._ed else transformer
        return mod.loss_fn(params, batch, self.cfg, rc)

    # ---- serving ----------------------------------------------------------

    def prefill(self, params, inputs: Dict[str, object], s_max: int,
                rc: RunConfig, *, batch=None):
        """(last-token logits [B,1,V], decode state at pos = S).  On a mesh
        ``inputs`` are this rank's rows of a global batch of ``batch``
        rows (``transformer.prefill``)."""
        self._refuse_mesh("prefill")
        tokens = self._on_device(inputs["tokens"])
        if self._ed:
            # encode + teacher-forced full-sequence decoder pass, caches
            # filled
            return whisper.prefill(params, tokens,
                                   self._on_device(inputs["frames"]), s_max,
                                   self.cfg, rc)
        return transformer.prefill(params, tokens, s_max, self.cfg, rc,
                                   batch=batch)

    def init_decode_state(self, *args, params=None):
        """Decode state of ``batch`` slots for ``s_max`` tokens.  The
        decoder-only call is ``(batch, s_max, rc)``; the reference's
        ``(inputs, batch, s_max, rc, params)`` serves every family
        (whisper encodes ``inputs["frames"]`` with ``params``)."""
        if isinstance(args[0], dict):
            inputs, batch, s_max, rc, *rest = args
            params = rest[0] if rest else params
        else:
            inputs, (batch, s_max, rc) = {}, args
        if self._ed:
            return whisper.init_decode_state(
                params, self._on_device(inputs["frames"]), batch, s_max,
                self.cfg, rc)
        return transformer.init_decode_state(batch, s_max, self.cfg, rc,
                                             device=self.device)

    def decode_state_axes(self, rc: RunConfig):
        """The logical axes of the decode state (the reference's)."""
        if self._ed:
            ax, _ = attention.cache_axes(rc)
            stacked = (None,) + tuple(ax)
            return whisper.WhisperDecodeState(
                self_k=stacked, self_v=stacked, cross_k=stacked,
                cross_v=stacked, pos=())
        return transformer.decode_state_axes(self.cfg, rc)

    def decode_step(self, params, token, state, rc: RunConfig):
        self._refuse_mesh("decode_step")
        mod = whisper if self._ed else transformer
        return mod.decode_step(params, self._on_device(token), state,
                               self.cfg, rc)

    def _refuse_mesh(self, what: str) -> None:
        mesh = ambient_mesh()
        if self._ed and mesh is not None and world_of(mesh) > 1:
            raise ValueError(f"whisper's {what} on a mesh of "
                             f"{world_of(mesh)} ranks is not implemented: "
                             f"{WHISPER_ITEM}")


def decode_state_placements(model: Model, batch: int, s_max: int,
                            rc: RunConfig, mesh=None):
    """Each leaf's ``Placement`` in the decode state of ``batch`` rows and
    ``s_max`` positions on ``mesh`` (the ambient one by default): the
    reference's ``shardings_for(decode_state_axes)``
    (``transformer.decode_state_placements``)."""
    mesh = mesh if mesh is not None else ambient_mesh()
    return transformer.decode_state_placements(batch, s_max, model.cfg, rc,
                                               mesh)


def init_local_decode_state(model: Model, batch: int, s_max: int,
                            rc: RunConfig, mesh=None):
    """This rank's blocks of the empty decode state of ``batch`` rows and
    ``s_max`` positions on ``mesh`` (the ambient one by default), each
    leaf made at its ``Placement.local_shape`` on ``model.device``: no
    global cache is built (``transformer.init_local_decode_state``), the
    counterpart of ``train_loop.init_local_state``."""
    mesh = mesh if mesh is not None else ambient_mesh()
    if model.cfg.is_encoder_decoder:
        raise ValueError(f"whisper's decode state on a mesh is not "
                         f"implemented: {WHISPER_ITEM}")
    return transformer.init_local_decode_state(batch, s_max, model.cfg, rc,
                                               mesh, device=model.device)


def shard_tree(tree, placements, rank: int):
    """Rank ``rank``'s blocks of every leaf of a global ``tree`` (torch
    tensors or numpy arrays; numpy leaves come back as tensors on the
    CPU), each its own contiguous copy.  ``placements`` has ``tree``'s
    structure, one ``Placement`` per leaf."""
    leaves, treedef = tree_flatten(tree)
    pls = tree_flatten(placements)[0]
    if len(pls) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves, {len(pls)} placements")
    out = []
    for x, pl in zip(leaves, pls):
        if not isinstance(x, torch.Tensor):
            x = _tensor(x)
        out.append(x[pl.index(tuple(x.shape), rank)].clone(
            memory_format=torch.contiguous_format))
    return tree_unflatten(treedef, out)


def gather_tree_to_host(tree, placements, mesh):
    """The global tree on rank 0's host, None on every other rank (a
    collective: every rank calls it), gathered one leaf at a time
    (``collectives.gather_to_host``): no rank holds the global tree on
    its device, so a state sharded because it fits on no one card is
    saved as the one-process launcher saves it, from host memory."""
    leaves, treedef = tree_flatten(tree)
    pls = tree_flatten(placements)[0]
    out = [collectives.gather_to_host(x, pl, mesh)
           for x, pl in zip(leaves, pls)]
    return tree_unflatten(treedef, out) if mesh.rank == 0 else None


def gather_tree(tree, placements, mesh=None):
    """The global tree from every rank's blocks (a collective: every
    rank calls it and gets the whole tree) on the ambient mesh by
    default."""
    mesh = mesh if mesh is not None else ambient_mesh()
    leaves, treedef = tree_flatten(tree)
    pls = tree_flatten(placements)[0]
    out = []
    for x, pl in zip(leaves, pls):
        for d in range(x.dim()):
            if pl.dim_axes(d):
                x = collectives.gather(x, d, pl.dim_axes(d), mesh)
        out.append(x)
    return tree_unflatten(treedef, out)

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
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer, whisper
from repro_torch.models.common import tree_map
from repro_torch.models.config import ModelConfig
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
                rc: RunConfig):
        tokens = self._on_device(inputs["tokens"])
        if self._ed:
            # encode + teacher-forced full-sequence decoder pass, caches
            # filled
            return whisper.prefill(params, tokens,
                                   self._on_device(inputs["frames"]), s_max,
                                   self.cfg, rc)
        return transformer.prefill(params, tokens, s_max, self.cfg, rc)

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

    def decode_step(self, params, token, state, rc: RunConfig):
        mod = whisper if self._ed else transformer
        return mod.decode_step(params, self._on_device(token), state,
                               self.cfg, rc)

"""Model API over decoder-only LMs (from ``repro.models.model``).

The serving engine and the launchers talk to this facade:

    m = Model(cfg, device="cuda")
    params            = m.init(seed)                  # or params_from_numpy
    logits, state     = m.prefill(params, inputs, s_max, rc)
    logits, state     = m.decode_step(params, token, state, rc)

Tensors live on ``m.device``: the card unless the caller asks for the
CPU, and never a silent fallback.  The decoder-only dense family and the
xLSTM family (mLSTM / sLSTM blocks; the mLSTM sequence pass in the
chunkwise CUDA kernel) are ported; their decode states hold attention
caches or recurrent states, updated in place.  Mamba and MoE blocks, the
encoder-decoder family (whisper) and the loss/train path are not ported
yet (ROADMAP queue A, items 14b and 15).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer
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
        if cfg.is_encoder_decoder:
            raise NotImplementedError(
                f"{cfg.name}: the encoder-decoder family (models/whisper.py)"
                " is not ported yet: ROADMAP queue A, item 14b")
        transformer.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    # ---- parameters -------------------------------------------------------

    def init(self, seed: int = 0, dtype=torch.bfloat16):
        """Random parameters made on ``self.device`` from a
        ``torch.Generator`` seeded with ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return transformer.init(gen, self.cfg, dtype)

    def params_from_numpy(self, tree):
        """Load a reference parameter tree (``{"embed", "final_norm",
        "layers": [stacked per pattern position], "head"}``, leaves as
        numpy arrays, bf16 included) onto ``self.device``, unchanged in
        layout and dtype (an xLSTM tree keeps its float32 gate and sLSTM
        bias leaves)."""
        return tree_map(lambda a: _tensor(a).to(self.device), tree)

    # ---- serving ----------------------------------------------------------

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device)

    def prefill(self, params, inputs: Dict[str, object], s_max: int,
                rc: RunConfig):
        return transformer.prefill(params, self._tokens(inputs["tokens"]),
                                   s_max, self.cfg, rc)

    def init_decode_state(self, batch: int, s_max: int, rc: RunConfig):
        return transformer.init_decode_state(batch, s_max, self.cfg, rc,
                                             device=self.device)

    def decode_step(self, params, token, state, rc: RunConfig):
        return transformer.decode_step(params, self._tokens(token), state,
                                       self.cfg, rc)

"""Dense MLP: SwiGLU (silu) or plain GeLU variants (from
``repro.models.mlp``)."""

from __future__ import annotations

import torch

from repro_torch.models.common import (activation, dense_apply, dense_init,
                                       reduce_dtype)
from repro_torch.models.config import ModelConfig
from repro_torch.runconfig import RunConfig


def init(gen: torch.Generator, cfg: ModelConfig, d_ff=None,
         dtype=torch.bfloat16, stack: int = 0):
    f = d_ff if d_ff is not None else cfg.d_ff
    d = cfg.d_model
    kw = dict(bias=cfg.mlp_bias, dtype=dtype, stack=stack)
    if cfg.act == "silu":
        return {
            "gate": dense_init(gen, d, f, **kw),
            "up": dense_init(gen, d, f, **kw),
            "down": dense_init(gen, f, d, **kw),
        }
    return {
        "up": dense_init(gen, d, f, **kw),
        "down": dense_init(gen, f, d, **kw),
    }


def apply(params, x, cfg: ModelConfig, rc: RunConfig):
    act = activation(cfg.act)
    red = reduce_dtype(rc)
    if "gate" in params:
        h = act(dense_apply(params["gate"], x, preferred=red)) \
            * dense_apply(params["up"], x, preferred=red)
    else:
        h = act(dense_apply(params["up"], x, preferred=red))
    return dense_apply(params["down"], h, preferred=red)

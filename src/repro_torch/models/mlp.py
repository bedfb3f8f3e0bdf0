"""Dense MLP: SwiGLU (silu) or plain GeLU variants (from
``repro.models.mlp``)."""

from __future__ import annotations

import torch

from repro_torch.models.common import (activation, column_input,
                                       dense_apply, dense_axes, dense_init,
                                       reduce_dtype, replicated)
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import ambient_mesh, compute_range
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


def axes(cfg: ModelConfig):
    b = cfg.mlp_bias
    if cfg.act == "silu":
        return {
            "gate": dense_axes("ff_in", "ff", bias=b),
            "up": dense_axes("ff_in", "ff", bias=b),
            "down": dense_axes("ff", "o_out", bias=b),
        }
    return {
        "up": dense_axes("ff_in", "ff", bias=b),
        "down": dense_axes("ff", "o_out", bias=b),
    }


def apply(params, x, cfg: ModelConfig, rc: RunConfig,
          seq_parallel: bool = False, d_ff=None):
    """The MLP; on a mesh whose model axis splits ff, the gate and up
    projections are column-parallel (their input under Megatron's f,
    ``column_input``) and the down projection row-parallel
    (Megatron).  With ``seq_parallel`` ``x`` is this rank's block of the
    sequence: the column projections read the gathered sequence and the
    down projection's sums are reduce-scattered back to the block; an MLP
    whose ff the model axis does not split runs on the block itself (it
    is per token), its weights under ``common.replicated``.  ``d_ff`` is
    the hidden width when it is not ``cfg.d_ff`` (a MoE's shared
    experts)."""
    act = activation(cfg.act)
    red = reduce_dtype(rc)
    f = d_ff if d_ff is not None else cfg.d_ff
    split = compute_range(("ff_in", "ff"), (cfg.d_model, f), 1,
                          rc.shard) is not None
    mesh = ambient_mesh()
    if seq_parallel and not split:
        params = replicated(params, mesh)
    col = column_input(x, red, mesh, seq_parallel) if split else lambda: x
    if "gate" in params:
        h = act(dense_apply(params["gate"], col(), preferred=red)) \
            * dense_apply(params["up"], col(), preferred=red)
    else:
        h = act(dense_apply(params["up"], col(), preferred=red))
    return dense_apply(params["down"], h, preferred=red,
                       row_parallel=split, seq_parallel=seq_parallel)

"""RunConfig: the *execution* configuration of a training/serving step.

This is the typed destination of SAPPHIRE's tunable knobs — the analogue of
a Ceph config file after constraint resolution (from ``repro.runconfig``;
the same fields and defaults, so a knob dict means the same in both
packages).  ``ModelConfig`` describes
*what* to compute; ``RunConfig`` describes *how*: parallel layout,
microbatching, rematerialization, kernel selection and block sizes, dtypes,
collective behavior.  Every field maps 1:1 to one or more knobs in
``repro.core.knobs`` (C1-washed, C2-bounded, C3-gated, C4-projected).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict

from repro_torch.parallel.sharding import ShardConfig, shard_config_from_knobs


@dataclass(frozen=True)
class RunConfig:
    # ---- distribution layout (module-selector knobs, C3) ----
    shard: ShardConfig = ShardConfig()

    # ---- step structure ----
    microbatch: int = 0               # 0 = no grad accumulation (single shot)
    remat_policy: str = "none"        # none | dots | block | full
    grad_accum_unroll: bool = False   # unroll the accumulation loop

    # ---- attention ----
    attention_impl: str = "reference"  # reference | chunked | flash
    flash_block_q: int = 512           # MXU-aligned (C2: multiple of 128)
    flash_block_k: int = 512
    chunk_size_k: int = 2048           # chunked (online-softmax) KV chunk

    # ---- numerics ----
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    accum_dtype: str = "float32"
    matmul_precision: str = "default"  # default | high | highest
    grad_allreduce_dtype: str = "float32"  # float32 | bfloat16 (compression)
    tp_reduce_dtype: str = "float32"   # dtype of TP partial-sum reductions:
                                       # bfloat16 halves the activation
                                       # all-reduce bytes (Megatron-style)

    # ---- optimizer ----
    optimizer: str = "adamw"           # adamw | adafactor
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip_norm: float = 1.0
    master_weights_f32: bool = True

    # ---- MoE ----
    moe_capacity_factor: float = 1.25
    moe_impl: str = "dense"            # dense (einsum over experts) | dropping

    # ---- SSM / xLSTM ----
    ssm_chunk: int = 256               # chunked-scan chunk length
    mlstm_chunk: int = 256

    # ---- serving ----
    kv_cache_dtype: str = "bfloat16"   # bfloat16 | int8 (simulated quant)
    kv_layout: str = "bshd"            # bshd | bhsd
    prefill_chunk: int = 0             # 0 = single-shot prefill
    decode_batch_tile: int = 0         # 0 = whole batch at once

    # ---- collectives ----
    allreduce_per_microbatch: bool = False  # overlap grads w/ next microbatch
    pod_hierarchical_allreduce: bool = True

    # ---- inert telemetry knobs (Ceph debug_* analogues; never read by the
    #      step function — SAPPHIRE's washing/ranking must discover this) ----
    telemetry_interval_steps: int = 100
    log_verbosity: int = 1
    profiler_trace_steps: int = 0
    checkpoint_interval_steps: int = 1000

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


def runconfig_from_knobs(knobs: Dict[str, object]) -> RunConfig:
    """Build a RunConfig from a flat knob dict (post constraint-resolution).

    Unknown knobs are ignored (they may belong to other subsystems); gated
    knobs arrive already projected by the constraint solver.
    """
    base = RunConfig()
    fields = {f.name for f in dataclasses.fields(RunConfig)}
    kw = {}
    for k, v in knobs.items():
        if k in fields:
            kw[k] = v
    kw["shard"] = shard_config_from_knobs(knobs)
    return dataclasses.replace(base, **kw)

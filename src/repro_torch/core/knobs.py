"""The raw TPU-fleet knob space SAPPHIRE tunes (DESIGN.md §5).

Mirrors the structure of Ceph's 1536-knob space at framework scale
(~380 knobs here):

* ~40 performance knobs that the step function / cost model actually read
  (mapped 1:1 onto ``RunConfig`` of the JAX reference package);
* module-selector knobs (C3) gating implementation-specific sub-knobs, the
  ``osd_objectstore`` analogue (``attention_impl`` gates flash block sizes,
  ``remat_policy`` gates granularity, ``optimizer`` gates betas…);
* C4 interdependencies (VMEM product budget for flash tiles; HBM fraction
  sum; microbatch divides the per-replica batch);
* a large family of **inert** knobs (telemetry, logging, debug — Ceph's
  ``debug_*`` analogue) that the ranking phase must discover to be
  irrelevant — they are generated programmatically per subsystem;
* **unconfigurable** C1 knobs (ids, addresses, topology facts) that the
  washing stage must remove.

``build_raw_space(cfg, cell, mesh)`` returns the *raw* space;
``clean_space(...)`` runs the §3.2 resolver and returns the tuned domain.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core import constraints as cres
from repro_torch.core.space import Divides, Knob, ProductLeq, Space, SumLeq
from repro_torch.models.config import ModelConfig, ShapeCell
from repro_torch.core.costmodel import MeshShape, V5E


def _perf_knobs(cfg: ModelConfig, cell: ShapeCell, mesh: MeshShape) -> List[Knob]:
    per_replica = max(cell.global_batch // max(mesh.dp, 1), 1)
    ks: List[Knob] = [
        # ---- distribution layout (module selectors, C3 parents) ----
        Knob("fsdp_shard_params", "bool", True, module="parallel",
             description="ZeRO-3 shard params/grads/opt state over DP"),
        Knob("tensor_parallel", "bool", True, module="parallel",
             description="Megatron TP over the model mesh axis"),
        Knob("sequence_parallel", "bool", False, module="parallel",
             gated_by=("tensor_parallel", (True,)),
             description="shard activation seq on the model axis"),
        Knob("pod_in_batch", "bool", True, module="parallel",
             description="multi-pod: pod axis joins data parallelism"),
        Knob("shard_kv_seq", "bool", False, module="serving",
             description="flash-decode style KV-seq sharding"),

        # ---- step structure ----
        Knob("microbatch", "int", 1, lo=1, hi=per_replica,
             module="step",
             description="grad-accum microbatch (divides per-replica batch); "
                         "default 1 is the conservative small-machine value"),
        Knob("remat_policy", "categorical", "none",
             choices=("none", "dots", "block", "full"), module="step",
             description="activation checkpointing policy"),
        Knob("grad_accum_unroll", "bool", False, module="step"),

        # ---- attention module selection + gated sub-knobs ----
        Knob("attention_impl", "categorical", "reference",
             choices=("reference", "chunked", "flash"), module="attention",
             description="attention backend (osd_objectstore analogue)"),
        Knob("flash_block_q", "int", 512, lo=128, hi=2048, align=128,
             dynamic_bound=True, gated_by=("attention_impl", ("flash",)),
             module="attention", description="flash q-tile rows"),
        Knob("flash_block_k", "int", 512, lo=128, hi=2048, align=128,
             dynamic_bound=True, gated_by=("attention_impl", ("flash",)),
             module="attention", description="flash k-tile cols"),
        Knob("chunk_size_k", "int", 2048, lo=256, hi=16384, align=256,
             log_scale=True, gated_by=("attention_impl", ("chunked",)),
             module="attention"),

        # ---- numerics ----
        Knob("matmul_precision", "categorical", "default",
             choices=("default", "high", "highest"), module="numerics"),
        Knob("grad_allreduce_dtype", "categorical", "float32",
             choices=("float32", "bfloat16"), module="numerics",
             description="gradient compression for the DP reduction"),
        Knob("tp_reduce_dtype", "categorical", "float32",
             choices=("float32", "bfloat16"), module="numerics",
             gated_by=("tensor_parallel", (True,)),
             description="TP partial-sum reduction dtype (halves AR bytes)"),
        Knob("master_weights_f32", "bool", True, module="numerics"),

        # ---- collectives ----
        Knob("allreduce_per_microbatch", "bool", False, module="collective",
             description="issue grad reduction per microbatch (overlap)"),
        Knob("pod_hierarchical_allreduce", "bool", True, module="collective"),
        Knob("ici_collective_chunk_kb", "int", 1024, lo=64, hi=16384,
             log_scale=True, dynamic_bound=True, module="collective"),

        # ---- memory economy (C4 sum, the bluestore-cache-ratio analogue) ----
        Knob("act_hbm_frac", "float", 0.5, lo=0.05, hi=0.9, module="memory"),
        Knob("kvcache_hbm_frac", "float", 0.3, lo=0.05, hi=0.9, module="memory"),

        # ---- optimizer module + gated hyperparams (perf-inert, quality-live) --
        Knob("optimizer", "categorical", "adamw",
             choices=("adamw", "adafactor"), module="optimizer"),
        Knob("learning_rate", "float", 3e-4, lo=1e-5, hi=1e-2, log_scale=True,
             module="optimizer", inert=True),
        Knob("weight_decay", "float", 0.1, lo=0.0, hi=0.5, module="optimizer",
             inert=True),
        Knob("beta1", "float", 0.9, lo=0.5, hi=0.99, module="optimizer",
             gated_by=("optimizer", ("adamw",)), inert=True),
        Knob("beta2", "float", 0.95, lo=0.9, hi=0.999, module="optimizer",
             gated_by=("optimizer", ("adamw",)), inert=True),
        Knob("grad_clip_norm", "float", 1.0, lo=0.1, hi=10.0, log_scale=True,
             module="optimizer", inert=True),
    ]

    if cfg.has_moe:
        ks += [
            Knob("expert_parallel", "bool", True, module="moe"),
            Knob("moe_impl", "categorical", "dense",
                 choices=("dense", "dropping"), module="moe"),
            Knob("moe_capacity_factor", "float", 1.25, lo=1.0, hi=2.5,
                 gated_by=("moe_impl", ("dropping",)), module="moe"),
        ]
    if any(s.kind in ("mamba",) for s in cfg.pattern):
        ks.append(Knob("ssm_chunk", "int", 256, lo=64, hi=2048, align=64,
                       log_scale=True, dynamic_bound=True, module="ssm"))
    if any(s.kind in ("mlstm", "slstm") for s in cfg.pattern):
        ks.append(Knob("mlstm_chunk", "int", 256, lo=64, hi=2048, align=64,
                       log_scale=True, dynamic_bound=True, module="ssm"))
    if cell.mode in ("prefill", "decode"):
        ks += [
            Knob("kv_cache_dtype", "categorical", "bfloat16",
                 choices=("bfloat16", "int8"), module="serving"),
            Knob("kv_layout", "categorical", "bshd", choices=("bshd", "bhsd"),
                 module="serving"),
            Knob("prefill_chunk", "int", 0, lo=0, hi=8192, align=512,
                 module="serving"),
            Knob("decode_batch_tile", "int", 0, lo=0, hi=256, align=8,
                 module="serving"),
        ]
    return ks


_INERT_SUBSYSTEMS = (
    "rpc", "telemetry", "dataloader", "checkpoint", "scheduler", "compiler",
    "memory_tracker", "profiler", "logging", "metrics", "watchdog", "tracing",
    "health", "discovery", "manifest", "registry", "eviction", "gc",
    "heartbeat", "lease",
)

_INERT_TEMPLATES = (
    # (suffix, kind, default, lo, hi, log)
    ("debug_level", "int", 1, 0, 20, False),
    ("trace_every_steps", "int", 100, 1, 100000, True),
    ("buffer_kb", "int", 256, 16, 65536, True),
    ("history_len", "int", 64, 1, 4096, True),
    ("sample_rate", "float", 0.01, 0.0, 1.0, False),
    ("timeout_ms", "int", 5000, 100, 600000, True),
    ("retry_limit", "int", 3, 0, 64, False),
    ("flush_interval_s", "float", 30.0, 0.1, 3600.0, True),
    ("max_inflight", "int", 8, 1, 1024, True),
    ("verbose", "bool", False, None, None, False),
    ("compress_logs", "bool", True, None, None, False),
    ("export_format", "categorical", "proto", None, None, False),
    ("shard_hint", "int", 0, 0, 512, False),
    ("queue_depth", "int", 32, 1, 4096, True),
    ("batch_emit", "bool", True, None, None, False),
)


def _inert_knobs() -> List[Knob]:
    """Ceph's debug_* family analogue: 20 subsystems × 15 knobs = 300."""
    ks: List[Knob] = []
    for sub in _INERT_SUBSYSTEMS:
        for suffix, kind, default, lo, hi, log in _INERT_TEMPLATES:
            name = f"{sub}_{suffix}"
            if kind == "bool":
                ks.append(Knob(name, "bool", default, module=sub, inert=True,
                               restart_required=False))
            elif kind == "categorical":
                ks.append(Knob(name, "categorical", "proto",
                               choices=("proto", "json", "csv"),
                               module=sub, inert=True, restart_required=False))
            else:
                ks.append(Knob(name, kind, default, lo=lo, hi=hi,
                               log_scale=log and lo and lo > 0, module=sub,
                               inert=True, restart_required=False))
    return ks


def _unconfigurable_knobs(cfg: ModelConfig, mesh: MeshShape) -> List[Knob]:
    """C1: facts the washing stage must strip (ids, topology, model dims)."""
    fixed = [
        ("job_id", 0), ("host_rank", 0), ("coordinator_port", 8476),
        ("mesh_data_axis", mesh.data), ("mesh_model_axis", mesh.model),
        ("mesh_pod_axis", mesh.pod), ("n_layers", cfg.n_layers),
        ("d_model", cfg.d_model), ("n_heads", cfg.n_heads),
        ("vocab_size", cfg.vocab_size), ("device_generation", 5),
        ("slice_id", 0), ("worker_id", 0), ("dcn_topology_id", 1),
        ("hbm_gib", 16), ("ici_links", 6), ("runtime_version", 2),
        ("checkpoint_dir_inode", 0), ("rng_fold_in", 0), ("build_hash", 0),
    ]
    return [Knob(n, "int", int(v), lo=int(v), hi=max(int(v), int(v) + 1),
                 configurable=False, module="topology") for n, v in fixed]


def build_raw_space(cfg: ModelConfig, cell: ShapeCell,
                    mesh: MeshShape) -> Space:
    per_replica = max(cell.global_batch // max(mesh.dp, 1), 1)
    knobs = _perf_knobs(cfg, cell, mesh) + _inert_knobs() \
        + _unconfigurable_knobs(cfg, mesh)
    cons = [
        Divides(("microbatch",), target=per_replica),
        SumLeq(("act_hbm_frac", "kvcache_hbm_frac"), limit=0.9),
        ProductLeq(("flash_block_q", "flash_block_k"),
                   limit=V5E.vmem_bytes / 8),   # f32 score tile budget
    ]
    return Space(tuple(knobs), tuple(cons))


def clean_space(cfg: ModelConfig, cell: ShapeCell, mesh: MeshShape,
                pinned: Optional[Dict[str, object]] = None):
    """Raw space -> §3.2-resolved clean domain (+ pins + stage report)."""
    raw = build_raw_space(cfg, cell, mesh)
    return cres.resolve(raw, pinned)

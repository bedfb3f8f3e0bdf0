"""Analytic performance model of a (arch × shape × mesh × config) cell.

This is the paper's *test cluster* (§3.1): a cheap, faithful simulator the
tuner probes hundreds of times, standing in for the expensive product
evaluation (here: the compiled dry-run; in the paper: a live Ceph bench).

The model composes per-layer FLOPs / HBM bytes / collective bytes under the
chosen RunConfig knobs into the same three roofline terms the compiled
dry-run reports (launch/roofline.py), so test-cluster and product-cluster
evaluations are directly comparable — the transfer experiment (paper
Fig. 5) depends on that.

Deliberately *non-linear and multi-peak* where real systems are
(paper Fig. 2b): kernel block-size efficiency has alignment and divisor
peaks with VMEM-pressure cliffs; microbatching trades MXU utilization
against collective exposure and HBM feasibility.

Hardware constants: TPU v5e per assignment — 197 TFLOP/s bf16, 819 GB/s
HBM, ~50 GB/s/link ICI; inter-pod DCI modeled at half ICI.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

from repro_torch.models.config import (ATTN, MAMBA, MLP_MOE, MLSTM, SLSTM,
    ModelConfig, ShapeCell)

Config = Dict[str, object]


@dataclass(frozen=True)
class Hardware:
    peak_flops: float = 197e12          # bf16 per chip
    hbm_bw: float = 819e9               # bytes/s per chip
    ici_bw: float = 50e9                # bytes/s per link
    dci_bw: float = 25e9                # bytes/s per pod link (inter-pod)
    hbm_bytes: float = 16e9             # v5e HBM capacity
    vmem_bytes: float = 64 * 2**20      # usable VMEM for kernel tiles


V5E = Hardware()


@dataclass(frozen=True)
class MeshShape:
    pod: int = 1
    data: int = 16
    model: int = 16

    @property
    def chips(self) -> int:
        return self.pod * self.data * self.model

    @property
    def dp(self) -> int:
        return self.pod * self.data


SINGLE_POD = MeshShape(1, 16, 16)
MULTI_POD = MeshShape(2, 16, 16)


@dataclass(frozen=True)
class CostBreakdown:
    compute_s: float
    memory_s: float
    collective_s: float
    step_s: float
    hbm_per_chip: float        # bytes
    feasible: bool
    flops: float               # total step FLOPs (all chips)
    hbm_bytes_moved: float     # total step HBM traffic (all chips)
    collective_bytes: float    # total step collective traffic (all chips)


# ---------------------------------------------------------------------------
# per-layer FLOPs / bytes
# ---------------------------------------------------------------------------

def _bytes_of(dtype: str) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}[str(dtype)]


def matmul_flops_layer(cfg: ModelConfig, tokens: int) -> float:
    """Forward matmul FLOPs of one *pattern group* per token-batch.

    2 · (active params in the group) · tokens, using the config's analytic
    parameter counter so MoE counts routed-in experts only.
    """
    per_group_active = cfg.active_param_count() - _embedding_params(cfg)
    per_group_active /= cfg.n_groups
    return 2.0 * per_group_active * tokens


def _embedding_params(cfg: ModelConfig) -> int:
    emb = cfg.vocab_size * cfg.d_model
    return emb if cfg.tie_embeddings else 2 * emb


def attention_flops(cfg: ModelConfig, batch: int, seq: int) -> float:
    """Quadratic attention score+value FLOPs per group (fwd)."""
    per_group = sum(1 for s in cfg.pattern if s.kind == ATTN)
    window_terms = []
    for s in cfg.pattern:
        if s.kind != ATTN:
            continue
        kv_len = min(s.sliding_window or seq, seq)
        window_terms.append(kv_len)
    if not window_terms:
        return 0.0
    hd = cfg.resolved_head_dim
    f = 0.0
    for kv_len in window_terms:
        # causal halves the score matrix; QKᵀ + PV, 2 flops/MAC
        f += 2 * 2 * batch * cfg.n_heads * seq * kv_len * hd * 0.5
    return f


def scan_mixer_flops(cfg: ModelConfig, batch: int, seq: int) -> float:
    """Linear-time mixers (mamba/mlstm/slstm) state-update FLOPs per group."""
    f = 0.0
    for s in cfg.pattern:
        if s.kind == MAMBA:
            f += 2 * batch * seq * cfg.d_inner * (2 * cfg.ssm_state_dim + 8)
        elif s.kind == MLSTM:
            di = int(cfg.mlstm_expand * cfg.d_model)
            nh = max(di // max(cfg.resolved_head_dim, 1), 1)
            p = di // nh
            f += 2 * batch * seq * di * p          # C update ~ d_inner × head_dim
        elif s.kind == SLSTM:
            f += 2 * batch * seq * 8 * cfg.d_model
    return f


# ---------------------------------------------------------------------------
# knob-response curves (non-linear, multi-peak — paper Fig. 2b)
# ---------------------------------------------------------------------------

def mxu_block_efficiency(block_q: int, block_k: int, seq: int,
                         hd: int, hw: Hardware) -> float:
    """MXU utilization of a flash tile configuration ∈ (0, 1].

    Peaks where blocks are 128-aligned AND divide the (padded) sequence;
    cliffs where the working set overflows VMEM — multi-peak by design,
    matching measured TPU kernel behaviour and reproducing the paper's
    Fig. 2b response shape.
    """
    eff = 0.45
    if block_q % 128 == 0:
        eff += 0.12
    if block_k % 128 == 0:
        eff += 0.12
    if seq % max(block_q, 1) == 0:
        eff += 0.12
    if seq % max(block_k, 1) == 0:
        eff += 0.08
    # second harmonic: 512-aligned tiles keep the MXU pipeline full
    if block_q % 512 == 0:
        eff += 0.06
    if block_k % 512 == 0:
        eff += 0.04
    # VMEM working set: q,k,v,o tiles + score tile (f32)
    ws = (block_q * hd + 2 * block_k * hd + block_q * hd) * 2 \
        + block_q * block_k * 4
    if ws > hw.vmem_bytes:
        eff *= 0.25                       # spill cliff
    elif ws > 0.5 * hw.vmem_bytes:
        eff *= 0.8                        # reduced double-buffering
    # tiny blocks starve the MXU
    if block_q < 128 or block_k < 128:
        eff *= 0.5
    return min(eff, 0.98)


def microbatch_efficiency(tokens_per_chip: int) -> float:
    """Compute efficiency vs per-chip tokens per microbatch (saturating).

    MXU pipelines saturate around ≥2k tokens/chip for these widths; tiny
    microbatches (the conservative default, tuned for small machines —
    the paper's 'defaults are for commodity hardware' premise) starve it.
    Caps at 0.88: real kernels never hit paper peak.
    """
    return min(0.30 + 0.58 * min(tokens_per_chip / 2048.0, 1.0), 0.88)


def precision_factor(matmul_precision: str) -> float:
    return {"default": 1.0, "high": 2.0, "highest": 4.0}[str(matmul_precision)]


REMAT_RECOMPUTE = {"none": 0.0, "dots": 0.35, "block": 0.65, "full": 1.0}
REMAT_ACT_FRACTION = {"none": 1.0, "dots": 0.45, "block": 0.18, "full": 0.05}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def estimate(cfg: ModelConfig, cell: ShapeCell, mesh: MeshShape,
             knobs: Config, hw: Hardware = V5E) -> CostBreakdown:
    g = lambda k, d: knobs.get(k, d)   # noqa: E731

    tp_on = bool(g("tensor_parallel", True))
    fsdp = bool(g("fsdp_shard_params", True))
    sp_on = bool(g("sequence_parallel", False)) and tp_on
    ep_on = bool(g("expert_parallel", True)) and cfg.has_moe
    pod_in_batch = bool(g("pod_in_batch", True))
    tp = mesh.model if tp_on else 1
    dp = mesh.chips // mesh.model if pod_in_batch else mesh.data
    remat = str(g("remat_policy", "none"))
    prec = precision_factor(g("matmul_precision", "default"))
    attn_impl = str(g("attention_impl", "reference"))
    grad_dtype_bytes = _bytes_of(
        "bfloat16" if str(g("grad_allreduce_dtype", "float32")) == "bfloat16"
        else "float32")
    hier = bool(g("pod_hierarchical_allreduce", True))

    B, S = cell.global_batch, cell.seq_len
    train = cell.mode == "train"
    decode = cell.mode == "decode"

    n_params = cfg.param_count()
    n_active = cfg.active_param_count()
    pbytes = _bytes_of(g("param_dtype", "bfloat16"))

    # ---- microbatching -----------------------------------------------------
    per_replica = max(B // dp, 1)
    micro = int(g("microbatch", 0)) or per_replica
    micro = max(min(micro, per_replica), 1)
    n_micro = max(per_replica // micro, 1)

    seq_for_tokens = 1 if decode else S
    tokens_global = B * seq_for_tokens
    tokens_micro_chip = micro * seq_for_tokens // max(tp, 1)

    # ---- FLOPs ---------------------------------------------------------------
    fwd = cfg.n_groups * matmul_flops_layer(cfg, tokens_global)
    if decode:
        # decode attends 1 token against an S-long cache: linear in S
        hd = cfg.resolved_head_dim
        attn_fwd = 2 * 2 * B * cfg.n_heads * 1 * S * hd * cfg.attn_layer_count
    else:
        attn_fwd = cfg.n_groups * attention_flops(cfg, B, S)
    mix_fwd = cfg.n_groups * scan_mixer_flops(cfg, B, 1 if decode else S)
    head = 2 * tokens_global * cfg.d_model * cfg.vocab_size
    fwd_total = fwd + attn_fwd + mix_fwd + head

    if train:
        flops = fwd_total * (3.0 + REMAT_RECOMPUTE[remat])  # fwd+2×bwd+remat
    else:
        flops = fwd_total

    # ---- compute efficiency (knob-responsive) --------------------------------
    eff = microbatch_efficiency(max(tokens_micro_chip, 1))
    if cfg.has_attention and not decode:
        if attn_impl == "flash":
            eff_attn = mxu_block_efficiency(
                int(g("flash_block_q", 512)), int(g("flash_block_k", 512)),
                S, cfg.resolved_head_dim, hw)
        elif attn_impl == "chunked":
            ck = int(g("chunk_size_k", 2048))
            eff_attn = 0.55 + (0.15 if S % max(ck, 1) == 0 else 0.0)
        else:
            # reference materializes [S,S] — efficiency collapses with S
            eff_attn = max(0.5 - 0.4 * min(S / 32768.0, 1.0), 0.08)
        attn_share = attn_fwd / max(fwd_total, 1.0)
        eff = eff * (1 - attn_share) + eff_attn * attn_share
    if cfg.has_moe:
        cap = float(g("moe_capacity_factor", 1.25))
        # dropping tokens hurts quality not time; overcapacity pads compute
        flops *= (1.0 if str(g("moe_impl", "dense")) == "dense"
                  else max(cap, 1.0))
    compute_s = flops * prec / (mesh.chips * hw.peak_flops * max(eff, 0.05))

    # ---- HBM traffic ----------------------------------------------------------
    act_dtype_bytes = _bytes_of(g("activation_dtype", "bfloat16"))
    act_frac = REMAT_ACT_FRACTION[remat] if train else 1.0
    layer_io = 12 if cfg.has_attention else 8   # tensors touched per layer
    act_bytes = (tokens_global * cfg.d_model * act_dtype_bytes
                 * cfg.n_layers * layer_io * act_frac)
    # EVERY chip reads its (TP-sharded) slice of the gathered weights per
    # pass: per-chip weight traffic = N/tp, so the fleet-wide total is
    # chips·N/tp.  With tp off this is chips× the model per microbatch —
    # the term that makes naive "just turn TP off" recommendations fail
    # on the product cluster (validated against the compiled evaluator).
    weight_reads = (n_active * pbytes * (2 if train else 1) * n_micro
                    * mesh.chips / max(tp, 1))
    opt_bytes = 0.0
    if train:
        opt_mult = 12 if str(g("optimizer", "adamw")) == "adamw" else 5
        if not bool(g("master_weights_f32", True)):
            opt_mult = max(opt_mult - 4, 1)
        opt_bytes = n_params * opt_mult   # m, v, master read+write (f32)
    kv_bytes = 0.0
    if decode:
        kv_dtype = _bytes_of(g("kv_cache_dtype", "bfloat16"))
        kv_bytes = (2 * B * S * cfg.kv_dim * kv_dtype * cfg.attn_layer_count)
    hbm_moved = act_bytes + weight_reads + opt_bytes + kv_bytes
    memory_s = hbm_moved / (mesh.chips * hw.hbm_bw)

    # ---- collective traffic -----------------------------------------------------
    coll = 0.0
    slowest_bw = hw.ici_bw
    if train:
        shard_params = n_params * grad_dtype_bytes
        if fsdp:
            # ZeRO-3: all-gather params fwd+bwd per microbatch + reduce-scatter
            coll += shard_params * (2 * n_micro + 1)
        elif dp > 1:
            coll += 2 * shard_params                      # ring all-reduce
        if mesh.pod > 1 and pod_in_batch:
            pod_bytes = shard_params if not hier else shard_params / mesh.data
            coll += pod_bytes
            slowest_bw = hw.dci_bw if not hier else hw.ici_bw
    if tp_on and tp > 1:
        # 2 activation collectives per layer (attn out + mlp out); partial
        # sums reduce in f32 unless tp_reduce_dtype compresses them
        tp_red_bytes = 2 if str(g("tp_reduce_dtype", "float32")) \
            == "bfloat16" else 4
        act_coll = (tokens_global * cfg.d_model * tp_red_bytes
                    * 2 * cfg.n_layers * (3 if train else 1))
        if sp_on:
            act_coll *= 0.75    # RS+AG instead of AR; SP keeps seq sharded
        coll += act_coll
    if ep_on:
        moe_layers = sum(1 for s in cfg.pattern if s.mlp == MLP_MOE) * cfg.n_groups
        a2a = (tokens_global * cfg.d_model * act_dtype_bytes
               * 2 * moe_layers * (3 if train else 1)
               * float(g("moe_capacity_factor", 1.25)))
        coll += a2a
    chunk_kb = float(g("ici_collective_chunk_kb", 1024))
    # chunked collectives overlap poorly if tiny, congest if huge (mild, peaked)
    chunk_pen = 1.0 + 0.15 * abs(math.log2(max(chunk_kb, 1) / 1024.0)) / 4.0
    collective_s = coll * chunk_pen / (mesh.chips * slowest_bw)

    # ---- overlap: per-microbatch allreduce hides collectives behind compute ----
    if train and bool(g("allreduce_per_microbatch", False)) and n_micro > 1:
        collective_exposed = max(collective_s - compute_s * 0.6, collective_s * 0.25)
    else:
        collective_exposed = collective_s

    # ---- HBM feasibility ---------------------------------------------------------
    param_shard = mesh.chips if fsdp else (tp if tp_on else 1)
    hbm = n_params * pbytes / param_shard
    if train:
        opt_shard = mesh.chips if fsdp else dp    # ZeRO-1 at minimum
        hbm += n_params * 12 / opt_shard
        act_live = (micro * S * cfg.d_model * act_dtype_bytes
                    * cfg.n_layers * layer_io * act_frac) / max(tp, 1)
        hbm += act_live
    if decode:
        kv_dtype = _bytes_of(g("kv_cache_dtype", "bfloat16"))
        kv_shard = max(tp, 1)
        if bool(g("shard_kv_seq", False)):
            kv_shard *= mesh.data
        hbm += (2 * (B / max(dp, 1)) * S * cfg.kv_dim * kv_dtype
                * cfg.attn_layer_count) / max(kv_shard / max(tp, 1), 1)
    feasible = hbm <= hw.hbm_bytes * 0.92

    step = max(compute_s, memory_s, collective_exposed)
    # non-dominant terms still partially serialize (imperfect overlap)
    step += 0.15 * (compute_s + memory_s + collective_exposed - step)
    if not feasible:
        step *= 4.0 + 4.0 * (hbm / (hw.hbm_bytes * 0.92) - 1.0)  # soft OOM

    return CostBreakdown(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_exposed,
        step_s=step, hbm_per_chip=hbm, feasible=feasible, flops=flops,
        hbm_bytes_moved=hbm_moved, collective_bytes=coll,
    )

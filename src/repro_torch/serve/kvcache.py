"""KV-cache budgeting: HBM planning under the memory-fraction knobs (from
``repro.serve.kvcache``; pure arithmetic, the same in both packages).

The C4 sum constraint ``act_hbm_frac + kvcache_hbm_frac <= 0.9`` (the
bluestore cache-ratio analogue) is enforced by the constraint solver; this
module turns the granted fraction into concrete serving limits:

    plan = CachePlan.build(cfg, rc, mesh_chips, tp, hbm_bytes, frac)
    plan.max_batch(seq_len)  /  plan.max_seq(batch)

Cache buffers themselves live in models/attention.py (layout and dtype are
knobs); this is the admission-control arithmetic the engine uses.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import ModelConfig
from repro_torch.runconfig import RunConfig


def _dtype_bytes(name: str) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}[name]


@dataclass(frozen=True)
class CachePlan:
    bytes_per_token_per_seq: int      # per sequence position, all layers
    budget_bytes: int                 # per-replica KV budget
    cfg: ModelConfig

    @classmethod
    def build(cls, cfg: ModelConfig, rc: RunConfig, *, hbm_bytes: float,
              kv_frac: float, tp: int = 1) -> "CachePlan":
        per_tok = (2 * cfg.kv_dim * _dtype_bytes(rc.kv_cache_dtype)
                   * cfg.attn_layer_count)
        if cfg.is_encoder_decoder:
            per_tok += 2 * cfg.kv_dim * _dtype_bytes(rc.kv_cache_dtype) \
                * cfg.n_layers           # cross-attn memory
        per_tok = max(per_tok // max(tp, 1), 1)
        return cls(per_tok, int(hbm_bytes * kv_frac), cfg)

    def max_batch(self, seq_len: int) -> int:
        return max(self.budget_bytes // (self.bytes_per_token_per_seq
                                         * max(seq_len, 1)), 0)

    def max_seq(self, batch: int) -> int:
        return max(self.budget_bytes // (self.bytes_per_token_per_seq
                                         * max(batch, 1)), 0)

    def fits(self, batch: int, seq_len: int) -> bool:
        return (batch * seq_len * self.bytes_per_token_per_seq
                <= self.budget_bytes)

"""grok-1-314b — MoE 8e top-2 [hf:xai-org/grok-1].

64L d_model=6144 48H (GQA kv=8) d_ff=32768, vocab=131072.
GeLU experts, attn logit soft-cap 30, embedding multiplier ~sqrt(d).
"""

import math

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    act="gelu",
    rope_theta=10_000.0,
    logit_softcap=30.0,
    embedding_multiplier=math.sqrt(6144.0),
    n_experts=8,
    n_experts_per_tok=2,
    moe_d_ff=32768,
    pattern=(LayerSpec(kind="attn", mlp="moe"),),
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    moe_d_ff=128, vocab_size=256, n_experts=4, n_experts_per_tok=2,
    embedding_multiplier=8.0,
)

# Family defaults for the 70B+ tier: factored optimizer without f32
# masters (AdamW would need ~12 bytes/param of optimizer HBM — 4.7 TB for
# grok-1), full remat, minimum microbatch.  Still "default" in SAPPHIRE's
# sense: safe, not tuned.
RUN_OVERRIDES = dict(
    optimizer="adafactor",
    master_weights_f32=False,
    remat_policy="full",
    microbatch=1,
)

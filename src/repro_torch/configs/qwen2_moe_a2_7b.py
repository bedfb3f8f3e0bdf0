"""qwen2-moe-a2.7b — 60 routed experts top-4 + 4 shared [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (GQA kv=16 == MHA) d_ff=1408/expert vocab=151936.
Shared experts form a dense MLP of width 4*1408 = 5632.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    qkv_bias=True,
    act="silu",
    rope_theta=1_000_000.0,
    n_experts=60,
    n_experts_per_tok=4,
    n_shared_experts=4,
    moe_d_ff=1408,
    pattern=(LayerSpec(kind="attn", mlp="moe"),),
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
    moe_d_ff=32, vocab_size=256, n_experts=8, n_experts_per_tok=2,
    n_shared_experts=2,
)

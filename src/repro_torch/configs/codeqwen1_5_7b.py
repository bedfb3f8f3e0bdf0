"""codeqwen1.5-7b — qwen1.5-arch dense, QKV bias [hf:Qwen/CodeQwen1.5-7B].

32L d_model=4096 32H (GQA kv=32 == MHA) d_ff=13440 vocab=92416.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
    act="silu",
    rope_theta=1_000_000.0,
    pattern=(LayerSpec(kind="attn", mlp="dense"),),
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256,
)

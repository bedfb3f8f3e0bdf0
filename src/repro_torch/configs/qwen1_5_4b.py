"""qwen1.5-4b — dense, QKV bias [hf:Qwen/Qwen1.5-4B].

40L d_model=2560 20H (GQA kv=20 == MHA) d_ff=6912 vocab=151936.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    act="silu",
    rope_theta=5_000_000.0,
    pattern=(LayerSpec(kind="attn", mlp="dense"),),
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256,
)

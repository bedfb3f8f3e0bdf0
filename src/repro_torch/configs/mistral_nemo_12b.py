"""mistral-nemo-12b — dense GQA, 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
Nemo uses head_dim=128 explicitly (q width 4096 != d_model).
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    act="silu",
    rope_theta=1_000_000.0,
    pattern=(LayerSpec(kind="attn", mlp="dense"),),
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=80, n_heads=4, n_kv_heads=2, d_ff=160,
    head_dim=16, vocab_size=256,
)

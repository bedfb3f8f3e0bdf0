"""qwen2-vl-72b — VLM backbone, M-RoPE [arXiv:2409.12191; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
Vision frontend is a STUB per the assignment: input_specs() supplies
(t, h, w) M-RoPE position ids; the backbone is the full text transformer.
M-RoPE sections (16, 24, 24) over head_dim/2 = 64.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    act="silu",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    pattern=(LayerSpec(kind="attn", mlp="dense"),),
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, mrope_sections=(2, 3, 3),  # head_dim 16 -> d/2 = 8
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

"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7, MoE 16e top-2
[arXiv:2403.19887 / 2408.12570; hf].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536.
Repeating 8-layer block: attention at position 4, mamba elsewhere;
MoE MLP on every other layer (odd positions), dense on even.
Hybrid (SSM-dominant) => sub-quadratic => long_500k runs.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

_pattern = tuple(
    LayerSpec(
        kind="attn" if i == 4 else "mamba",
        mlp="moe" if i % 2 == 1 else "dense",
    )
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    act="silu",
    rope_theta=10_000.0,          # jamba attn layers use no rope in v1; 1.5
                                  # keeps attention positions implicit — we
                                  # retain rope for the attn layers (adaptation)
    n_experts=16,
    n_experts_per_tok=2,
    moe_d_ff=24576,
    ssm_state_dim=16,
    ssm_conv_width=4,
    ssm_expand=2,
    pattern=_pattern,
    sub_quadratic=True,
)

SMOKE = CONFIG.scaled(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    moe_d_ff=128, vocab_size=256, n_experts=4, n_experts_per_tok=2,
    ssm_state_dim=8,
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

"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517].

48L d_model=2048 4H (GQA kv=4) d_ff=0 (no separate MLP; xLSTM blocks carry
their own projections) vocab=50304.  xLSTM[7:1]: every 8th layer is sLSTM.
Linear-recurrence => sub-quadratic => long_500k runs.
"""

from repro_torch.models.config import LayerSpec, ModelConfig

_pattern = tuple(
    LayerSpec(kind="slstm" if i == 7 else "mlstm", mlp="none")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    act="gelu",
    mlstm_expand=2.0,
    slstm_proj=4.0 / 3.0,
    pattern=_pattern,
    sub_quadratic=True,
    tie_embeddings=False,
)

SMOKE = CONFIG.scaled(
    n_layers=8, d_model=64, n_heads=2, n_kv_heads=2, vocab_size=256,
)

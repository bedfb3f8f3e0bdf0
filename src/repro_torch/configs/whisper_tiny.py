"""whisper-tiny — enc-dec audio backbone, conv frontend stub [arXiv:2212.04356].

4+4L d_model=384 6H d_ff=1536 vocab=51865.  LayerNorm + GeLU (not RMS/SwiGLU).
input_specs() provides precomputed 1500-frame embeddings (the conv stub).
Decode shapes exercise the decoder backbone at the assigned 32k cache sizes
(a backbone capability; the speech product caps at 448 — DESIGN.md §6).
"""

from repro_torch.models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                 # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    act="gelu",
    norm="layernorm",
    mlp_bias=True,
    qkv_bias=True,
    tie_embeddings=True,
    is_encoder_decoder=True,
    n_encoder_layers=4,
    encoder_seq=1500,
    frontend="audio_stub",
    pattern=(LayerSpec(kind="attn", mlp="dense"),),
)

SMOKE = CONFIG.scaled(
    n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, encoder_seq=32,
)

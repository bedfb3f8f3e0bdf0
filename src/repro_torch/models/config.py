"""Model configuration dataclasses for the architecture zoo.

Every assigned architecture is expressed as a :class:`ModelConfig`.  The
layer stack is described by a *repeating block pattern* so that hybrid
architectures (jamba's 1:7 attn:mamba interleave, xLSTM's 7:1 mLSTM:sLSTM)
compile as a ``lax.scan`` over pattern *groups* rather than an unrolled
stack — compile time scales with the pattern length, not ``n_layers``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Layer kinds understood by the transformer stack.
ATTN = "attn"
MAMBA = "mamba"
MLSTM = "mlstm"
SLSTM = "slstm"

# MLP kinds.
MLP_DENSE = "dense"
MLP_MOE = "moe"
MLP_NONE = "none"


@dataclass(frozen=True)
class LayerSpec:
    """One position inside the repeating block pattern."""

    kind: str = ATTN           # attn | mamba | mlstm | slstm
    mlp: str = MLP_DENSE       # dense | moe | none
    sliding_window: Optional[int] = None  # tokens; None = full attention


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None          # default: d_model // n_heads
    qkv_bias: bool = False
    mlp_bias: bool = False
    act: str = "silu"                       # silu (SwiGLU) | gelu
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # Rotary embedding.
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE

    # Attention extras.
    logit_softcap: Optional[float] = None   # grok-1 attn soft-cap
    embedding_multiplier: Optional[float] = None  # grok-1 input scale

    # Repeating layer pattern.  n_layers must be divisible by len(pattern).
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)

    # MoE.
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: Optional[int] = None          # per-expert hidden dim
    router_aux_coef: float = 0.001

    # SSM (mamba) dims.
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2

    # xLSTM dims.
    mlstm_expand: float = 2.0
    slstm_proj: float = 4.0 / 3.0

    # Encoder-decoder (whisper).
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500                 # whisper 30 s @ 50 Hz (post-conv)
    frontend: Optional[str] = None          # "audio_stub" | "vision_stub"

    # Long-context capability: True when the stack is sub-quadratic
    # (SSM / linear-attention / hybrid), enabling the long_500k shape.
    sub_quadratic: bool = False

    # Max position for RoPE tables at decode time (long_500k needs 524288).
    max_position: int = 1 << 20

    def __post_init__(self):
        if self.n_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern length {len(self.pattern)}"
            )
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError(f"{self.name}: n_kv_heads must divide n_heads")

    # ---- derived quantities -------------------------------------------------

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    @property
    def has_attention(self) -> bool:
        return any(s.kind == ATTN for s in self.pattern)

    @property
    def has_moe(self) -> bool:
        return any(s.mlp == MLP_MOE for s in self.pattern)

    @property
    def attn_layer_count(self) -> int:
        per_group = sum(1 for s in self.pattern if s.kind == ATTN)
        return per_group * self.n_groups

    def param_count(self) -> int:
        """Total parameter count (analytic; used for 6·N·D model FLOPs)."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Active-per-token parameters (MoE: only routed-in experts)."""
        return _param_count(self, active_only=True)

    def scaled(self, **overrides) -> "ModelConfig":
        """Return a reduced/altered copy (used for smoke configs)."""
        return dataclasses.replace(self, **overrides)


def _mlp_params(cfg: ModelConfig, spec: LayerSpec, active_only: bool) -> int:
    d = cfg.d_model
    if spec.mlp == MLP_NONE:
        return 0
    if spec.mlp == MLP_DENSE:
        f = cfg.d_ff
        n_mat = 3 if cfg.act == "silu" else 2  # SwiGLU has gate+up+down
        return n_mat * d * f
    # MoE: routed experts + shared experts + router.
    f = cfg.moe_d_ff if cfg.moe_d_ff is not None else cfg.d_ff
    n_mat = 3 if cfg.act == "silu" else 2
    per_expert = n_mat * d * f
    n_routed = cfg.n_experts_per_tok if active_only else cfg.n_experts
    shared = cfg.n_shared_experts * per_expert
    router = d * cfg.n_experts
    return n_routed * per_expert + shared + router


def _layer_params(cfg: ModelConfig, spec: LayerSpec, active_only: bool) -> int:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    if spec.kind == ATTN:
        core = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    elif spec.kind == MAMBA:
        di = cfg.d_inner
        core = (
            d * 2 * di            # in_proj (x and z branches)
            + di * cfg.ssm_conv_width
            + di * (2 * cfg.ssm_state_dim + 1)  # x -> (B, C, dt)
            + di * cfg.ssm_state_dim            # A (log) parameter
            + di * d              # out_proj
        )
    elif spec.kind == MLSTM:
        di = int(cfg.mlstm_expand * d)
        core = (
            d * 2 * di            # up-proj (x, z)
            + 3 * di * di         # q, k, v projections (full width)
            + 3 * di              # input/forget/output gate vectors (per-dim)
            + di * d              # down-proj
        )
    elif spec.kind == SLSTM:
        dp = int(cfg.slstm_proj * d)
        core = 4 * d * d + 4 * d * d + 2 * d * dp  # recurrent + input gates + ffn
    else:
        raise ValueError(spec.kind)
    return core + _mlp_params(cfg, spec, active_only)


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    per_group = sum(_layer_params(cfg, s, active_only) for s in cfg.pattern)
    total = per_group * cfg.n_groups
    emb = cfg.vocab_size * cfg.d_model
    total += emb if cfg.tie_embeddings else 2 * emb
    if cfg.is_encoder_decoder:
        # Encoder self-attn + mlp, plus decoder cross-attention blocks.
        enc_spec = LayerSpec(kind=ATTN, mlp=MLP_DENSE)
        total += cfg.n_encoder_layers * _layer_params(cfg, enc_spec, active_only)
        d = cfg.d_model
        cross = cfg.n_layers * (d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d)
        total += cross
    return total


# ---------------------------------------------------------------------------
# Input shape cells (assigned shapes; identical for every LM arch).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def applicable_shapes(cfg: ModelConfig) -> Tuple[ShapeCell, ...]:
    """Shapes that apply to an architecture (long_500k needs sub-quadratic)."""
    out = []
    for s in SHAPES:
        if s.name == "long_500k" and not cfg.sub_quadratic:
            continue  # full-attention archs skip 500k decode (DESIGN.md §6)
        out.append(s)
    return tuple(out)

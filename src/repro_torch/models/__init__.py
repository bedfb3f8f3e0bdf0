from repro_torch.models.config import (  # noqa: F401
    ATTN, MAMBA, MLSTM, SLSTM, MLP_DENSE, MLP_MOE, MLP_NONE,
    LayerSpec, ModelConfig, ShapeCell, SHAPES, SHAPES_BY_NAME,
    applicable_shapes,
)

"""Hand-written CUDA flash-attention forward for the model zoo.

Consumer: ``models.attention.flash_attention_dispatch``
(``RunConfig.attention_impl == "flash"``), on every layer of
``transformer.prefill`` / ``forward``.
"""

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import reference_attention

__all__ = ["flash_attention", "reference_attention"]

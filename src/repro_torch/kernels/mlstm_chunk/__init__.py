"""Hand-written CUDA chunkwise mLSTM forward for the model zoo.

Consumer: ``models.xlstm.mlstm_apply`` on every mLSTM layer of
``transformer.forward`` / ``prefill``.
"""

from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
from repro_torch.kernels.mlstm_chunk.ref import (mlstm_chunkwise,
                                                 mlstm_sequential)

__all__ = ["mlstm_chunk", "mlstm_chunkwise", "mlstm_sequential"]

"""Hand-written CUDA Matérn-5/2 Gram kernels for the GP surrogate.

Consumers: ``gp.fit``/``gp.predict`` (posterior builds) and
``gp.select_batch`` (the q-EI candidate cross-Gram), all behind
``BOConfig.use_kernel`` with the plain-torch kernels elsewhere.
"""

from repro_torch.kernels.gp_gram.ops import matern52_cross, matern52_gram
from repro_torch.kernels.gp_gram.ref import matern52_cross_ref, matern52_gram_ref

__all__ = ["matern52_gram", "matern52_cross",
           "matern52_gram_ref", "matern52_cross_ref"]

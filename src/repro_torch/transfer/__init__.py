"""Cross-workload transfer: meta-learned priors over the config zoo.

The subsystem that makes tuning evidence outlive the run that produced
it (Sapphire's amortization premise; the open problem BestConfig and
Magpie both name):

* :mod:`repro_torch.transfer.corpus` — sweep EvalDB files / ShardedEvalLog
  roots into per-workload ``(X, y, var)`` datasets over one shared
  Space, skipping incompatible sources loudly;
* :func:`repro_torch.core.gp.fit` with a task column — the rank-1 ICM
  multi-task GP the corpus is stacked into;
* :mod:`repro_torch.transfer.strategy` — ``TransferBOStrategy`` (registry
  name ``"transfer_bo"``): hyperparameter warm start + design seeding +
  decaying pseudo-observations, degrading to plain BO on an empty
  corpus.

Importing this package registers the strategy.
"""

from repro_torch.transfer.corpus import (CorpusMismatch, TaskData,
                                         TransferCorpus, build_corpus,
                                         corpus_from_log, space_signature)
from repro_torch.transfer.strategy import TransferBOStrategy

__all__ = [
    "CorpusMismatch", "TaskData", "TransferCorpus", "TransferBOStrategy",
    "build_corpus", "corpus_from_log", "space_signature",
]

"""Training jamba (mamba + MoE, the hybrid family) against the reference
on the CPU: ``Model.loss`` and its gradients against
``jax.value_and_grad`` (as ``test_torch_train.py`` holds the dense, MoE
and encoder-decoder families), and one accumulated ``make_train_step``
step (microbatch 1) with ``allreduce_per_microbatch`` on and off (as
``test_torch_train_step.py``), on the smoke config cut to pattern
positions 3 and 4 (``STEP_CUT``: mamba with the MoE, attention with the
dense MLP; the step's compile is most of its time and grows with the
pattern; the whole stack is held by the loss and gradients).

Every gradient leaf agrees within 2e-5 but the mamba skip ``d_skip`` (a
sum over every position that nearly cancels), 1.1e-4 apart, against the
reference's own 3e-5 spread over SSM chunk sizes (the same function):
the stack is held to 2e-4 per leaf instead of the other families' 1e-4.
"""

import pytest
import torch

from test_torch_train import check_loss_and_grads
from test_torch_train_step import check_train_step

ARCH, GRAD_REL = "jamba-1.5-large-398b", 2e-4
STEP_CUT = (3, 4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_loss_and_grads_match_reference():
    check_loss_and_grads(ARCH, GRAD_REL)


@pytest.mark.parametrize("knobs", ["mb1", "mb1-per-micro"])
def test_train_step_matches_reference(knobs):
    """The accumulated step (microbatch 1: two microbatches), with
    ``allreduce_per_microbatch`` off and on.  Microbatch 0 is
    ``loss_and_grads`` (held above) then the optimizer (held alone in
    ``test_torch_train_step.py``); the other families run it as a step
    too."""
    check_train_step(ARCH, knobs, keep=STEP_CUT)

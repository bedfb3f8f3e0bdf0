"""Training xlstm-1.3b against the reference on the CPU: ``Model.loss``
and its gradients against ``jax.value_and_grad`` (as
``test_torch_train.py`` holds the dense, MoE and encoder-decoder
families), each xLSTM layer alone, and one accumulated
``make_train_step`` step (microbatch 1) with ``allreduce_per_microbatch``
on and off (as ``test_torch_train_step.py``), on the smoke config cut to
one mLSTM and the sLSTM layer (``STEP_CUT``: the step's compile is most
of its time and grows with the pattern; the whole stack is held by the
loss and gradients).

The stack amplifies rounding in its gradients, so it is held to a
looser per-leaf limit than the other families' 1e-4, with what was
measured: each mLSTM and sLSTM layer alone agrees to 1e-6
  (``test_xlstm_layers_match``, held to 1e-5); the reference's own
  gradients move by 7e-5 between mLSTM chunk sizes 16, 8 and 4 (the
  same function); the two packages differ by up to 4.6e-4 (the input
gate's bias).  Held to 1e-3 per leaf (jamba, the other recurrent
stack: ``test_torch_train_jamba.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as jxlstm
from repro.runconfig import RunConfig as JRunConfig
from repro_torch.models import xlstm
from repro_torch.models.common import tree_flatten, tree_unflatten
from repro_torch.runconfig import RunConfig
from test_torch_train import F32, _pair, check_loss_and_grads
from test_torch_train_step import check_train_step

ARCH, GRAD_REL = "xlstm-1.3b", 1e-3
STEP_CUT = (0, 7)


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


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_layers_match(kind):
    """One xLSTM layer of the smoke config alone: parameter and input
    gradients of <out, r> within relative L2 1e-5 of the reference."""
    jm, jp, tm, _ = _pair(ARCH)
    pos = 2 if kind == "mlstm" else 7
    layer = jax.tree.map(lambda t: t[0], jp["layers"][pos][kind])
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 16, jm.cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((2, 16, jm.cfg.d_model)).astype(np.float32)
    japply = getattr(jxlstm, f"{kind}_apply")
    tapply = getattr(xlstm, f"{kind}_apply")
    jrc, trc = JRunConfig(**F32), RunConfig(**F32)
    jgp, jgx = jax.jit(jax.grad(
        lambda p, x: jnp.sum(japply(p, x, jm.cfg, jrc) * r),
        argnums=(0, 1)))(layer, jnp.asarray(h))
    leaves, treedef = tree_flatten(
        tm.params_from_numpy(jax.tree.map(np.asarray, layer)))
    leaves = [t.requires_grad_() for t in leaves]
    th = torch.from_numpy(h).requires_grad_()
    out = tapply(tree_unflatten(treedef, leaves), th, tm.cfg, trc)
    got = torch.autograd.grad((out * torch.from_numpy(r)).sum(),
                              leaves + [th])
    for g, w in zip(got, jax.tree.leaves(jgp) + [jgx]):
        w = np.asarray(w)
        assert np.linalg.norm(g.numpy() - w) <= 1e-5 * np.linalg.norm(w)

"""Train-step factory: microbatched grad accumulation under RunConfig knobs
(from ``repro.train.train_loop``).

``make_train_step(model, rc)`` returns ``step_fn(state, batch) ->
(new_state, metrics)``.  Gradients come from ``torch.autograd.grad`` of
``Model.loss`` over the parameter tree's leaves (``loss_and_grads``).
Knobs that shape the step:

* ``microbatch``                — grad-accumulation split (per replica);
* ``remat_policy``              — applied inside the model backbone;
* ``grad_allreduce_dtype``      — the dtype gradients are cast to before
  the (here absent) cross-replica reduction, and so accumulated in;
* ``allreduce_per_microbatch``  — accumulate in that dtype per microbatch
  instead of float32 with one cast at the end;
* ``grad_accum_unroll``         — the reference's unrolled loop or
  ``lax.scan``; both are the same Python loop here, with the same numbers;
* ``optimizer`` family          — AdamW / Adafactor (train/optimizer.py).

On one process the data-parallel world is 1 (``data_parallel_size``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.models.common import tree_flatten, tree_unflatten
from repro_torch.models.model import Model
from repro_torch.parallel.sharding import data_parallel_size
from repro_torch.runconfig import RunConfig
from repro_torch.train import optimizer as opt


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor


def init_state(model: Model, seed: int, rc: RunConfig,
               params=None) -> TrainState:
    """Parameters from ``model.init(seed)`` (or ``params``, e.g. a
    reference tree loaded with ``Model.params_from_numpy``), a fresh
    optimizer state and step 0, on ``model.device``."""
    if params is None:
        params = model.init(seed)
    return TrainState(params, opt.opt_init(params, rc),
                      torch.zeros((), dtype=torch.int32, device=model.device))


def _split_micro(batch: Dict[str, torch.Tensor], n_micro: int):
    """[B, ...] -> [n_micro, B/n_micro, ...] per batch leaf.

    ``positions`` (M-RoPE ids) is [3, B, S]: its batch dim is axis 1.
    """
    out = {}
    for key, x in batch.items():
        if key == "positions":
            b = x.shape[1]
            x = x.reshape((x.shape[0], n_micro, b // n_micro) + x.shape[2:])
            out[key] = torch.movedim(x, 1, 0)
        else:
            b = x.shape[0]
            out[key] = x.reshape((n_micro, b // n_micro) + x.shape[1:])
    return out


def loss_and_grads(model: Model, params, batch, rc: RunConfig):
    """(loss, metrics, grads): ``Model.loss`` and its gradient in every
    floating leaf of ``params`` (in the parameters' dtypes; a leaf the
    loss does not reach gets zeros), by ``torch.autograd.grad``.  The
    tensors returned carry no graph."""
    leaves, treedef = tree_flatten(params)
    ps = [p.detach().requires_grad_(p.is_floating_point()) for p in leaves]
    with torch.enable_grad():
        loss, metrics = model.loss(tree_unflatten(treedef, ps), batch, rc)
        want = [p for p in ps if p.requires_grad]
        got = iter(torch.autograd.grad(loss, want, allow_unused=True))
    grads = []
    for p in ps:
        g = next(got) if p.requires_grad else None
        grads.append(torch.zeros_like(p) if g is None else g)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(treedef, grads))


def make_train_step(model: Model, rc: RunConfig,
                    lr_schedule: Optional[Callable] = None, *,
                    mesh: Optional[Dict[str, int]] = None,
                    donate: bool = False):
    """The step function for this (model, RunConfig).

    ``mesh`` (axis name -> size) sets the data-parallel world the
    per-replica ``microbatch`` divides (1 without).  ``donate=True``
    writes the new parameters and optimizer state into the old state's
    tensors (a jitted step's donated input): the state passed in must not
    be used afterwards."""
    lr_schedule = lr_schedule or opt.cosine_schedule(
        rc.learning_rate, warmup=100, total=10_000)

    grad_dtype = torch.bfloat16 if rc.grad_allreduce_dtype == "bfloat16" \
        else torch.float32

    def step_fn(state: TrainState, batch: Dict[str, Any]):
        batch = {k: model._on_device(v) for k, v in batch.items()}
        b = batch["tokens"].shape[0]
        dp = data_parallel_size(rc.shard, mesh)
        per_replica = max(b // dp, 1)
        micro = rc.microbatch if rc.microbatch > 0 else per_replica
        n_micro = max(per_replica // min(micro, per_replica), 1)
        n_micro = min(n_micro, b)            # b must split into n_micro

        if n_micro == 1 or b % n_micro != 0:
            loss, metrics, grads = loss_and_grads(model, state.params, batch,
                                                  rc)
            g_leaves, treedef = tree_flatten(grads)
            g_leaves = [g.to(grad_dtype) for g in g_leaves]
        else:
            mbs = _split_micro(batch, n_micro)
            # per-microbatch reduction accumulates in the (possibly
            # compressed) reduction dtype right away; bulk mode
            # accumulates f32 and casts at the end
            acc_dtype = grad_dtype if rc.allreduce_per_microbatch \
                else torch.float32
            p_leaves, treedef = tree_flatten(state.params)
            g_acc = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
                     for p in p_leaves]
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=model.device)
            for i in range(n_micro):         # unrolled or scanned alike
                mb = {k: v[i] for k, v in mbs.items()}
                loss, _, g = loss_and_grads(model, state.params, mb, rc)
                for j, x in enumerate(tree_flatten(g)[0]):
                    x = x.to(grad_dtype)
                    g_acc[j] = g_acc[j] + (x if rc.allreduce_per_microbatch
                                           else x.float())
                del g
                loss_sum = loss_sum + loss
            g_leaves = [(g.float() / n_micro).to(grad_dtype) for g in g_acc]
            del g_acc
            loss = loss_sum / n_micro
            metrics = {"nll": loss,
                       "aux": torch.zeros((), dtype=torch.float32,
                                          device=model.device)}

        grads = tree_unflatten(treedef, g_leaves)
        lr = lr_schedule(state.step)
        gnorm = opt.global_norm(grads)
        new_params, new_opt = opt.opt_update(grads, state.opt_state,
                                             state.params, rc, lr, donate)
        out_metrics = {"loss": loss.float(), "grad_norm": gnorm, "lr": lr,
                       **{k: v.float() for k, v in metrics.items()}}
        return TrainState(new_params, new_opt, state.step + 1), out_metrics

    return step_fn

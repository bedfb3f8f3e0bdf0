"""Train-step factory: microbatched grad accumulation under RunConfig knobs
(from ``repro.train.train_loop``).

``make_train_step(model, rc)`` returns ``step_fn(state, batch) ->
(new_state, metrics)``.  Gradients come from ``torch.autograd.grad`` of
``Model.loss`` over the parameter tree's leaves (``loss_and_grads``).
Knobs that shape the step:

* ``microbatch``                — grad-accumulation split (per replica);
* ``remat_policy``              — applied inside the model backbone;
* ``grad_allreduce_dtype``      — the dtype gradients are cast to before
  the cross-replica reduction, and so accumulated in;
* ``allreduce_per_microbatch``  — accumulate in that dtype per microbatch
  instead of float32 with one cast at the end;
* ``grad_accum_unroll``         — the reference's unrolled loop or
  ``lax.scan``; both are the same Python loop here, with the same numbers;
* ``optimizer`` family          — AdamW / Adafactor (train/optimizer.py).

Under an ambient process mesh (``launch.mesh.ProcessMesh``, ``with
mesh:``) the step is the reference's sharded step: the state is this
rank's blocks of ``shardings_for(state_axes, rc.shard.resolve(mesh))``
(``state_placements``; ``shard_state`` from global parameters, or
``init_local_state`` drawing the blocks alone), the batch is this data
rank's rows of the global batch (``rank_batch``: its block of each of the
reference's global microbatches in turn, ``train.data.data_slice``), and
the per-replica ``microbatch`` divides them: microbatch i of every data
rank together is the reference's global microbatch i, whose MoE routing
statistics (``models/moe.py``) are reduced over the data axes.  Each leaf's gradient is
summed over the data ranks exactly once, in ``grad_allreduce_dtype``: by
its ZeRO-3 gather's reduce-scatter where it is FSDP-sharded, by an
all-reduce after the accumulation elsewhere; the loss each replica
differentiates is scaled by 1 / (data-parallel size), so the sum is the
mean over the global batch.  Nothing here sums over the model axis: the
forward's collectives make each leaf's gradient whole on its model ranks
(Megatron's f and g; under sequence parallelism a weight that meets a
rank's block of the sequence is used under ``common.replicated``, whose
backward sums it), and the loss is the global mean on every model rank
(the cross entropy runs on the gathered sequence), so no leaf and no
metric is summed over it twice.  Off a mesh the data-parallel world is 1
(``data_parallel_size``) and the step is the one-process one.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.models.common import tree_flatten, tree_unflatten
from repro_torch.models.model import Model, shard_tree
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import (ambient_mesh, axis_index,
                                           batch_axes, data_parallel_size,
                                           shardings_for)
from repro_torch.runconfig import RunConfig
from repro_torch.train import optimizer as opt
from repro_torch.train.data import data_slice


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


def state_axes(model: Model, rc: RunConfig) -> TrainState:
    """The logical axes of the train state (the reference's)."""
    pax = model.param_axes()
    return TrainState(pax, opt.opt_state_axes(pax, rc), ())


def state_shapes(model: Model, rc: RunConfig, dtype=torch.bfloat16):
    """The train state as meta tensors (global shapes, no storage)."""
    params = model.param_shapes(dtype)
    return TrainState(params, opt.opt_init(params, rc),
                      torch.zeros((), dtype=torch.int32, device="meta"))


def state_placements(model: Model, rc: RunConfig, mesh=None) -> TrainState:
    """Each state leaf's Placement on ``mesh`` (the ambient one by
    default): the reference's ``shardings_for(state_axes,
    rc.shard.resolve(mesh))``."""
    mesh = mesh if mesh is not None else ambient_mesh()
    return shardings_for(state_shapes(model, rc), state_axes(model, rc),
                         rc.shard.resolve(mesh), mesh)


def param_placements(model: Model, rc: RunConfig, mesh=None):
    """The parameters' Placements (``state_placements(...).params``)."""
    mesh = mesh if mesh is not None else ambient_mesh()
    return shardings_for(model.param_shapes(), model.param_axes(),
                         rc.shard.resolve(mesh), mesh)


def shard_state(model: Model, rc: RunConfig, params, mesh=None) -> TrainState:
    """This rank's train state from the global parameters: its blocks of
    ``params`` and a fresh optimizer state of them, step 0.  The
    optimizer state made from the blocks must be the blocks of the
    global one's layout (``state_placements``): a leaf that is not
    raises ``ValueError``."""
    mesh = mesh if mesh is not None else ambient_mesh()
    pls = state_placements(model, rc, mesh)
    return _blocks_state(model, rc, shard_tree(params, pls.params,
                                               mesh.rank), pls)


def init_local_state(model: Model, seed: int, rc: RunConfig,
                     mesh=None) -> TrainState:
    """This rank's train state drawn block by block: its blocks of random
    parameters (``Model.init_blocks``: each block at its
    ``Placement.local_shape``, with the global leaf's init scale; no
    global leaf is built), a fresh optimizer state of them, step 0.  The
    state of a model no card holds whole (one chip of the production
    mesh).  Its numbers are not ``shard_state(model.init(seed))``'s."""
    mesh = mesh if mesh is not None else ambient_mesh()
    pls = state_placements(model, rc, mesh)
    return _blocks_state(model, rc, model.init_blocks(seed, pls.params,
                                                      mesh.rank), pls)


def _blocks_state(model: Model, rc: RunConfig, local, pls) -> TrainState:
    """The train state of parameter blocks ``local``, after checking that
    the optimizer state made from them is the blocks of the global one's
    layout ``pls``."""
    state = TrainState(local, opt.opt_init(local, rc),
                       torch.zeros((), dtype=torch.int32,
                                   device=model.device))
    shapes = tree_flatten(state_shapes(model, rc))[0]
    for i, (leaf, sh, pl) in enumerate(zip(tree_flatten(state)[0], shapes,
                                           tree_flatten(pls)[0])):
        if tuple(leaf.shape) != pl.local_shape(tuple(sh.shape)):
            raise ValueError(f"state leaf {i}: block {tuple(leaf.shape)} is "
                             f"not {pl.spec}'s block of {tuple(sh.shape)}")
    return state


def micro_count(rc: RunConfig, per_replica: int) -> int:
    """The microbatches a replica's ``per_replica`` rows split into under
    ``rc.microbatch`` (per replica; 0: one)."""
    micro = rc.microbatch if rc.microbatch > 0 else per_replica
    return max(per_replica // min(micro, per_replica), 1)


def rank_batch(batch: Dict[str, Any], rc: RunConfig, mesh=None):
    """This rank's rows of the global ``batch`` on ``mesh`` (the ambient
    one by default): its data rank's block of each of the step's global
    microbatches in turn (``data.data_slice``), so that the sharded
    step's microbatch i is the reference's global microbatch i."""
    mesh = mesh if mesh is not None else ambient_mesh()
    axes = batch_axes(rc.shard, mesh)
    count = 1
    for a in axes:
        count *= mesh.shape[a]
    b = batch["tokens"].shape[0]
    return data_slice(batch, axis_index(mesh, axes), count,
                      micro_count(rc, max(b // count, 1)))


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


def loss_and_grads(model: Model, params, batch, rc: RunConfig,
                   loss_scale: Optional[float] = None):
    """(loss, metrics, grads): ``Model.loss`` and its gradient in every
    floating leaf of ``params`` (in the parameters' dtypes; a leaf the
    loss does not reach gets zeros), by ``torch.autograd.grad``; with
    ``loss_scale`` the gradient is that of ``loss * loss_scale``.  The
    tensors returned carry no graph."""
    leaves, treedef = tree_flatten(params)
    ps = [p.detach().requires_grad_(p.is_floating_point()) for p in leaves]
    with torch.enable_grad():
        loss, metrics = model.loss(tree_unflatten(treedef, ps), batch, rc)
        want = [p for p in ps if p.requires_grad]
        target = loss if loss_scale is None else loss * loss_scale
        got = iter(torch.autograd.grad(target, want, allow_unused=True))
    grads = []
    for p in ps:
        g = next(got) if p.requires_grad else None
        grads.append(torch.zeros_like(p) if g is None else g)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(treedef, grads))


def step_grads(model: Model, params, batch: Dict[str, Any], rc: RunConfig, *,
               mesh: Optional[Dict[str, int]] = None, placements=None):
    """(loss, metrics, grads) of one step: the gradients accumulated over
    the microbatches in ``grad_allreduce_dtype`` and averaged.

    Off a process mesh ``batch`` is the global batch and ``mesh`` (axis
    name -> size) sets the data-parallel world the per-replica
    ``microbatch`` divides.  On one, ``batch`` is this data rank's rows
    (``rank_batch``), ``placements`` the parameters' Placements, and the gradients and the
    loss are the mean over the global batch (module docstring)."""
    pm = ambient_mesh()
    grad_dtype = torch.bfloat16 if rc.grad_allreduce_dtype == "bfloat16" \
        else torch.float32
    b = batch["tokens"].shape[0]
    if pm is None:
        dp, per_replica = 1, max(b // data_parallel_size(rc.shard, mesh), 1)
    else:
        dp, per_replica = data_parallel_size(rc.shard), b
    n_micro = min(micro_count(rc, per_replica), b)   # b must split
    scale = None if dp == 1 else 1.0 / dp

    if n_micro == 1 or b % n_micro != 0:
        loss, metrics, grads = loss_and_grads(model, params, batch, rc,
                                              scale)
        g_leaves, treedef = tree_flatten(grads)
        g_leaves = [g.to(grad_dtype) for g in g_leaves]
    else:
        mbs = _split_micro(batch, n_micro)
        # per-microbatch reduction accumulates in the (possibly
        # compressed) reduction dtype right away; bulk mode
        # accumulates f32 and casts at the end
        acc_dtype = grad_dtype if rc.allreduce_per_microbatch \
            else torch.float32
        p_leaves, treedef = tree_flatten(params)
        g_acc = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
                 for p in p_leaves]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=model.device)
        for i in range(n_micro):         # unrolled or scanned alike
            mb = {k: v[i] for k, v in mbs.items()}
            loss, _, g = loss_and_grads(model, params, mb, rc, scale)
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
    if scale is not None:
        # every leaf summed over the data ranks once: over the batch axes
        # its storage is not sharded on (an FSDP leaf's gather
        # reduce-scattered over those it is)
        summed = batch_axes(rc.shard, pm)
        for j, pl in enumerate(tree_flatten(placements)[0]):
            axes = tuple(a for a in summed if a not in pl.sharded_axes)
            g_leaves[j] = collectives.all_reduce(g_leaves[j], axes, pm)
        loss = collectives.all_reduce(loss.float() * scale, summed, pm)
        metrics = {k: collectives.all_reduce(v.float() * scale, summed, pm)
                   for k, v in metrics.items()}
    return loss, metrics, tree_unflatten(treedef, g_leaves)


def make_train_step(model: Model, rc: RunConfig,
                    lr_schedule: Optional[Callable] = None, *,
                    mesh: Optional[Dict[str, int]] = None,
                    donate: bool = False):
    """The step function for this (model, RunConfig).

    ``mesh`` (axis name -> size) sets the data-parallel world the
    per-replica ``microbatch`` divides (1 without); under an ambient
    process mesh the step is the sharded one (module docstring) and
    ``mesh`` is not read.  ``donate=True`` writes the new parameters and
    optimizer state into the old state's tensors (a jitted step's donated
    input): the state passed in must not be used afterwards."""
    lr_schedule = lr_schedule or opt.cosine_schedule(
        rc.learning_rate, warmup=100, total=10_000)

    def step_fn(state: TrainState, batch: Dict[str, Any]):
        batch = {k: model._on_device(v) for k, v in batch.items()}
        pls = param_placements(model, rc) if ambient_mesh() is not None \
            else None
        loss, metrics, grads = step_grads(model, state.params, batch, rc,
                                          mesh=mesh, placements=pls)
        lr = lr_schedule(state.step)
        gnorm = opt.global_norm(grads, pls)
        new_params, new_opt = opt.opt_update(grads, state.opt_state,
                                             state.params, rc, lr, donate,
                                             pls)
        out_metrics = {"loss": loss.float(), "grad_norm": gnorm, "lr": lr,
                       **{k: v.float() for k, v in metrics.items()}}
        return TrainState(new_params, new_opt, state.step + 1), out_metrics

    return step_fn

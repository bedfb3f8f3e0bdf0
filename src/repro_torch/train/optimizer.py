"""Optimizers from scratch: AdamW (f32 master weights) and Adafactor (from
``repro.train.optimizer``, the same math line for line).

The optimizer choice, betas, weight decay, clipping and master-weight
policy are all SAPPHIRE knobs (C3: ``optimizer`` gates ``beta1/beta2``).
State layout mirrors the parameters (NamedTuples of parameter-shaped
trees), so a state flattens in the reference's leaf order
(``models.common.tree_flatten``) and checkpoints cross packages.
``torch.optim`` is not used: its Adafactor differs and its AdamW orders
the decay term differently.

On a process mesh the state is this rank's blocks (``placements``: the
parameters' ``parallel.sharding.Placement`` tree): AdamW stays
elementwise on them, masters included; the global norm sums each leaf's
squares over the axes it is sharded on (a leaf replicated on an axis
counts once), and Adafactor's row and column means, its ``row_mean`` and
each leaf's update RMS are reduced over the axes their dimensions are
sharded on.  Off a mesh (``placements=None``) the arithmetic is the
one-process one.

Updates are plain tensor functions.  ``donate=True`` writes each new
leaf into the old state's and parameters' storage once it is computed
(the counterpart of donating the state to a jitted step), so a step holds
one copy of the state instead of two; the arithmetic is the same.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.common import tree_flatten, tree_map, tree_unflatten
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import ambient_mesh, map_axes
from repro_torch.runconfig import RunConfig


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any
    master: Any          # f32 master copy ([0]-shaped leaves when disabled)


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Any              # row second-moment factors
    vc: Any              # col second-moment factors
    v: Any               # full second moment for <2D params
    master: Any


def _f32(t):
    return tree_map(lambda x: x.to(torch.float32, copy=True), t)


def _empty(x):
    return torch.zeros((0,), dtype=torch.float32, device=x.device)


def global_norm(tree, placements=None) -> torch.Tensor:
    """sqrt of every leaf's sum of squares.  With ``placements`` (one per
    leaf, the tree of this rank's blocks) each leaf's sum is reduced over
    the axes it is sharded on, one all-reduce per set of axes."""
    leaves = [torch.sum(torch.square(x.float()))
              for x in tree_flatten(tree)[0]]
    if placements is not None:
        mesh = ambient_mesh()
        groups = {}
        for i, pl in enumerate(tree_flatten(placements)[0]):
            if pl.sharded_axes:
                groups.setdefault(pl.sharded_axes, []).append(i)
        for axes, idx in groups.items():
            summed = collectives.all_reduce(
                torch.stack([leaves[i] for i in idx]), axes, mesh)
            for j, i in enumerate(idx):
                leaves[i] = summed[j]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float, placements=None):
    norm = global_norm(grads, placements)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def _as_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def cosine_schedule(base_lr: float, warmup: int, total: int):
    def lr(step):
        step = _as_f32(step)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = base_lr * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


def linear_schedule(base_lr: float, warmup: int, total: int):
    def lr(step):
        step = _as_f32(step)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        return torch.where(step < warmup, warm, base_lr * (1 - prog))
    return lr


# ---------------------------------------------------------------------------
# the shared per-leaf update loop
# ---------------------------------------------------------------------------

def _apply(upd, grads, params, trees, rc: RunConfig, donate: bool,
           placements=None):
    """Run ``upd(g32, p_master, *state_leaves, pl) -> (new_master,
    *new_state)`` leaf by leaf (gradients clipped by the global norm as
    they are read; ``trees`` ends with the master tree; ``pl`` is the
    leaf's Placement, None off a mesh).  Returns (new_params, [new state
    trees but the master], new master tree)."""
    g_leaves, treedef = tree_flatten(grads)
    p_leaves = tree_flatten(params)[0]
    pls = tree_flatten(placements)[0] if placements is not None \
        else [None] * len(p_leaves)
    state_leaves = [tree_flatten(t)[0] for t in trees]
    scale = _clip_scale(global_norm(grads, placements), rc.grad_clip_norm)
    base = state_leaves[-1] if rc.master_weights_f32 else None
    outs = [[] for _ in range(len(trees) + 1)]   # params, then each tree
    for i, (g, p) in enumerate(zip(g_leaves, p_leaves)):
        g32 = g.float() * scale
        pm = base[i] if base is not None else p.to(torch.float32, copy=True)
        new = upd(g32, pm, *(s[i] for s in state_leaves[:-1]), pls[i])
        new_master, new_state = new[0], new[1:]
        new_p = new_master.to(p.dtype)
        if donate:
            new_p = p.copy_(new_p)
            new_state = [s[i].copy_(n) for s, n in
                         zip(state_leaves[:-1], new_state)]
            if base is not None:
                new_master = base[i].copy_(new_master)
        outs[0].append(new_p)
        for k, n in enumerate(new_state):
            outs[k + 1].append(n)
        if base is not None:
            outs[-1].append(new_master)
        del g32, new, new_master
    new_params = tree_unflatten(treedef, outs[0])
    new_trees = [tree_unflatten(treedef, o) for o in outs[1:-1]]
    master = tree_unflatten(treedef, outs[-1]) if rc.master_weights_f32 \
        else trees[-1]
    return new_params, new_trees, master


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params, rc: RunConfig) -> AdamWState:
    zeros = tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                     params)
    master = _f32(params) if rc.master_weights_f32 else \
        tree_map(_empty, params)
    dev = tree_flatten(params)[0][0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), zeros,
                      tree_map(torch.zeros_like, zeros), master)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, rc: RunConfig,
                 lr: torch.Tensor, donate: bool = False, placements=None):
    b1, b2, eps, wd = rc.beta1, rc.beta2, 1e-8, rc.weight_decay
    step = state.step + 1
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(gi, p, mi, vi, pl):
        mi = b1 * mi + (1 - b1) * gi
        vi = b2 * vi + (1 - b2) * gi * gi
        new_p = p - lr * (mi / bc1) / (torch.sqrt(vi / bc2) + eps) \
            - lr * wd * p
        return new_p, mi, vi

    new_params, (m, v), master = _apply(
        upd, grads, params, (state.m, state.v, state.master), rc, donate,
        placements)
    return new_params, AdamWState(step, m, v, master)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments — 1/3 the optimizer HBM of AdamW)
# ---------------------------------------------------------------------------

def _factored(x) -> bool:
    return x.dim() >= 2


def adafactor_init(params, rc: RunConfig) -> AdafactorState:
    def rows(x):
        return (torch.zeros(x.shape[:-1], dtype=torch.float32,
                            device=x.device) if _factored(x) else _empty(x))

    def cols(x):
        return (torch.zeros(x.shape[:-2] + x.shape[-1:], dtype=torch.float32,
                            device=x.device) if _factored(x) else _empty(x))

    def full(x):
        return (_empty(x) if _factored(x)
                else torch.zeros_like(x, dtype=torch.float32))

    master = _f32(params) if rc.master_weights_f32 else \
        tree_map(_empty, params)
    dev = tree_flatten(params)[0][0].device
    return AdafactorState(torch.zeros((), dtype=torch.int32, device=dev),
                          tree_map(rows, params), tree_map(cols, params),
                          tree_map(full, params), master)


def _mean(x: torch.Tensor, dim, axes, keepdim: bool = False):
    """``torch.mean`` of a block over ``dim`` (an int, or None for every
    dim) whose dims are sharded over ``axes``: the local sum reduced over
    them, divided by the global count."""
    if not axes:
        if dim is None:
            return torch.mean(x)
        return torch.mean(x, dim=dim, keepdim=keepdim)
    mesh = ambient_mesh()
    n = x.numel() if dim is None else x.shape[dim]
    for a in axes:
        n *= mesh.shape[a]
    s = torch.sum(x) if dim is None else torch.sum(x, dim=dim,
                                                   keepdim=keepdim)
    return collectives.all_reduce(s, axes, mesh) / n


@torch.no_grad()
def adafactor_update(grads, state: AdafactorState, params, rc: RunConfig,
                     lr: torch.Tensor, donate: bool = False,
                     placements=None):
    step = state.step + 1
    decay = 1.0 - (step.to(torch.float32) + 1.0) ** -0.8
    eps = 1e-30

    def upd(g, p_master, vr, vc, v, pl):
        def axes(dim):
            return () if pl is None else pl.dim_axes(dim % g.dim())
        every = () if pl is None else pl.sharded_axes
        if _factored(g):
            g2 = g * g + eps
            vr_new = decay * vr + (1 - decay) * _mean(g2, -1, axes(-1))
            vc_new = decay * vc + (1 - decay) * _mean(g2, -2, axes(-2))
            row_mean = _mean(vr_new, -1, axes(-2), keepdim=True)
            pre = (vr_new / torch.clamp(row_mean, min=eps))[..., None] \
                * vc_new[..., None, :]
            upd_ = g / torch.sqrt(torch.clamp(pre, min=eps))
            v_new = v
        else:
            v_new = decay * v + (1 - decay) * (g * g)
            upd_ = g / torch.sqrt(v_new + 1e-12)
            vr_new, vc_new = vr, vc
        # relative step size (Adafactor's update clipping)
        d = torch.sqrt(_mean(torch.square(upd_), None, every) + eps)
        upd_ = upd_ / torch.clamp(d, min=1.0)
        new_p = p_master - lr * upd_ - lr * rc.weight_decay * p_master
        return new_p, vr_new, vc_new, v_new

    new_params, (vr, vc, v), master = _apply(
        upd, grads, params, (state.vr, state.vc, state.v, state.master), rc,
        donate, placements)
    return new_params, AdafactorState(step, vr, vc, v, master)


# ---------------------------------------------------------------------------
# facade
# ---------------------------------------------------------------------------

def opt_init(params, rc: RunConfig):
    if rc.optimizer == "adamw":
        return adamw_init(params, rc)
    if rc.optimizer == "adafactor":
        return adafactor_init(params, rc)
    raise ValueError(rc.optimizer)


def opt_update(grads, state, params, rc: RunConfig, lr, donate: bool = False,
               placements=None):
    """One optimizer step; ``placements`` (the parameters' Placement
    tree) on a process mesh, where every tree is this rank's blocks."""
    if rc.optimizer == "adamw":
        return adamw_update(grads, state, params, rc, lr, donate, placements)
    return adafactor_update(grads, state, params, rc, lr, donate,
                            placements)


def opt_state_axes(param_axes, rc: RunConfig):
    """Logical axes for the optimizer state (mirrors parameter axes): a
    tree of logical-axis tuples in, the state's NamedTuple of such trees
    out."""
    if rc.optimizer == "adamw":
        master = param_axes if rc.master_weights_f32 else \
            map_axes(lambda _: (None,), param_axes)
        return AdamWState(step=(), m=param_axes, v=param_axes, master=master)
    rows = map_axes(lambda ax: tuple(ax[:-1]), param_axes)
    cols = map_axes(lambda ax: tuple(ax[:-2]) + tuple(ax[-1:])
                     if len(ax) >= 2 else (None,), param_axes)
    master = param_axes if rc.master_weights_f32 else \
        map_axes(lambda _: (None,), param_axes)
    return AdafactorState(step=(), vr=rows, vc=cols,
                          v=map_axes(lambda _: (None,), param_axes),
                          master=master)

"""Collectives over a process mesh's axes, for the sharded train step.

Each mesh axis has its own ``torch.distributed`` group
(``launch.mesh.ProcessMesh.group``); a collective over an axis of size 1
returns its input unchanged, so a one-rank axis adds no arithmetic.  A
dimension sharded over several axes is gathered minor axis first, which
orders its blocks as ``NamedSharding`` does (``Placement``).

Autograd-aware forms:

* :func:`all_gather` — forward an all-gather along a dimension; backward
  a reduce-scatter (sum) over the axes the computation was split on and a
  plain slice over the others (ZeRO-3's weight gather: each data rank's
  gradient is a partial sum of its own batch);
* :func:`copy_to` — Megatron's f: identity forward, all-reduce of the
  gradient backward (a replicated input of a rank-local computation);
* :func:`reduce_from` — Megatron's g: all-reduce forward, identity
  backward (rank-local partial sums made whole);

and, without autograd, :func:`all_reduce` (sum or max) for gradients,
norms and the cross entropy's max, and :func:`gather_to_host`, a leaf
assembled on rank 0's host block by block (a checkpoint's save).  A
reduction in a narrower dtype (``tp_reduce_dtype``,
``grad_allreduce_dtype``) casts the operand to it, reduces, and casts
back.

The gloo backend moves host tensors: under gloo a CUDA tensor is staged
through pinned host memory (copied out, reduced, copied back), on this
one code path chosen by the mesh's backend.  No error is caught and
retried another way.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _live(mesh, axes) -> Tuple[str, ...]:
    """The axes of ``axes`` that have more than one rank."""
    return tuple(a for a in _axes(axes) if mesh.shape.get(a, 1) > 1)


def _staged(mesh, x: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and x.is_cuda


def _host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def _empty_like_host(shape, x: torch.Tensor, staged: bool) -> torch.Tensor:
    if staged:
        return torch.empty(shape, dtype=x.dtype, pin_memory=True)
    return torch.empty(shape, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# one axis, dimension 0
# ---------------------------------------------------------------------------

def _all_reduce_axis(x: torch.Tensor, axis: str, mesh, op) -> torch.Tensor:
    staged = _staged(mesh, x)
    buf = _host(x) if staged else x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(buf, op=op, group=mesh.group(axis))
    return buf.to(x.device) if staged else buf


def _gather_axis(x: torch.Tensor, dim: int, axis: str, mesh) -> torch.Tensor:
    n = mesh.shape[axis]
    x0 = x.movedim(dim, 0).contiguous()
    staged = _staged(mesh, x)
    src = _host(x0) if staged else x0
    out = _empty_like_host((n * x0.shape[0],) + tuple(x0.shape[1:]), x0,
                           staged)
    dist.all_gather_into_tensor(out, src, group=mesh.group(axis))
    if staged:
        out = out.to(x.device)
    return out.movedim(0, dim)


def _scatter_axis(x: torch.Tensor, dim: int, axis: str, mesh,
                  summed: bool) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axis``: the sum of
    every rank's ``x`` when ``summed`` (a reduce-scatter), else its own."""
    n, i = mesh.shape[axis], mesh.coords[axis]
    if not summed:
        k = x.shape[dim] // n
        return x.narrow(dim, i * k, k)
    x0 = x.movedim(dim, 0).contiguous()
    staged = _staged(mesh, x)
    src = _host(x0) if staged else x0
    out = _empty_like_host((x0.shape[0] // n,) + tuple(x0.shape[1:]), x0,
                           staged)
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                               group=mesh.group(axis))
    if staged:
        out = out.to(x.device)
    return out.movedim(0, dim)


# ---------------------------------------------------------------------------
# without autograd
# ---------------------------------------------------------------------------

def all_reduce(x: torch.Tensor, axes, mesh, op: str = "sum",
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Sum (or max) of ``x`` over the ranks of ``axes``, reduced in
    ``dtype`` (``x``'s own when None) and returned in ``x``'s dtype; ``x``
    itself when every axis has one rank."""
    live = _live(mesh, axes)
    if not live:
        return x
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    y = x.detach().to(dtype) if dtype is not None else x.detach()
    for a in live:
        y = _all_reduce_axis(y, a, mesh, rop)
    return y.to(x.dtype)


def gather(x: torch.Tensor, dim: int, axes, mesh) -> torch.Tensor:
    """All-gather along ``dim`` over ``axes`` (major first), without
    autograd: the global block order of a ``Placement``."""
    for a in reversed(_live(mesh, axes)):
        x = _gather_axis(x, dim, a, mesh)
    return x


def gather_to_host(x: torch.Tensor, placement, mesh):
    """On rank 0, the global leaf of which ``x`` is this rank's block
    (laid out by ``placement``), built on the host; None on every other
    rank.  Every rank calls it.  Each distinct block crosses once, point
    to point over the world group, from the lowest rank that holds it
    (the ranks at coordinate 0 on every axis the leaf is replicated
    on), and rank 0 copies it into place at once: no rank holds more
    than its own blocks and one block in flight on its device."""
    shape = tuple(n * placement.count(d) for d, n in enumerate(x.shape))
    sharded = placement.sharded_axes
    world = 1
    for _, n in placement.mesh:
        world *= n
    owners = [r for r in range(world) if all(
        c == 0 for a, c in placement.coords(r).items() if a not in sharded)]
    staged = _staged(mesh, x)
    if mesh.rank != 0:
        if mesh.rank in owners:
            dist.send(_host(x) if staged else x.contiguous(), dst=0)
        return None
    out = torch.empty(shape, dtype=x.dtype)
    for r in owners:
        if r == 0:
            block = x
        else:
            block = _empty_like_host(x.shape, x, staged)
            dist.recv(block, src=r)
        out[placement.index(shape, r)].copy_(block)
    return out


# ---------------------------------------------------------------------------
# autograd forms
# ---------------------------------------------------------------------------

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axes, mesh, sum_axes, grad_dtype):
        ctx.dim, ctx.axes, ctx.mesh = dim, axes, mesh
        ctx.sum_axes, ctx.grad_dtype = sum_axes, grad_dtype
        return gather(x, dim, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh, dt = ctx.mesh, g.dtype
        if ctx.grad_dtype is not None:
            g = g.to(ctx.grad_dtype)
        for a in ctx.axes:                       # major first: reverse
            g = _scatter_axis(g, ctx.dim, a, mesh, a in ctx.sum_axes)
        return g.to(dt), None, None, None, None, None


def all_gather(x: torch.Tensor, dim: int, axes: Sequence[str], mesh, *,
               sum_axes: Sequence[str] = (),
               grad_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over ``axes`` (major first).  The
    backward reduce-scatters the gradient over the axes in ``sum_axes``
    (in ``grad_dtype`` when given) and takes this rank's block over the
    others."""
    live = _live(mesh, axes)
    if not live:
        return x
    return _AllGather.apply(x, dim, live, mesh, tuple(sum_axes), grad_dtype)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, dtype):
        ctx.axis, ctx.mesh, ctx.dtype = axis, mesh, dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis, ctx.mesh, dtype=ctx.dtype), None, \
            None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, dtype):
        return all_reduce(x, axis, mesh, dtype=dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def copy_to(x: torch.Tensor, axis: str, mesh,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Megatron's f over ``axis``: ``x`` forward; the gradient summed over
    the axis' ranks (in ``dtype``) backward."""
    if not _live(mesh, axis):
        return x
    return _CopyTo.apply(x, axis, mesh, dtype)


def reduce_from(x: torch.Tensor, axis: str, mesh,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Megatron's g over ``axis``: the sum over the axis' ranks (in
    ``dtype``) forward; the gradient unchanged backward."""
    if not _live(mesh, axis):
        return x
    return _ReduceFrom.apply(x, axis, mesh, dtype)

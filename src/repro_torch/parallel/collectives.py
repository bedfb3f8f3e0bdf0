"""Collectives over a process mesh's axes, for the sharded train step.

Each mesh axis has its own ``torch.distributed`` group
(``launch.mesh.ProcessMesh.group``); a collective over an axis of size 1
returns its input unchanged, so a one-rank axis adds no arithmetic.  A
dimension sharded over several axes is gathered minor axis first, which
orders its blocks as ``NamedSharding`` does (``Placement``).

Autograd-aware forms, Megatron's four operators among them:

* :func:`all_gather` — forward an all-gather along a dimension; backward
  a reduce-scatter (sum) over the axes the computation was split on and a
  plain slice over the others (ZeRO-3's weight gather: each data rank's
  gradient is a partial sum of its own batch);
* :func:`copy_to` — Megatron's f: identity forward, all-reduce of the
  gradient backward (a replicated input of a rank-local computation; also
  a weight replicated over the axis whose ranks each see a part of the
  tokens, so that its gradient is their sum);
* :func:`reduce_from` — Megatron's g: all-reduce forward, identity
  backward (rank-local partial sums made whole);
* :func:`gather_seq` — sequence parallelism's g-bar (the f of a
  sequence-split stream): all-gather along the sequence over the model
  axis forward, reduce-scatter of the gradient backward (the block input
  of the column-parallel projections);
* :func:`reduce_scatter` — sequence parallelism's g: reduce-scatter
  forward, all-gather of the gradient backward (the row-parallel
  projections' partial sums made whole and split along the sequence);
* :func:`psum` — all-reduce forward and backward: a sum over the ranks
  that every rank's loss reads, where the train step averages the ranks'
  gradients (the MoE routing statistics over the data axes), or a sum of
  partial products of which every rank reads its own part (a
  row-parallel projection into the SSM blocks' heads);
* :func:`all_to_all` — chunks moved between the ranks of an axis by a
  fixed route, backward the gradient moved back (the ``[x | z]`` halves
  of a column-parallel projection regrouped to each rank's channels);
* :func:`split` — Megatron's scatter: this rank's block forward, the
  gradient all-gathered backward (a computation every rank of the axis
  runs whole, whose result each rank keeps a block of);

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

On a virtual mesh (``launch.mesh.VirtualMesh``: one chip of a mesh,
alone in its process) each of the four primitives returns what it would
if every rank of the axis held this chip's operand: an all-gather tiles
the operand ``n`` times along its dimension, a reduce-scatter returns
``n`` times this chip's block, an all-reduce ``n`` times the operand (a
sum) or the operand (a max), an all-to-all in each slot this chip's own
chunk of the index the slot's source chunk has on its rank.  The result
is deterministic and finite (``n`` is a power of two on the production
meshes, so the scaling is exact in bf16) and has the real result's
shape, dtype and allocation, but its values are not the mesh's function:
what a step run this way shows is its shapes, bytes, FLOPs and kernel
launches, those of the chip it stands for.  :func:`gather_to_host` (a
checkpoint's save) raises there.

:func:`counting_collectives` tallies each primitive's result-shape bytes
by kind (``"all-reduce"``, ``"all-gather"``, ``"reduce-scatter"``, and
``"all-to-all"`` once one is issued: the reference's names and its
per-device proxy, ``repro.launch.roofline``'s ``COLLECTIVES``), in the
dtype actually reduced, on every backend.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# result-shape bytes by collective kind while a step is counted
# (``counting_collectives``); None otherwise.  Process-wide: autograd runs
# the backward and a remat group's recompute on a thread of its own.
_bytes: Optional[Dict[str, int]] = None
_bytes_lock = threading.Lock()
# the kinds every tally starts with; an all-to-all (only the SSM blocks'
# regroup issues one) enters a tally when it is issued
KINDS = ("all-reduce", "all-gather", "reduce-scatter")
ALL_TO_ALL = "all-to-all"


@contextlib.contextmanager
def counting_collectives():
    """Tally the result-shape bytes of every collective issued inside the
    block, on any thread and any backend, into the yielded dict (kind ->
    bytes: ``KINDS``, and ``ALL_TO_ALL`` once one is issued); one tally at
    a time."""
    global _bytes
    tally = dict.fromkeys(KINDS, 0)
    with _bytes_lock:
        if _bytes is not None:
            raise RuntimeError("collectives are already being counted")
        _bytes = tally
    try:
        yield tally
    finally:
        with _bytes_lock:
            _bytes = None


def _count(kind: str, out: torch.Tensor) -> torch.Tensor:
    if _bytes is not None:
        with _bytes_lock:
            if _bytes is not None:
                _bytes[kind] = _bytes.get(kind, 0) \
                    + out.numel() * out.element_size()
    return out


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _live(mesh, axes) -> Tuple[str, ...]:
    """The axes of ``axes`` that have more than one rank."""
    return tuple(a for a in _axes(axes) if mesh.shape.get(a, 1) > 1)


def _virtual(mesh) -> bool:
    return mesh.backend == "virtual"


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
    if _virtual(mesh):
        buf = x.clone(memory_format=torch.contiguous_format)
        if op == dist.ReduceOp.SUM:
            buf.mul_(mesh.shape[axis])
        return _count("all-reduce", buf)
    staged = _staged(mesh, x)
    buf = _host(x) if staged else x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(buf, op=op, group=mesh.group(axis))
    return _count("all-reduce", buf.to(x.device) if staged else buf)


def _gather_axis(x: torch.Tensor, dim: int, axis: str, mesh) -> torch.Tensor:
    n = mesh.shape[axis]
    x0 = x.movedim(dim, 0).contiguous()
    if _virtual(mesh):
        out = x0.repeat((n,) + (1,) * (x0.dim() - 1))
        return _count("all-gather", out).movedim(0, dim)
    staged = _staged(mesh, x)
    src = _host(x0) if staged else x0
    out = _empty_like_host((n * x0.shape[0],) + tuple(x0.shape[1:]), x0,
                           staged)
    dist.all_gather_into_tensor(out, src, group=mesh.group(axis))
    if staged:
        out = out.to(x.device)
    return _count("all-gather", out).movedim(0, dim)


def _scatter_axis(x: torch.Tensor, dim: int, axis: str, mesh,
                  summed: bool) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axis``: the sum of
    every rank's ``x`` when ``summed`` (a reduce-scatter), else its own."""
    n, i = mesh.shape[axis], mesh.coords[axis]
    if not summed:
        k = x.shape[dim] // n
        return x.narrow(dim, i * k, k)
    x0 = x.movedim(dim, 0)
    k = x0.shape[0] // n
    if _virtual(mesh):
        out = torch.empty((k,) + tuple(x0.shape[1:]), dtype=x.dtype,
                          device=x.device)
        torch.mul(x0[i * k:(i + 1) * k], n, out=out)
        return _count("reduce-scatter", out).movedim(0, dim)
    x0 = x0.contiguous()
    staged = _staged(mesh, x)
    src = _host(x0) if staged else x0
    out = _empty_like_host((k,) + tuple(x0.shape[1:]), x0, staged)
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                               group=mesh.group(axis))
    if staged:
        out = out.to(x.device)
    return _count("reduce-scatter", out).movedim(0, dim)


def _inverse(route: Tuple[int, ...]) -> Tuple[int, ...]:
    inv = [0] * len(route)
    for g, t in enumerate(route):
        inv[t] = g
    return tuple(inv)


def _all_to_all_axis(x: torch.Tensor, dim: int, axis: str, mesh,
                     route: Tuple[int, ...]) -> torch.Tensor:
    """``x``'s chunks along ``dim`` moved over ``axis`` by ``route``
    (:func:`all_to_all`)."""
    n, me = mesh.shape[axis], mesh.coords[axis]
    k = len(route) // n
    inv = _inverse(route)
    x0 = x.movedim(dim, 0)
    w = x0.shape[0] // k

    def chunk(t, j):
        return t[j * w:(j + 1) * w]
    if _virtual(mesh):
        out = torch.cat([chunk(x0, inv[me * k + p] % k) for p in range(k)])
        return _count(ALL_TO_ALL, out).movedim(0, dim)
    # my chunks in the order of their slots; my slots in the order they
    # arrive (by source rank, then by slot: each source sends in slot order)
    send = sorted(range(k), key=lambda j: route[me * k + j])
    arrive = sorted(range(k), key=lambda p: (inv[me * k + p] // k, p))
    in_splits = [w * sum(route[me * k + j] // k == r for j in range(k))
                 for r in range(n)]
    out_splits = [w * sum(inv[me * k + p] // k == r for p in range(k))
                  for r in range(n)]
    staged = _staged(mesh, x)
    src = torch.cat([chunk(x0, j) for j in send])
    if staged:
        src = _host(src)
    buf = _empty_like_host(tuple(x0.shape), x0, staged)
    dist.all_to_all_single(buf, src, out_splits, in_splits,
                           group=mesh.group(axis))
    if staged:
        buf = buf.to(x.device)
    slots = [None] * k
    for i, p in enumerate(arrive):
        slots[p] = chunk(buf, i)
    out = torch.cat(slots)
    return _count(ALL_TO_ALL, out).movedim(0, dim)


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
    than its own blocks and one block in flight on its device.  A
    virtual mesh holds no other rank's blocks: it raises."""
    if _virtual(mesh):
        raise ValueError("a virtual mesh holds one chip's blocks: no "
                         "checkpoint is gathered from it")
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


def gather_seq(x: torch.Tensor, mesh,
               grad_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The whole sequence from every model rank's block of ``x``
    [B, S/M, ...]: an all-gather along dimension 1 over the model axis;
    backward, the gradient reduce-scattered over it (in ``grad_dtype``),
    each rank's use of the gathered sequence being a part of the work."""
    return all_gather(x, 1, ("model",), mesh, sum_axes=("model",),
                      grad_dtype=grad_dtype)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return all_reduce(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axes, ctx.mesh), None, None


def psum(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``, forward; backward, the
    gradient summed over them too.  Each rank's loss reads the sum and the
    step averages the ranks' gradients, so each rank's part of ``x`` gets
    the sum of every rank's gradient of its loss: the whole gradient, once
    the step's average divides it again."""
    if not _live(mesh, axes):
        return x
    return _Psum.apply(x, _live(mesh, axes), mesh)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, mesh, dtype):
        ctx.dim, ctx.axis, ctx.mesh = dim, axis, mesh
        y = x.to(dtype) if dtype is not None else x
        return _scatter_axis(y, dim, axis, mesh, True).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return gather(g, ctx.dim, (ctx.axis,), ctx.mesh), None, None, None, \
            None


def reduce_scatter(x: torch.Tensor, dim: int, axis: str, mesh,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over ``axis``' ranks
    (reduced in ``dtype``, returned in ``x``'s); backward, the gradient
    all-gathered along ``dim``."""
    if not _live(mesh, axis):
        return x
    return _ReduceScatter.apply(x, dim, axis, mesh, dtype)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, mesh, route):
        ctx.dim, ctx.axis, ctx.mesh, ctx.route = dim, axis, mesh, route
        return _all_to_all_axis(x, dim, axis, mesh, route)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all_axis(g, ctx.dim, ctx.axis, ctx.mesh,
                                _inverse(ctx.route)), None, None, None, None


def all_to_all(x: torch.Tensor, dim: int, axis: str, mesh,
               route: Sequence[int]) -> torch.Tensor:
    """Chunks of ``x`` along ``dim`` moved between the ranks of ``axis``:
    every rank's ``dim`` holds k = len(route) / n equal chunks, chunk j of
    rank s is global chunk s·k + j, and global chunk g lands in global
    slot ``route[g]`` (slot t is chunk t mod k of rank t // k).  One
    all-to-all (its result bytes counted as ``"all-to-all"``); backward,
    the gradient moved back by the inverse route.  ``route`` is a
    permutation of range(n·k)."""
    if not _live(mesh, axis):
        return x
    route = tuple(int(t) for t in route)
    if sorted(route) != list(range(len(route))) \
            or len(route) % mesh.shape[axis]:
        raise ValueError(f"route {route} is not a permutation of whole "
                         f"chunks over {mesh.shape[axis]} ranks")
    return _AllToAll.apply(x, dim, axis, mesh, route)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, mesh):
        ctx.dim, ctx.axis, ctx.mesh = dim, axis, mesh
        return _scatter_axis(x, dim, axis, mesh, False).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather(g, ctx.dim, (ctx.axis,), ctx.mesh), None, None, None


def split(x: torch.Tensor, dim: int, axis: str, mesh) -> torch.Tensor:
    """Megatron's scatter over ``axis``: this rank's block of ``x`` along
    ``dim`` forward; backward, the blocks' gradients all-gathered, so that
    a computation every rank of the axis ran whole (from the same inputs)
    gets the whole gradient on every rank."""
    if not _live(mesh, axis):
        return x
    return _Split.apply(x, dim, axis, mesh)

"""Parameter helpers, norms and activations shared by the model zoo
(from ``repro.models.common``).

Parameters are plain dicts of tensors with the reference's names and
layout: a dense layer is ``{"w": [in, out], "b": [out]}``, and the
transformer stacks each pattern position's leaves over groups.  Random
initialisers draw from a ``torch.Generator`` on the parameters' device;
they do not reproduce ``jax.random``'s numbers (tests carry weights across
with ``Model.params_from_numpy``).  Everything here is differentiable by
autograd; the bf16-reduce matmul carries the reference's custom VJP
(``MatmulBf16``).  ``tree_flatten`` orders leaves as ``jax.tree``
does, so a checkpoint's leaves line up across the two packages.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16, "int8": torch.int8}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def trunc_normal(gen: torch.Generator, shape, scale: float,
                 dtype=torch.bfloat16, *, fan_in: Optional[int] = None):
    """Truncated-normal init (±2 std) with fan-in style scale; drawn in
    float32 on ``gen``'s device.  ``fan_in`` defaults to ``shape[0]`` as in
    the reference; a stacked ``[groups, in, out]`` leaf passes ``in``."""
    if fan_in is None:
        fan_in = shape[0] if len(shape) >= 2 else 0
    std = scale / math.sqrt(max(fan_in, 1)) if len(shape) >= 2 else scale
    if isinstance(gen, InitRecorder):
        return gen.record(shape, std, dtype)
    if gen.device.type == "meta":               # shapes only (MetaGenerator)
        return torch.empty(shape, dtype=dtype, device="meta")
    return trunc_normal_std(gen, shape, std, dtype)


def trunc_normal_std(gen: torch.Generator, shape, std: float,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """``std`` times a truncated standard normal (±2), drawn in float32 on
    ``gen``'s device."""
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * std).to(dtype)


class MetaGenerator:
    """Stands in for a ``torch.Generator`` to make a parameter tree of
    meta tensors: shapes and dtypes, no storage (``Model.param_shapes``)."""
    device = torch.device("meta")


class InitRecorder:
    """Stands in for a ``torch.Generator`` to record how an ``init`` fills
    each leaf, building none of the random ones: a truncated normal comes
    back as a meta tensor whose scale (from its global shape's fan-in)
    ``std`` keeps by the tensor's id; the constant leaves (zeros, ones)
    are built on the host, whole (``Model.init_blocks``)."""
    device = torch.device("cpu")

    def __init__(self):
        self.std = {}

    def record(self, shape, std: float, dtype) -> torch.Tensor:
        out = torch.empty(shape, dtype=dtype, device="meta")
        self.std[id(out)] = std
        return out


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               bias: bool = False, dtype=torch.bfloat16, scale: float = 1.0,
               stack: int = 0):
    """``{"w": [in, out], "b": [out]}``; with ``stack`` > 0 every leaf gets
    a leading ``[stack]`` axis of independent draws."""
    lead = (stack,) if stack else ()
    p = {"w": trunc_normal(gen, lead + (in_dim, out_dim), scale, dtype,
                           fan_in=in_dim)}
    if bias:
        p["b"] = torch.zeros(lead + (out_dim,), dtype=dtype,
                             device=gen.device)
    return p


def dense_axes(in_axis: Optional[str], out_axis: Optional[str], *,
               bias: bool = False):
    ax = {"w": (in_axis, out_axis)}
    if bias:
        ax["b"] = (out_axis,)
    return ax


def _matmul(x, w):
    """``x @ w``; operands of two types are promoted to the wider one
    first, as ``jnp.matmul`` does."""
    if w.dtype != x.dtype:
        wide = torch.promote_types(x.dtype, w.dtype)
        return torch.matmul(x.to(wide), w.to(wide))
    return torch.matmul(x, w)


def _matmul_to(a, b, out_dtype: torch.dtype):
    """``jnp.matmul(a, b, preferred_element_type=out_dtype)``: operands of
    two types are both converted to ``out_dtype`` first; the products are
    accumulated in float32 and the result rounded to ``out_dtype``."""
    if a.dtype != b.dtype:
        a, b = a.to(out_dtype), b.to(out_dtype)
    if a.dtype == torch.bfloat16 and out_dtype != torch.bfloat16:
        a, b = a.float(), b.float()
    return torch.matmul(a, b).to(out_dtype)


class MatmulBf16(torch.autograd.Function):
    """``jnp.matmul(x, w, preferred_element_type=bfloat16)`` and its VJP:
    the product rounded to bf16; backward, the cotangent cast to bf16 and
    dx a bf16 product rounded to bf16, dw in ``wgrad_dtype``.  float32 is
    the reference's custom VJP (``repro.models.common._mm_bf16_reduce``,
    the bf16-reduce projections: the narrowed dgrad all-reduce, wgrad
    accumulated in float32; on one card there is nothing to narrow, the
    roundings are the reference's all the same); bf16 is JAX's own VJP of
    a bf16-output dot (the MoE's bf16-reduce down-projection).  Operands
    are converted as ``jnp.matmul`` converts them (``_matmul_to``: a bf16
    cotangent times a float32 weight runs in bf16)."""

    @staticmethod
    def forward(ctx, x, w, wgrad_dtype=torch.float32):
        ctx.save_for_backward(x, w)
        ctx.wgrad_dtype = wgrad_dtype
        return _matmul_to(x, w, torch.bfloat16)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gb = g.to(torch.bfloat16)
        dx = _matmul_to(gb, w.T, torch.bfloat16)
        dw = _matmul_to(x.reshape(-1, x.shape[-1]).T,
                        gb.reshape(-1, gb.shape[-1]), ctx.wgrad_dtype)
        return dx.to(x.dtype), dw.to(w.dtype), None


def dense_apply(p, x, *, preferred: Optional[torch.dtype] = None,
                row_parallel: bool = False, seq_parallel: bool = False):
    """``x @ w (+ b)`` in x's dtype.

    ``row_parallel`` is Megatron's row-parallel form on the ambient
    mesh's model axis, for a weight whose input rows are this rank's
    block (``x`` this rank's columns): the partial products are summed
    over the model axis in ``preferred``, float32 when None, as the
    reference's partial sums combine, and the bias is added after.  With
    ``seq_parallel`` the sum is a reduce-scatter along the sequence
    (dimension 1): the result is this rank's block of the stream, and the
    bias, which then meets a part of the tokens, is used under
    :func:`replicated`.  A column-parallel weight (its output columns
    this rank's block) is a plain local product of an input under
    Megatron's f, or of the gathered sequence (:func:`column_input`).

    ``preferred`` is the reference's accumulation/partial-sum dtype.  With
    ``torch.bfloat16`` the product is rounded to bf16 before the bias is
    added (``MatmulBf16``, with the reference's custom VJP; on one card
    there is no cross-shard combine to narrow).  Otherwise the bias is added in
    float32: in float32 that is the reference's arithmetic, and on bf16
    operands the product (float32-accumulated by the matmul) is rounded
    once to bf16 before the float32 bias add.  The reference's
    ``precision`` argument has no counterpart: float32 products on the
    card run in full float32 (TF32 is off, ``device.resolve_device``).
    Operands of two types (bf16 activations into the xLSTM's float32 gate
    weights) are promoted to the wider one first, as ``jnp.matmul`` does.
    """
    if row_parallel:
        return _row_parallel(p, x, preferred, seq_parallel)
    if preferred == torch.bfloat16:
        y = MatmulBf16.apply(x, p["w"])
        if "b" in p:
            y = y + p["b"]
        return y.to(x.dtype)
    y = _matmul(x, p["w"])
    if "b" in p:
        y = y.float() + p["b"].float()
    return y.to(x.dtype)


def _row_parallel(p, x, preferred: Optional[torch.dtype],
                  seq_parallel: bool = False):
    """A row-parallel ``dense_apply``: this rank's partial product (bf16
    under ``preferred=bfloat16``, as ``MatmulBf16`` rounds it; float32
    otherwise), summed over the model axis in that dtype (all-reduced,
    or reduce-scattered along the sequence under ``seq_parallel``), then
    the bias."""
    from repro_torch.parallel import collectives
    from repro_torch.parallel.sharding import ambient_mesh
    mesh = ambient_mesh()
    if seq_parallel:
        def combine(y, dt):
            return collectives.reduce_scatter(y, 1, "model", mesh, dt)
        if "b" in p:
            p = {**p, "b": replicated(p["b"], mesh)}
    else:
        def combine(y, dt):
            return collectives.reduce_from(y, "model", mesh, dt)
    if preferred == torch.bfloat16:
        y = combine(MatmulBf16.apply(x, p["w"]), torch.bfloat16)
        if "b" in p:
            y = y + p["b"]
        return y.to(x.dtype)
    y = combine(_matmul_to(x, p["w"], torch.float32), None)
    if "b" in p:
        y = y + p["b"].float()
    return y.to(x.dtype)


def column_input(x, red: torch.dtype, mesh, seq_parallel: bool = False):
    """The input of a block's column-parallel projections under
    Megatron's f (``collectives.copy_to`` over the model axis), or, with
    ``seq_parallel``, the sequence gathered from every model rank's block
    (``collectives.gather_seq``, whose backward reduce-scatters the
    gradient): a function that gives each projection its input.  In
    float32 the projections share one f (one gather), so the input's
    gradient is summed over the model axis once for them all; under a
    bf16 reduce each has its own, as the reference combines each
    projection's dgrad in bf16 on its own (``_mm_bf16_reduce``) and one f
    would round their sum instead."""
    from repro_torch.parallel import collectives
    if seq_parallel:
        def f(t):
            return collectives.gather_seq(t, mesh, red)
    else:
        def f(t):
            return collectives.copy_to(t, "model", mesh, red)
    if red == torch.bfloat16:
        return lambda: f(x)
    xm = f(x)
    return lambda: xm


def replicated(tree, mesh):
    """Every tensor of ``tree`` (a weight replicated over the model axis)
    under ``collectives.copy_to`` over it, its gradient summed in
    float32: the weight's use where each model rank sees its own block of
    the sequence, whose gradients are the ranks' parts of the whole."""
    from repro_torch.parallel import collectives
    return tree_map(lambda t: collectives.copy_to(t, "model", mesh,
                                                  torch.float32), tree)


def row_parallel_psum(p, x):
    """A row-parallel ``dense_apply`` whose whole result every model rank
    reads only in part (its own heads of a projection into heads, or of
    the SSM's gates; the shared B and C of the SSD): the float32 partial
    products summed over the model axis in both directions
    (``collectives.psum``), so that each rank's partial product gets the
    gradient of every rank's part, where Megatron's g passes only this
    rank's.  The bias (replicated) is added after the sum under
    :func:`replicated`: each rank's gradient of it is its own part's.
    Operands of two types are promoted as ``dense_apply`` promotes them,
    and the result is in ``x``'s dtype, as ``dense_apply``'s."""
    from repro_torch.parallel import collectives
    from repro_torch.parallel.sharding import ambient_mesh
    mesh = ambient_mesh()
    w, dtype = p["w"], x.dtype
    if w.dtype != x.dtype:
        wide = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(wide), w.to(wide)
    y = collectives.psum(_matmul_to(x, w, torch.float32), "model", mesh)
    if "b" in p:
        y = y + replicated(p["b"], mesh).float()
    return y.to(dtype)


def inner_split(d: int, di: int, rc):
    """(mesh, lo, hi): this rank's channels [lo, hi) of an SSM block's
    inner width ``di`` where the model axis splits ``ssm_inner`` (the
    reference's rules and guard, on the widths the tags meet: ``di`` and
    the ``[x | z]`` projection's ``2·di``), else None.  A split of
    ``2·di`` that ``di`` does not share raises ``ValueError``."""
    from repro_torch.parallel.sharding import ambient_mesh, compute_range
    mesh = ambient_mesh()
    if mesh is None:
        return None
    rng = compute_range(("ssm_inner",), (di,), 0, rc.shard, mesh)
    wide = compute_range(("ssm_in", "ssm_inner"), (d, 2 * di), 1, rc.shard,
                         mesh)
    if (rng is None) != (wide is None):
        raise ValueError(f"ssm_inner of width {di} and {2 * di} split "
                         f"differently over the model axis "
                         f"({mesh.shape['model']} ranks) is not implemented")
    return None if rng is None else (mesh, rng[0], rng[1])


def regroup_halves(xz, mesh):
    """(x, z): this rank's channels of both halves of a column-parallel
    ``[x | z]`` projection (``[d, 2·di]``, its output tagged
    ``ssm_inner``) from its storage block of the columns.  A contiguous
    block of ``2·di`` over M ranks gives rank r units 2r and 2r + 1 of
    width c = di / M (x's on the lower half of the ranks, z's on the
    upper), where the rank's channels need unit r (x) and unit M + r
    (z): one all-to-all over the model axis moves each unit to its rank
    (``collectives.all_to_all``), and its backward moves the gradients
    back."""
    from repro_torch.parallel import collectives
    m = mesh.shape["model"]
    route = [(u % m) * 2 + u // m for u in range(2 * m)]
    xz = collectives.all_to_all(xz, xz.dim() - 1, "model", mesh, route)
    return torch.chunk(xz, 2, dim=-1)


def replicated_block(fn, x, mesh, seq_parallel: bool):
    """``fn(x)`` where every model rank computes the whole block from the
    same input with whole weights (no model-axis split): the one-process
    code, whose gradients are then whole on every rank and summed over
    the model axis nowhere.  Under sequence parallelism (``x`` this rank's
    block of the sequence) the sequence is all-gathered first, without a
    sum in its backward (every rank's input gradient is already whole),
    and the result is this rank's block (``collectives.split``: its
    backward gathers the blocks' gradients, so the whole computation gets
    the whole gradient on every rank)."""
    if not seq_parallel:
        return fn(x)
    from repro_torch.parallel import collectives
    x = collectives.all_gather(x, 1, ("model",), mesh)
    return collectives.split(fn(x), 1, "model", mesh)


def reduce_dtype(rc) -> torch.dtype:
    return torch.bfloat16 if getattr(rc, "tp_reduce_dtype", "float32") \
        == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(d: int, kind: str = "rmsnorm", dtype=torch.bfloat16, *,
              device=None, stack: int = 0):
    lead = (stack,) if stack else ()
    p = {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(lead + (d,), dtype=dtype, device=device)
    return p


def norm_axes(kind: str = "rmsnorm"):
    ax = {"scale": ("embed",)}
    if kind == "layernorm":
        ax["bias"] = ("embed",)
    return ax


def norm_apply(p, x, *, kind: str = "rmsnorm", eps: float = 1e-5):
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"].float()
        y = y + p["bias"].float()
    return y.to(x.dtype)


def rms_norm_split(p, x, width: int, mesh, eps: float = 1e-5):
    """``norm_apply``'s RMS norm of a width split over the model axis:
    ``x`` and ``p["scale"]`` are this rank's channels of ``width``.  The
    sum of squares is summed over the model axis in both directions
    (``collectives.psum``: every rank's statistic reads every rank's
    channels) and divided by the whole width."""
    from repro_torch.parallel import collectives
    xf = x.float()
    ss = collectives.psum(torch.sum(xf * xf, dim=-1, keepdim=True), "model",
                          mesh)
    y = xf * torch.rsqrt(ss / width + eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default


_ACTIVATIONS = {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}


def activation(name: str):
    return _ACTIVATIONS[name]


def softcap(x, cap: Optional[float]):
    """Grok-style logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def stack_axes(axes_tree):
    """Prepend the (unsharded) stack axis to every logical-axes tuple."""
    from repro_torch.parallel.sharding import map_axes
    return map_axes(lambda ax: (None,) + tuple(ax), axes_tree)


class Static:
    """A tree node that holds no leaf: its value rides in the treedef
    (``tree_flatten``) and ``tree_map`` passes it through, as JAX keeps a
    node's static data (a mesh decode state's global shape,
    ``transformer.ServeShape``)."""


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a nested dict/list/tuple tree (a
    :class:`Static` node comes back as it is)."""
    if isinstance(tree, Static):
        return tree
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten_with_path(tree):
    """([(path, leaf)], treedef): ``tree_flatten``'s leaves in its order,
    each with its path (a tuple of dict keys, sequence indices and
    NamedTuple field names)."""
    pairs = []

    def walk(t, path):
        if t is None:
            return None
        if isinstance(t, Static):
            return (Static, t)
        if isinstance(t, dict):
            return (dict, tuple((k, walk(t[k], path + (k,)))
                                for k in sorted(t)))
        if _is_namedtuple(t):
            return (type(t), tuple(walk(v, path + (f,))
                                   for f, v in zip(t._fields, t)))
        if isinstance(t, (list, tuple)):
            return (type(t), tuple(walk(v, path + (i,))
                                   for i, v in enumerate(t)))
        pairs.append((path, t))
        return _LEAF

    treedef = walk(tree, ())
    return pairs, treedef


def tree_flatten(tree):
    """(leaves, treedef) in ``jax.tree.flatten``'s order: dict keys
    sorted, list / tuple / NamedTuple entries in order, ``None`` an empty
    node, a :class:`Static` a node whose value the treedef keeps;
    anything else is a leaf.  ``tree_unflatten(treedef, leaves)``
    rebuilds the tree."""
    pairs, treedef = tree_flatten_with_path(tree)
    return [leaf for _, leaf in pairs], treedef


_LEAF = object()


def tree_unflatten(treedef, leaves):
    """The tree ``tree_flatten`` described by ``treedef``, with
    ``leaves`` (in that order) in place of its leaves."""
    it = iter(leaves)

    def build(d):
        if d is None:
            return None
        if d is _LEAF:
            return next(it)
        kind, children = d
        if kind is Static:
            return children
        if kind is dict:
            return {k: build(c) for k, c in children}
        if kind in (list, tuple):
            return kind(build(c) for c in children)
        return kind(*(build(c) for c in children))

    out = build(treedef)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the tree has")
    return out

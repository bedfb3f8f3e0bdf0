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
    if gen.device.type == "meta":               # shapes only (MetaGenerator)
        return torch.empty(shape, dtype=dtype, device="meta")
    if fan_in is None:
        fan_in = shape[0] if len(shape) >= 2 else 0
    std = scale / math.sqrt(max(fan_in, 1)) if len(shape) >= 2 else scale
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * std).to(dtype)


class MetaGenerator:
    """Stands in for a ``torch.Generator`` to make a parameter tree of
    meta tensors: shapes and dtypes, no storage (``Model.param_shapes``)."""
    device = torch.device("meta")


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
                row_parallel: bool = False):
    """``x @ w (+ b)`` in x's dtype.

    ``row_parallel`` is Megatron's row-parallel form on the ambient
    mesh's model axis, for a weight whose input rows are this rank's
    block (``x`` this rank's columns): the partial products are summed
    over the model axis in ``preferred``, float32 when None, as the
    reference's partial sums combine, and the bias is added after.  A
    column-parallel weight (its output columns this rank's block) is a
    plain local product of an input under Megatron's f
    (:func:`column_input`).

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
        return _row_parallel(p, x, preferred)
    if preferred == torch.bfloat16:
        y = MatmulBf16.apply(x, p["w"])
        if "b" in p:
            y = y + p["b"]
        return y.to(x.dtype)
    y = _matmul(x, p["w"])
    if "b" in p:
        y = y.float() + p["b"].float()
    return y.to(x.dtype)


def _row_parallel(p, x, preferred: Optional[torch.dtype]):
    """A row-parallel ``dense_apply``: this rank's partial product (bf16
    under ``preferred=bfloat16``, as ``MatmulBf16`` rounds it; float32
    otherwise), summed over the model axis in that dtype, then the bias."""
    from repro_torch.parallel import collectives
    from repro_torch.parallel.sharding import ambient_mesh
    mesh = ambient_mesh()
    if preferred == torch.bfloat16:
        y = collectives.reduce_from(MatmulBf16.apply(x, p["w"]), "model",
                                    mesh, torch.bfloat16)
        if "b" in p:
            y = y + p["b"]
        return y.to(x.dtype)
    y = collectives.reduce_from(_matmul_to(x, p["w"], torch.float32),
                                "model", mesh)
    if "b" in p:
        y = y + p["b"].float()
    return y.to(x.dtype)


def column_input(x, red: torch.dtype, mesh):
    """The input of a block's column-parallel projections under
    Megatron's f (``collectives.copy_to`` over the model axis): a
    function that gives each projection its input.  In float32 the
    projections share one f, so the input's gradient is summed over the
    model axis once for them all; under a bf16 reduce each has its own,
    as the reference combines each projection's dgrad in bf16 on its own
    (``_mm_bf16_reduce``) and one f would round their sum instead."""
    from repro_torch.parallel import collectives
    if red == torch.bfloat16:
        return lambda: collectives.copy_to(x, "model", mesh, red)
    xm = collectives.copy_to(x, "model", mesh, red)
    return lambda: xm


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


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a nested dict/list/tuple tree."""
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
    node; anything else is a leaf.  ``tree_unflatten(treedef, leaves)``
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
        if kind is dict:
            return {k: build(c) for k, c in children}
        if kind in (list, tuple):
            return kind(build(c) for c in children)
        return kind(*(build(c) for c in children))

    out = build(treedef)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the tree has")
    return out

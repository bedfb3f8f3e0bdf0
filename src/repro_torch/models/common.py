"""Parameter helpers, norms and activations shared by the model zoo
(from ``repro.models.common``, forward only).

Parameters are plain dicts of tensors with the reference's names and
layout: a dense layer is ``{"w": [in, out], "b": [out]}``, and the
transformer stacks each pattern position's leaves over groups.  Random
initialisers draw from a ``torch.Generator`` on the parameters' device;
they do not reproduce ``jax.random``'s numbers (tests carry weights across
with ``Model.params_from_numpy``).
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
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * std).to(dtype)


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


def dense_apply(p, x, *, preferred: Optional[torch.dtype] = None):
    """``x @ w (+ b)`` in x's dtype.

    ``preferred`` is the reference's accumulation/partial-sum dtype.  With
    ``torch.bfloat16`` the product is rounded to bf16 before the bias is
    added (``_mm_bf16_reduce``, forward only; on one card there is no
    cross-shard combine to narrow).  Otherwise the bias is added in
    float32: in float32 that is the reference's arithmetic, and on bf16
    operands the product (float32-accumulated by the matmul) is rounded
    once to bf16 before the float32 bias add.  The reference's
    ``precision`` argument has no counterpart: float32 products on the
    card run in full float32 (TF32 is off, ``device.resolve_device``).
    Operands of two types (bf16 activations into the xLSTM's float32 gate
    weights) are promoted to the wider one first, as ``jnp.matmul`` does.
    """
    w = p["w"]
    if w.dtype != x.dtype:
        wide = torch.promote_types(x.dtype, w.dtype)
        y = torch.matmul(x.to(wide), w.to(wide))
    else:
        y = torch.matmul(x, w)
    if preferred == torch.bfloat16:
        y = y.to(torch.bfloat16)
        if "b" in p:
            y = y + p["b"]
        return y.to(x.dtype)
    if "b" in p:
        y = y.float() + p["b"].float()
    return y.to(x.dtype)


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


def tree_leaves(tree):
    """Tensors of a nested dict/list/tuple parameter tree, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in tree for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tree_leaves(x)]
    return []


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a nested dict/list/tuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)

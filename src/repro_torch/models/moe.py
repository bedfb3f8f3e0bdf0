"""Mixture-of-Experts MLP with shared experts and top-k routing (from
``repro.models.moe``; ``axes`` gives the reference's logical axes, and
the sharded train step refuses the family on a mesh of more than one
rank: expert parallelism is not ported).
Autograd differentiates it for training; the bf16-reduce down-projection
carries JAX's VJP of a bf16-output dot (``common.MatmulBf16``).

Covers grok-1 (8e top-2, gelu), qwen2-moe (60e top-4 + 4 shared, silu) and
jamba (16e top-2).  Expert weights keep the reference's layout:
``gate``/``up`` ``[E, d, f]`` and ``down`` ``[E, f, d]`` (with the
transformer's leading group axis when stacked).

Two implementations (``moe_impl`` knob):

* ``dense``    — every expert on every token, routing weights masked to
  the top-k.  No token dropping, deterministic.  The up/gate products are
  one GEMM of the tokens ``[T, d]`` against the experts' weights laid out
  as ``[d, E·f]`` (a copy of the weights per call), so no ``[E, T, d]``
  copy of the tokens is made; the down projection is one GEMM over the
  joint (e, f) contraction after the routing scale, in the reference's
  order.
* ``dropping`` — Switch-style capacity-factor dispatch into
  ``[E, capacity, d]`` buffers, whose products scale with top-k only.

Every product takes the operands' dtype: a bf16 GEMM accumulates in
float32 and rounds once, as the reference's ``preferred_element_type=
float32`` followed by ``astype``.  The router runs in float32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import mlp
from repro_torch.models.common import (MatmulBf16, activation, reduce_dtype,
                                       trunc_normal)
from repro_torch.models.config import ModelConfig
from repro_torch.runconfig import RunConfig


def _expert_ff(cfg: ModelConfig) -> int:
    return cfg.moe_d_ff if cfg.moe_d_ff is not None else cfg.d_ff


def init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
         stack: int = 0):
    """Router ``[d, E]`` (float32), experts ``[E, d, f]`` / ``[E, f, d]``,
    shared experts as one dense MLP of width ``n_shared * f``.  As in the
    reference, an expert leaf's fan-in is its leading dim, E."""
    d, f, e = cfg.d_model, _expert_ff(cfg), cfg.n_experts
    lead = (stack,) if stack else ()

    def experts(shape):
        return trunc_normal(gen, lead + shape, 1.0, dtype, fan_in=e)

    p = {"router": {"w": trunc_normal(gen, lead + (d, e), 1.0,
                                      torch.float32, fan_in=d)}}
    if cfg.act == "silu":
        p["experts"] = {"gate": experts((e, d, f)), "up": experts((e, d, f)),
                        "down": experts((e, f, d))}
    else:
        p["experts"] = {"up": experts((e, d, f)), "down": experts((e, f, d))}
    if cfg.n_shared_experts:
        p["shared"] = mlp.init(gen, cfg, d_ff=cfg.n_shared_experts * f,
                               dtype=dtype, stack=stack)
    return p


def axes(cfg: ModelConfig):
    ax = {"router": {"w": ("embed", "experts")}}
    if cfg.act == "silu":
        ax["experts"] = {
            "gate": ("experts", "expert_in", "expert_ff"),
            "up": ("experts", "expert_in", "expert_ff"),
            "down": ("experts", "expert_ff", "expert_in"),
        }
    else:
        ax["experts"] = {
            "up": ("experts", "expert_in", "expert_ff"),
            "down": ("experts", "expert_ff", "expert_in"),
        }
    if cfg.n_shared_experts:
        ax["shared"] = mlp.axes(cfg)
    return ax


def _top_k(probs, k: int):
    """(values, indices) of the k largest entries of each row, ties broken
    toward the lower index as ``jax.lax.top_k`` does (a stable descending
    sort keeps equal entries in index order; ``torch.topk`` does not
    promise an order among ties)."""
    v, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _routing(params, x, cfg: ModelConfig):
    """Return (weights [T, E] with only top-k nonzero, aux_loss scalar,
    top-k indices [T, K], renormalised top-k weights [T, K])."""
    logits = torch.matmul(x.float(), params["router"]["w"].float())
    probs = torch.softmax(logits, dim=-1)
    topv, topi = _top_k(probs, cfg.n_experts_per_tok)
    topv = topv / topv.sum(dim=-1, keepdim=True)          # renormalize
    weights = torch.zeros_like(probs).scatter(-1, topi, topv)
    # Switch-style load-balancing auxiliary loss
    frac_tokens = (weights > 0).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = cfg.n_experts * torch.sum(frac_tokens * frac_probs)
    return weights, aux, topi, topv


def _expert_hidden(ep, h, act_name: str):
    """h [E, C, d] -> activated hidden z [E, C, f] (per-expert up/gate)."""
    act = activation(act_name)
    if "gate" in ep:
        z = act(torch.bmm(h, ep["gate"]))
        return z.mul_(torch.bmm(h, ep["up"]))
    return act(torch.bmm(h, ep["up"]))


def _expert_mlp(ep, h, act_name: str):
    """h [E, C, d] through per-expert weights [E, d, f] / [E, f, d]."""
    return torch.bmm(_expert_hidden(ep, h, act_name), ep["down"])


def _dense(ep, xt, weights, act_name: str, rc: RunConfig):
    """Every expert on every token, combined by the routing weights."""
    T, d = xt.shape
    E, _, f = ep["up"].shape
    act = activation(act_name)

    def up(w):                        # [T, d] @ [d, E·f] -> [T, E·f]
        return torch.matmul(xt, w.permute(1, 0, 2).reshape(d, E * f))

    if "gate" in ep:
        z = act(up(ep["gate"]))
        z.mul_(up(ep["up"]))
    else:
        z = act(up(ep["up"]))
    # the routing scale BEFORE the (e, f) joint contraction, as the
    # reference orders it: one [T, d] sum instead of [E, T, d] partials
    z.view(T, E, f).mul_(weights.to(z.dtype)[:, :, None])
    down = ep["down"].reshape(E * f, d)
    if reduce_dtype(rc) == torch.bfloat16:
        y = MatmulBf16.apply(z, down, torch.bfloat16)
    else:
        y = torch.matmul(z, down)
    return y.to(xt.dtype)


def apply(params, x, cfg: ModelConfig,
          rc: RunConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux_loss · router_aux_coef)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    weights, aux, topi, topv = _routing(params, xt, cfg)
    if rc.moe_impl == "dense":
        y = _dense(params["experts"], xt, weights, cfg.act, rc)
    elif rc.moe_impl == "dropping":
        y = _capacity_dispatch(params, xt, weights, topi, topv, cfg, rc)
    else:
        raise ValueError(rc.moe_impl)
    if cfg.n_shared_experts:
        y = y + mlp.apply(params["shared"], xt, cfg, rc)
    return y.reshape(B, S, d), aux * cfg.router_aux_coef


def _capacity(T: int, cfg: ModelConfig, rc: RunConfig) -> int:
    """Slots per expert: ``max(1, int(cf·T·K/E))``, at most T (1 at a
    two-token decode step of qwen2-moe's 60 experts, top-4)."""
    E, K = cfg.n_experts, cfg.n_experts_per_tok
    return min(max(1, int(rc.moe_capacity_factor * T * K / E)), T)


def _capacity_dispatch(params, xt, weights, topi, topv, cfg: ModelConfig,
                       rc: RunConfig):
    """Switch-style capacity-factor dispatch (token dropping)."""
    T, d = xt.shape
    E, K = cfg.n_experts, cfg.n_experts_per_tok
    cap = _capacity(T, cfg, rc)

    # position of each (token, k) inside its expert's buffer
    flat = F.one_hot(topi, E).reshape(T * K, E)               # [T*K, E]
    pos_in_expert = torch.cumsum(flat, dim=0) - flat
    pos = (pos_in_expert * flat).sum(dim=-1).reshape(T, K)
    keep = pos < cap                                          # [T, K]

    # scatter tokens into [E, capacity, d]; a dropped (token, k) goes to
    # the overflow row, which is thrown away.  The kept (expert, slot)
    # pairs are unique, so every kept slot gets exactly one add onto zero:
    # the accumulate only ever sums on the overflow row, and the result
    # is deterministic
    eidx = topi.reshape(-1)                                   # [T*K]
    cidx = torch.where(keep.reshape(-1), pos.reshape(-1),
                       torch.full_like(eidx, cap))
    buf = torch.zeros((E, cap + 1, d), dtype=xt.dtype, device=xt.device)
    buf.index_put_((eidx, cidx), xt.repeat_interleave(K, dim=0),
                   accumulate=True)
    y_buf = _expert_mlp(params["experts"], buf[:, :cap], cfg.act)

    # gather back with routing weights
    gathered = y_buf[eidx, torch.clamp(cidx, max=cap - 1)]    # [T*K, d]
    w = (topv.reshape(-1, 1) * keep.reshape(-1, 1)).to(xt.dtype)
    return (gathered * w).reshape(T, K, d).sum(dim=1)

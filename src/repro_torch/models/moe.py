"""Mixture-of-Experts MLP with shared experts and top-k routing (from
``repro.models.moe``; ``axes`` gives the reference's logical axes).
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

Every product takes the operands' dtype (of two, the wider one, as the
reference's einsums promote them): a bf16 GEMM accumulates in float32
and rounds once, as the reference's ``preferred_element_type=float32``
followed by ``astype``.  The router runs in float32.

Expert parallelism (an ambient process mesh, ``parallel.sharding``): a
rank's expert weights are its compute blocks, ``[E/M, d, f]`` where the
``experts`` rule takes the model axis and ``[E, d, f/M]`` where the
divisibility guard releases it to ``expert_ff``, or ``expert_parallel``
is off (no token all-to-all: the batch is not split over the model
axis).  The experts read the
tokens under Megatron's f (``common.column_input``: the gathered sequence
under sequence parallelism) and their output is a partial sum over the
model axis, all-reduced (or reduce-scattered along the sequence) in the
reference's dtype.  Every model rank forms the whole routing: a router
whose experts are split is column-parallel (its logits gathered over the
model axis), a whole one reads every token itself (under sequence
parallelism the sequence gathered, its gradient, whole on every rank,
coming back as the rank's block), and a rank's
experts take their routing weights under Megatron's f, so the router's
gradient is the ranks' parts summed once.  The routing statistics are
those of the reference's global microbatch, whose tokens are split over
the data axes (``train_loop`` gives each data rank its rows of it): the
auxiliary loss's token and probability fractions are summed over those
axes, and the dropping path's capacity and slots count every data
rank's tokens, a token's slot being its place in the global order.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import mlp
from repro_torch.models.common import (MatmulBf16, _matmul, _matmul_to,
                                       activation, column_input,
                                       reduce_dtype, trunc_normal)
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import (ambient_mesh, axis_index,
                                           batch_axes, compute_range)
from repro_torch.runconfig import RunConfig

EXPERT_AXES = ("experts", "expert_in", "expert_ff")


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


def _router_probs(params, x, cfg: ModelConfig):
    """float32 routing probabilities [T, E] of x [T, d].  A router whose
    experts the model axis splits (this rank's columns ``[d, E/M]``) is
    column-parallel: its logits are gathered along the experts over that
    axis, and the gradient of the gathered logits, whole on every model
    rank, comes back as this rank's columns."""
    logits = torch.matmul(x.float(), params["router"]["w"].float())
    if logits.shape[-1] != cfg.n_experts:
        logits = collectives.all_gather(logits, logits.dim() - 1,
                                        ("model",), ambient_mesh())
    return torch.softmax(logits, dim=-1)


def _aux_loss(weights, probs, cfg: ModelConfig, data_axes=()):
    """The Switch load-balancing loss ``E · Σ frac_tokens·frac_probs``.
    With ``data_axes`` (the axes a mesh splits the batch over) the
    fractions are means over every data rank's tokens: sums reduced over
    those axes, the probabilities' sum under ``collectives.psum`` (each
    rank's loss reads it, and the step averages the ranks' gradients)."""
    mesh = ambient_mesh()
    n = 1
    for a in data_axes:
        n *= mesh.shape[a]
    if n == 1:
        frac_tokens = (weights > 0).float().mean(dim=0)
        frac_probs = probs.mean(dim=0)
    else:
        tokens = probs.shape[0] * n
        frac_tokens = collectives.all_reduce(
            (weights > 0).float().sum(dim=0), data_axes, mesh) / tokens
        frac_probs = collectives.psum(probs.sum(dim=0), data_axes,
                                      mesh) / tokens
    return cfg.n_experts * torch.sum(frac_tokens * frac_probs)


def _routing(params, x, cfg: ModelConfig, data_axes=()):
    """Return (weights [T, E] with only top-k nonzero, aux_loss scalar,
    top-k indices [T, K], renormalised top-k weights [T, K]); ``data_axes``
    as :func:`_aux_loss`."""
    probs = _router_probs(params, x, cfg)
    topv, topi = _top_k(probs, cfg.n_experts_per_tok)
    topv = topv / topv.sum(dim=-1, keepdim=True)          # renormalize
    weights = torch.zeros_like(probs).scatter(-1, topi, topv)
    return weights, _aux_loss(weights, probs, cfg, data_axes), topi, topv


def _expert_hidden(ep, h, act_name: str):
    """h [E, C, d] -> activated hidden z [E, C, f] (per-expert up/gate)."""
    act = activation(act_name)
    if "gate" in ep:
        z = act(_matmul(h, ep["gate"]))
        return z.mul_(_matmul(h, ep["up"]))
    return act(_matmul(h, ep["up"]))


def _expert_mlp(ep, h, act_name: str):
    """h [E, C, d] through per-expert weights [E, d, f] / [E, f, d]."""
    return _matmul(_expert_hidden(ep, h, act_name), ep["down"])


def _dense(ep, xt, weights, act_name: str, rc: RunConfig, combine=None):
    """Every expert on every token, combined by the routing weights.  With
    ``combine`` (the experts split over the model axis: ``ep`` and
    ``weights``' columns this rank's) the down projection's sum is this
    rank's part, which ``combine(y, dtype)`` sums over the model axis."""
    T, d = xt.shape
    E, _, f = ep["up"].shape
    act = activation(act_name)

    def up(w):                        # [T, d] @ [d, E·f] -> [T, E·f]
        return _matmul(xt, w.permute(1, 0, 2).reshape(d, E * f))

    if "gate" in ep:
        z = act(up(ep["gate"]))
        z.mul_(up(ep["up"]))
    else:
        z = act(up(ep["up"]))
    # the routing scale BEFORE the (e, f) joint contraction, as the
    # reference orders it: one [T, d] sum instead of [E, T, d] partials
    z.view(T, E, f).mul_(weights.to(z.dtype)[:, :, None])
    down = ep["down"].reshape(E * f, d)
    bf16 = reduce_dtype(rc) == torch.bfloat16
    if combine is not None:
        if bf16:
            y = combine(MatmulBf16.apply(z, down, torch.bfloat16),
                        torch.bfloat16)
        else:
            y = combine(_matmul_to(z, down, torch.float32), None)
    elif bf16:
        y = MatmulBf16.apply(z, down, torch.bfloat16)
    else:
        y = _matmul(z, down)
    return y.to(xt.dtype)


def apply(params, x, cfg: ModelConfig, rc: RunConfig,
          seq_parallel: bool = False,
          data_axes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux_loss · router_aux_coef).  With
    ``seq_parallel`` ``x`` is this rank's block of the sequence and so is
    ``y``; the routing and the experts read the whole sequence.
    ``data_axes`` are the mesh axes whose ranks hold other tokens of the
    routing's batch (None: the batch's axes of more than one rank; ``()``
    where every data rank holds the same rows, as a serving batch that
    does not divide them)."""
    mesh = ambient_mesh()
    B, _, d = x.shape
    E, f = cfg.n_experts, _expert_ff(cfg)
    red = reduce_dtype(rc)
    e_rng = compute_range(EXPERT_AXES, (E, d, f), 0, rc.shard)
    f_rng = compute_range(EXPERT_AXES, (E, d, f), 2, rc.shard)
    # the experts' work is a part of the whole on each model rank: their
    # experts or their columns
    split = e_rng is not None or f_rng is not None
    if seq_parallel and not split:
        raise ValueError(f"{cfg.name}: sequence parallelism with neither "
                         f"the experts ({E}) nor their columns ({f}) split "
                         f"over the model axis is not implemented")
    if data_axes is None:
        data_axes = () if mesh is None else tuple(
            a for a in batch_axes(rc.shard, mesh) if mesh.shape[a] > 1)
    col = column_input(x, red, mesh, seq_parallel) if split \
        else (lambda: x)
    # the routing reads every token: a split router's product is
    # column-parallel (its input under f); a whole one's is formed whole
    # on every model rank
    if compute_range(("embed", "experts"), (d, E), 1, rc.shard) is not None:
        xr = col()
    elif seq_parallel:
        xr = collectives.all_gather(x, 1, ("model",), mesh)
    else:
        xr = x
    T = B * xr.shape[1]
    weights, aux, topi, topv = _routing(params, xr.reshape(T, d), cfg,
                                        data_axes)
    combine = None
    if split:
        def combine(y, dt):
            if seq_parallel:
                return collectives.reduce_scatter(
                    y.view(B, -1, d), 1, "model", mesh, dt).reshape(-1, d)
            return collectives.reduce_from(y, "model", mesh, dt)
    xt = col().reshape(T, d)
    if rc.moe_impl == "dense":
        if split:
            weights = collectives.copy_to(weights, "model", mesh,
                                          torch.float32)
        if e_rng is not None:
            weights = weights[:, e_rng[0]:e_rng[1]]
        y = _dense(params["experts"], xt, weights, cfg.act, rc, combine)
    elif rc.moe_impl == "dropping":
        if split:
            topv = collectives.copy_to(topv, "model", mesh, torch.float32)
        y = _capacity_dispatch(params, xt, weights, topi, topv, cfg, rc,
                               e_rng, data_axes, combine)
    else:
        raise ValueError(rc.moe_impl)
    y = y.reshape(B, -1, d)
    if cfg.n_shared_experts:
        y = y + mlp.apply(params["shared"], x, cfg, rc, seq_parallel,
                          d_ff=cfg.n_shared_experts * f)
    return y, aux * cfg.router_aux_coef


def _capacity(T: int, cfg: ModelConfig, rc: RunConfig) -> int:
    """Slots per expert: ``max(1, int(cf·T·K/E))``, at most T (1 at a
    two-token decode step of qwen2-moe's 60 experts, top-4)."""
    E, K = cfg.n_experts, cfg.n_experts_per_tok
    return min(max(1, int(rc.moe_capacity_factor * T * K / E)), T)


def _slot_offsets(counts, data_axes, mesh):
    """Each expert's slots taken by the data ranks before this one (in
    the global token order): the exclusive prefix over those ranks of
    their per-expert ``counts`` [E]."""
    every = collectives.gather(counts[None], 0, data_axes, mesh)  # [n, E]
    return every[:axis_index(mesh, data_axes)].sum(dim=0)


def _capacity_dispatch(params, xt, weights, topi, topv, cfg: ModelConfig,
                       rc: RunConfig, e_rng=None, data_axes=(),
                       combine=None):
    """Switch-style capacity-factor dispatch (token dropping).

    On a mesh: with ``data_axes`` the capacity is that of every data
    rank's tokens and a (token, k)'s slot its place among them (this
    rank's buffers hold its own tokens at those slots); with ``e_rng``
    this rank's buffers are its experts'; with ``combine`` (the experts'
    work split over the model axis) the gathered-back sum, in float32, is
    this rank's part and ``combine`` sums it over the model axis."""
    T, d = xt.shape
    E, K = cfg.n_experts, cfg.n_experts_per_tok
    mesh = ambient_mesh()
    n = 1
    for a in data_axes:
        n *= mesh.shape[a]
    cap = _capacity(T * n, cfg, rc)

    # position of each (token, k) inside its expert's buffer
    flat = F.one_hot(topi, E).reshape(T * K, E)               # [T*K, E]
    pos_in_expert = torch.cumsum(flat, dim=0) - flat
    if n > 1:
        pos_in_expert = pos_in_expert + _slot_offsets(flat.sum(dim=0),
                                                      data_axes, mesh)
    pos = (pos_in_expert * flat).sum(dim=-1).reshape(T, K)
    keep = pos < cap                                          # [T, K]

    # scatter tokens into [E, capacity, d]; a dropped (token, k), or one
    # routed to another rank's expert, goes to the overflow row, which is
    # thrown away.  The kept (expert, slot) pairs are unique, so every
    # kept slot gets exactly one add onto zero: the accumulate only ever
    # sums on the overflow row, and the result is deterministic
    eidx = topi.reshape(-1)                                   # [T*K]
    if e_rng is not None:
        lo, hi = e_rng
        keep = keep & (topi >= lo) & (topi < hi)
        eidx = (eidx - lo).clamp(0, hi - lo - 1)
    cidx = torch.where(keep.reshape(-1), pos.reshape(-1),
                       torch.full_like(eidx, cap))
    buf = torch.zeros((params["experts"]["up"].shape[0], cap + 1, d),
                      dtype=xt.dtype, device=xt.device)
    buf.index_put_((eidx, cidx), xt.repeat_interleave(K, dim=0),
                   accumulate=True)
    ep = params["experts"]
    if combine is None:
        y_buf = _expert_mlp(ep, buf[:, :cap], cfg.act)
    else:
        y_buf = _matmul_to(_expert_hidden(ep, buf[:, :cap], cfg.act),
                           ep["down"], torch.float32)

    # gather back with routing weights
    gathered = y_buf[eidx, torch.clamp(cidx, max=cap - 1)]    # [T*K, d]
    w = (topv.reshape(-1, 1) * keep.reshape(-1, 1)).to(gathered.dtype)
    y = (gathered * w).reshape(T, K, d).sum(dim=1)
    if combine is not None:
        y = combine(y, None)
    return y.to(xt.dtype)

"""Whisper-tiny backbone: encoder-decoder transformer (from
``repro.models.whisper``; ``axes`` gives the reference's logical axes,
and the sharded train step refuses whisper on a mesh of more than one
rank).
``loss_fn`` is the teacher-forced cross-entropy the train step
differentiates.

The conv/mel frontend is a stub, as in the reference: the caller provides
precomputed frame embeddings [B, 1500, d_model] (what the two conv layers
would make of a 30 s mel spectrogram).  Positions are sinusoidal, computed
on the fly.  Whisper-tiny is 4+4 layers; each stack keeps the reference's
layout, its leaves stacked over layers (``[L, ...]``), and a Python loop
over layers takes the place of its ``lax.scan``.

Attention: the encoder's self-attention is non-causal, the decoder's is
causal, and its cross-attention is non-causal over the encoder memory
projected once per layer; none uses rope.  Under
``attention_impl="flash"`` every one of them is the flash kernel on a
CUDA tensor (12 launches per prefill of whisper-tiny: 4 encoder, 4
decoder self, 4 cross).  Decode attends in plain torch, as in the
reference; the self-attention caches are updated in place.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.models import attention, mlp, transformer
from repro_torch.models.common import (norm_apply, norm_axes, norm_init,
                                       stack_axes, tree_map, trunc_normal)
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import WHISPER_ITEM, ambient_mesh, world_of
from repro_torch.runconfig import RunConfig


def sinusoid_positions(length: int, d: int, offset=0, *,
                       device=None) -> torch.Tensor:
    """[length, d] sinusoidal embedding (f32)."""
    pos = torch.arange(length, dtype=torch.float32, device=device) + offset
    return sinusoid_at(pos, d)


def sinusoid_at(pos, d: int) -> torch.Tensor:
    """pos [...] -> sinusoidal embedding [..., d] (f32)."""
    pos = torch.as_tensor(pos).float()
    div = torch.exp(-math.log(10000.0)
                    * torch.arange(0, d, 2, dtype=torch.float32,
                                   device=pos.device) / d)
    ang = pos[..., None] * div
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _norm(p, x, cfg: ModelConfig):
    return norm_apply(p, x, kind=cfg.norm, eps=cfg.norm_eps)


def init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16):
    """Random parameters on ``gen``'s device, in the reference's tree:
    ``embed``, ``encoder`` / ``decoder`` (leaves stacked over layers),
    ``enc_norm``, ``final_norm``."""
    dev = gen.device

    def norms(stack):
        return norm_init(cfg.d_model, cfg.norm, dtype, device=dev,
                         stack=stack)

    Le, Ld = cfg.n_encoder_layers, cfg.n_layers
    return {
        "embed": {"tok": trunc_normal(gen, (cfg.vocab_size, cfg.d_model),
                                      1.0, dtype)},
        "encoder": {"norm1": norms(Le),
                    "attn": attention.init(gen, cfg, dtype, stack=Le),
                    "norm2": norms(Le),
                    "mlp": mlp.init(gen, cfg, dtype=dtype, stack=Le)},
        "enc_norm": norms(0),
        "decoder": {"norm1": norms(Ld),
                    "attn": attention.init(gen, cfg, dtype, stack=Ld),
                    "norm_x": norms(Ld),
                    "xattn": attention.init(gen, cfg, dtype, stack=Ld),
                    "norm2": norms(Ld),
                    "mlp": mlp.init(gen, cfg, dtype=dtype, stack=Ld)},
        "final_norm": norms(0),
    }


def _enc_layer_axes(cfg: ModelConfig):
    return {
        "norm1": norm_axes(cfg.norm), "attn": attention.axes(cfg),
        "norm2": norm_axes(cfg.norm), "mlp": mlp.axes(cfg),
    }


def _dec_layer_axes(cfg: ModelConfig):
    return {
        "norm1": norm_axes(cfg.norm), "attn": attention.axes(cfg),
        "norm_x": norm_axes(cfg.norm), "xattn": attention.axes(cfg),
        "norm2": norm_axes(cfg.norm), "mlp": mlp.axes(cfg),
    }


def axes(cfg: ModelConfig):
    return {
        "embed": {"tok": ("vocab", "emb_embed")},
        "encoder": stack_axes(_enc_layer_axes(cfg)),
        "enc_norm": norm_axes(cfg.norm),
        "decoder": stack_axes(_dec_layer_axes(cfg)),
        "final_norm": norm_axes(cfg.norm),
    }


def _layer(stacked, i: int):
    """Layer ``i``'s views of a stack's leaves."""
    return tree_map(lambda t: t[i], stacked)


_positions = transformer._default_positions


def encode(params, frames, cfg: ModelConfig, rc: RunConfig):
    """frames [B, T_enc, d] (stub conv output) -> encoder memory."""
    B, T, d = frames.shape
    x = frames + sinusoid_positions(T, d, device=frames.device) \
        .to(frames.dtype)[None]
    positions = _positions(B, T, frames.device)
    for i in range(cfg.n_encoder_layers):
        layer = _layer(params["encoder"], i)
        h = _norm(layer["norm1"], x, cfg)
        x = x + attention.apply(layer["attn"], h, positions, cfg, rc,
                                causal=False, use_rope=False)
        h = _norm(layer["norm2"], x, cfg)
        x = x + mlp.apply(layer["mlp"], h, cfg, rc)
    return _norm(params["enc_norm"], x, cfg)


def _embed(params, tokens, pe, cfg: ModelConfig):
    x = transformer.embed(params, tokens, cfg)
    return x + pe.to(x.dtype)


def _decoder_layer(layer, x, positions, cross_kv, cfg: ModelConfig,
                   rc: RunConfig):
    """One decoder layer over the full sequence: causal self-attention,
    cross-attention over ``cross_kv``, MLP."""
    h = _norm(layer["norm1"], x, cfg)
    x = x + attention.apply(layer["attn"], h, positions, cfg, rc,
                            causal=True, use_rope=False)
    h = _norm(layer["norm_x"], x, cfg)
    x = x + attention.apply(layer["xattn"], h, positions, cfg, rc,
                            causal=False, kv_override=cross_kv,
                            use_rope=False)
    h = _norm(layer["norm2"], x, cfg)
    return x + mlp.apply(layer["mlp"], h, cfg, rc)


def decode_train(params, tokens, memory, cfg: ModelConfig, rc: RunConfig):
    """Teacher-forced decoder pass.  tokens [B,S] -> logits [B,S,V]."""
    B, S = tokens.shape
    x = _embed(params, tokens,
               sinusoid_positions(S, cfg.d_model, device=tokens.device)[None],
               cfg)
    positions = _positions(B, S, tokens.device)
    mem_pos = _positions(B, memory.shape[1], memory.device)
    for i in range(cfg.n_layers):
        layer = _layer(params["decoder"], i)
        kv = attention.project_kv(layer["xattn"], memory, mem_pos, cfg,
                                  use_rope=False)
        x = _decoder_layer(layer, x, positions, kv, cfg, rc)
    return transformer.unembed(params, _norm(params["final_norm"], x, cfg),
                               cfg)


class WhisperDecodeState(NamedTuple):
    self_k: torch.Tensor    # [L, B, S_max, Kh, D] (layout per rc)
    self_v: torch.Tensor
    cross_k: torch.Tensor   # [L, B, T_enc, Kh, D]
    cross_v: torch.Tensor
    pos: torch.Tensor       # [B] int32


def loss_fn(params, batch, cfg: ModelConfig, rc: RunConfig):
    """Teacher-forced cross-entropy over ``encode`` + ``decode_train``.
    batch: frames [B, T_enc, d], tokens and labels [B, S].  Returns (nll,
    {"nll", "aux" = 0}).  Refused (``ValueError``) on a mesh of more
    than one rank."""
    mesh = ambient_mesh()
    if mesh is not None and world_of(mesh) > 1:
        raise ValueError(f"whisper on a mesh of {world_of(mesh)} ranks is "
                         f"not implemented: {WHISPER_ITEM}")
    memory = encode(params, batch["frames"], cfg, rc)
    logits = decode_train(params, batch["tokens"], memory, cfg, rc)
    nll = transformer.xent(logits, batch["labels"])
    return nll, {"nll": nll,
                 "aux": torch.zeros((), dtype=torch.float32,
                                    device=nll.device)}


def init_decode_state(params, frames, batch: int, s_max: int,
                      cfg: ModelConfig, rc: RunConfig) -> WhisperDecodeState:
    """Encode once, pre-project cross K/V for every decoder layer into
    caches of the layout and dtype the decode path reads."""
    memory = encode(params, frames, cfg, rc)
    T_enc, dev = memory.shape[1], memory.device
    mem_pos = _positions(memory.shape[0], T_enc, dev)
    L = cfg.n_layers
    cross_k, cross_v = attention.init_cache(batch, T_enc, cfg, rc,
                                            device=dev, stack=L)
    for i in range(L):
        k, v = attention.project_kv(_layer(params["decoder"], i)["xattn"],
                                    memory, mem_pos, cfg, use_rope=False)
        attention.fill_cache(cross_k[i], k, rc)
        attention.fill_cache(cross_v[i], v, rc)
    self_k, self_v = attention.init_cache(batch, s_max, cfg, rc, device=dev,
                                          stack=L)
    return WhisperDecodeState(self_k=self_k, self_v=self_v,
                              cross_k=cross_k, cross_v=cross_v,
                              pos=torch.zeros((batch,), dtype=torch.int32,
                                              device=dev))


def prefill(params, tokens, frames, s_max: int, cfg: ModelConfig,
            rc: RunConfig):
    """Encode + teacher-forced full-sequence decoder pass, filling the
    self-attention caches.

    Returns (last-token logits [B,1,V], WhisperDecodeState at pos=S).
    The cross-attention reads the pre-projected memory back from its
    caches (dequantized from int8-sim, and made contiguous: under
    ``kv_layout="bhsd"`` the read is a transposed view, which the flash
    kernel would refuse rather than read).
    """
    B, S = tokens.shape
    state = init_decode_state(params, frames, B, s_max, cfg, rc)
    x = _embed(params, tokens,
               sinusoid_positions(S, cfg.d_model, device=tokens.device)[None],
               cfg)
    positions = _positions(B, S, tokens.device)
    for i in range(cfg.n_layers):
        layer = _layer(params["decoder"], i)
        h = _norm(layer["norm1"], x, cfg)
        k, v = attention.project_kv(layer["attn"], h, positions, cfg,
                                    use_rope=False)
        attention.fill_cache(state.self_k[i], k, rc)
        attention.fill_cache(state.self_v[i], v, rc)
        cross_kv = tuple(attention.read_cache_full(c[i], rc).contiguous()
                         for c in (state.cross_k, state.cross_v))
        x = _decoder_layer(layer, x, positions, cross_kv, cfg, rc)
    x = _norm(params["final_norm"], x, cfg)
    return transformer.unembed(params, x[:, -1:], cfg), state._replace(
        pos=torch.full((B,), S, dtype=torch.int32, device=tokens.device))


def decode_step(params, token, state: WhisperDecodeState, cfg: ModelConfig,
                rc: RunConfig):
    """token [B,1] -> (logits [B,1,V], new state).  The self-attention
    caches are updated in place; the new state shares them and has
    ``pos + 1``."""
    pos = state.pos
    # per-slot sinusoidal position (vector pos -> one PE row per slot)
    x = _embed(params, token, sinusoid_at(pos, cfg.d_model)[:, None, :], cfg)
    # the visible memory length is the reference's ``cross_k.shape[2]``:
    # T_enc under "bshd", but the kv-head count under "bhsd" (both
    # packages attend to that many rows there; ROADMAP queue C)
    T_enc = state.cross_k.shape[2]
    for i in range(cfg.n_layers):
        layer = _layer(params["decoder"], i)
        h = _norm(layer["norm1"], x, cfg)
        h, _, _ = attention.decode_apply(layer["attn"], h, state.self_k[i],
                                         state.self_v[i], pos, cfg, rc,
                                         use_rope=False)
        x = x + h
        h = _norm(layer["norm_x"], x, cfg)
        h, _, _ = attention.decode_apply(layer["xattn"], h,
                                         state.cross_k[i], state.cross_v[i],
                                         pos, cfg, rc, cross=True,
                                         cross_len=T_enc, use_rope=False)
        x = x + h
        h = _norm(layer["norm2"], x, cfg)
        x = x + mlp.apply(layer["mlp"], h, cfg, rc)
    x = _norm(params["final_norm"], x, cfg)
    return transformer.unembed(params, x, cfg), state._replace(pos=pos + 1)

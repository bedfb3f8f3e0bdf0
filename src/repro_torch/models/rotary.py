"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE
(from ``repro.models.rotary``).

M-RoPE (multimodal rotary, arXiv:2409.12191) splits the head dim into three
sections rotated by (temporal, height, width) position ids.  For the text
backbone (vision frontend is a stub) the three ids coincide, which reduces
to standard RoPE — but the section machinery is implemented and exercised so
the VLM config is faithful.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2] (f32)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> torch.Tensor:
    """positions [...,] -> angles [..., head_dim//2] (f32)."""
    inv = rope_freqs(head_dim, theta, positions.device)
    return positions[..., None].float() * inv


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Optional[Tuple[int, int, int]] = None
               ) -> torch.Tensor:
    """Apply rotary embedding.

    x         : [B, S, H, D] (D even)
    positions : [B, S] int for RoPE, or [3, B, S] for M-RoPE (t/h/w ids).
    """
    d = x.shape[-1]
    if mrope_sections is None:
        ang = rope_angles(positions, d, theta)          # [B, S, D/2]
    else:
        if positions.dim() == 2:                         # text-only: t=h=w
            positions = positions[None].expand((3,) + positions.shape)
        ang_full = rope_angles(positions, d, theta)      # [3, B, S, D/2]
        # Interleaved section split over frequency index (HF convention):
        # freqs [0:s0) from t, [s0:s0+s1) from h, [s0+s1:) from w.
        s0, s1, s2 = mrope_sections
        if s0 + s1 + s2 != d // 2:
            raise ValueError("mrope sections must sum to head_dim/2")
        parts, off = [], 0
        for sec_i, sec in enumerate((s0, s1, s2)):
            parts.append(ang_full[sec_i][..., off:off + sec])
            off += sec
        ang = torch.cat(parts, dim=-1)                   # [B, S, D/2]

    sin = torch.sin(ang)[:, :, None, :]                  # [B, S, 1, D/2]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype)

"""Wrapper of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

``flash_attention(q, k, v)`` takes the model-zoo layout q [B,Sq,H,D],
k/v [B,Sk,Kh,D] and returns [B,Sq,H,D] in q's dtype.  On CPU tensors it
returns the plain-torch version (``ref.py``); on CUDA tensors it launches
the kernel on the current stream or raises.  The kernel reads the inputs
in place through their strides and masks its ragged edges, so no padded or
transposed copy is made.  ``launches`` counts kernel launches.

The library is built with ``nvcc`` into ``build/flash_attention/`` at
first use (``kernels/build.py``).
"""

from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.build import NvccLibrary
from repro_torch.kernels.flash_attention.ref import reference_attention

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_LIB = NvccLibrary("flash_attention", SOURCE, {
    "flash_attention_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
       ctypes.c_float, ctypes.c_void_p]})
HEAD_DIMS = (16, 32, 64, 128, 256)          # compiled into the kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BH = 65535                             # grid.y limit

launches = 0
_lock = threading.Lock()


def reset_launch_counts() -> None:
    global launches
    with _lock:
        launches = 0


def build(verbose: bool = False) -> Path:
    """Compile the kernel library if this source has not been built yet;
    returns its path (``verbose`` prints ptxas's report)."""
    return _LIB.build(verbose)


def _check(q, k, v, window, softcap, block_q, block_k):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, "
                            f"got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D [B,S,heads,D], got "
                             f"{tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride along D")
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"want q [B,Sq,H,D], k/v [B,Sk,Kh,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    Kh = k.shape[2]
    if Kh == 0 or H % Kh != 0:
        raise ValueError(f"GQA: q heads ({H}) must be a multiple of kv "
                         f"heads ({Kh})")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} is not one of {HEAD_DIMS}")
    if window is not None and int(window) < 1:
        raise ValueError(f"window must be a positive int or None, "
                         f"got {window}")
    if softcap is not None and not float(softcap) > 0:
        raise ValueError(f"softcap must be positive or None, got {softcap}")
    if int(block_q) < 1 or int(block_k) < 1:
        raise ValueError(f"block sizes must be positive, got "
                         f"{block_q}, {block_k}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    block_q: int = 512, block_k: int = 512):
    """q [B,Sq,H,D], k/v [B,Sk,Kh,D] -> [B,Sq,H,D] (q.dtype).

    ``block_q``/``block_k`` are the TPU kernel's tile knobs
    (``flash_block_q``/``flash_block_k``).  They are checked and then
    ignored: the CUDA kernel always runs 64-row q tiles against 64-key KV
    tiles, and the plain version has no tiles, so the output does not
    depend on them.  The GPU's own tile knobs come with autotune.
    """
    global launches
    _check(q, k, v, window, softcap, block_q, block_k)
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, "
                         f"not {q.device}")
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    if B * H > _MAX_BH:
        raise ValueError(f"B*H = {B * H} exceeds the kernel's grid "
                         f"({_MAX_BH})")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3])
    lib = _LIB.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, H, Kh, Sq, Sk, D, strides, int(causal),
            0 if window is None else int(window),
            0.0 if softcap is None else float(softcap),
            1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    with _lock:
        launches += 1
    return out

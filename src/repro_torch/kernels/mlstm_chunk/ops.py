"""Wrapper of the hand-written CUDA chunkwise mLSTM kernel
(``csrc/mlstm_chunk.cu``).

``mlstm_chunk(q, k, v, logi, logf)`` takes the model-zoo layout q/k/v
[B,S,H,P] (k already scaled by 1/sqrt(P)) and float32 gates [B,S,H], and
returns h [B,S,H,P] in q's dtype.  On CPU tensors it returns the
plain-torch version (``ref.mlstm_chunkwise``); on CUDA tensors it launches
the kernel on the current stream or raises.  The kernel reads its inputs
in place through their strides, so no transposed copy is made; it needs a
float32 scratch of B*H*S*chunk elements for the chunks' q k^T, which the
wrapper allocates.  ``launches`` counts kernel launches.

The library is built with ``nvcc`` into ``build/mlstm_chunk/`` at first
use (``kernels/build.py``).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels.build import NvccLibrary
from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunkwise

SOURCE = Path(__file__).resolve().parent / "csrc" / "mlstm_chunk.cu"
_LIB = NvccLibrary("mlstm_chunk", SOURCE, {
    "mlstm_chunk_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
    + [ctypes.c_void_p, ctypes.c_void_p]})
HEAD_DIMS = (16, 32, 64, 128, 256, 512, 1024)   # compiled into the kernel
MAX_CHUNK = 2048                # the mlstm_chunk knob's upper end
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BH = 65535                 # grid.y limit

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


def _check(q, k, v, logi, logf, chunk):
    for name, t in (("q", q), ("k", k), ("v", v), ("logi", logi),
                    ("logf", logf)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, "
                            f"got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4 or t.shape != q.shape:
            raise ValueError(f"want q/k/v of one shape [B,S,H,P]; got "
                             f"{tuple(q.shape)}, {tuple(k.shape)}, "
                             f"{tuple(v.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride along P")
    for name, t in (("logi", logi), ("logf", logf)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != tuple(q.shape[:3]):
            raise ValueError(f"{name} must be [B,S,H] = "
                             f"{tuple(q.shape[:3])}, got {tuple(t.shape)}")
    P = q.shape[3]
    if P not in HEAD_DIMS:
        raise ValueError(f"head width P={P} is not one of {HEAD_DIMS}")
    if isinstance(chunk, bool) or not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"chunk must be a positive int, got {chunk!r}")


def mlstm_chunk(q, k, v, logi, logf, *, chunk: int = 256,
                num_warps=None, pipeline=None):
    """q/k/v [B,S,H,P], logi/logf [B,S,H] float32 -> h [B,S,H,P] (q.dtype).

    The chunk is ``min(chunk, S)`` and must divide S, as the reference
    asserts.  ``num_warps``/``pipeline`` are the reference's GPU scheduling
    knobs: accepted and ignored (the kernel runs 256 threads per block);
    they get their meaning with autotune.
    """
    global launches
    _check(q, k, v, logi, logf, chunk)
    B, S, H, P = q.shape
    c = min(chunk, S)
    if S and S % c:
        raise ValueError(f"chunk {c} must divide the sequence length {S}")
    if q.device.type == "cpu":
        return mlstm_chunkwise(q, k, v, logi, logf, c)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_chunk runs on cpu or cuda, not {q.device}")
    if c > MAX_CHUNK:
        raise ValueError(f"chunk {c} exceeds the kernel's {MAX_CHUNK}")
    if B * H > _MAX_BH:
        raise ValueError(f"B*H = {B * H} exceeds the kernel's grid "
                         f"({_MAX_BH})")
    out = torch.empty((B, S, H, P), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    qk = torch.empty((B * H, S, c), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 18)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *logi.stride(), *logf.stride(), *out.stride()[:3])
    lib = _LIB.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mlstm_chunk_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), logi.data_ptr(),
            logf.data_ptr(), out.data_ptr(), qk.data_ptr(), _DTYPES[q.dtype],
            B, S, H, P, c, strides, stream)
    if err != 0:
        raise RuntimeError(f"mlstm_chunk kernel launch failed: CUDA error "
                           f"{err}")
    with _lock:
        launches += 1
    return out

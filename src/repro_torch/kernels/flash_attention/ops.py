"""Wrapper of the hand-written CUDA flash-attention kernels
(``csrc/flash_attention_wgmma.cu`` and ``csrc/flash_attention.cu``).

``flash_attention(q, k, v)`` takes the model-zoo layout q [B,Sq,H,D],
k/v [B,Sk,Kh,D] and returns [B,Sq,H,D] in q's dtype.  Which kernel runs
is decided from the dtype and head dim alone (``route``).  On CPU tensors
it returns that kernel's plain-torch version (``ref.py``); on CUDA
tensors it launches the kernel on the current stream or raises
(``plain_version`` is the CPU path, for any device):

* ``"wgmma"``: bf16 with D in ``WGMMA_HEAD_DIMS`` (64, 128) runs the
  tensor-core kernel (wgmma products, TMA-staged K/V).  It rounds P to
  bf16 before P.V, so its plain version is
  ``reference_attention(..., p_dtype=torch.bfloat16)``.  TMA reads q, k, v
  in place, which needs 16-byte aligned base pointers and strides
  (``check_tma``): a view that breaks that raises ``ValueError``.
* ``"fma"``: float32, and bf16 at the other head dims, runs the fp32-FMA
  kernel, whose float32 path holds the reference's 2e-5 (no tensor-core
  type can).

A failed build or launch raises; nothing retries on the other route.
Both kernels read the inputs in place through their strides and mask
their ragged edges, so no padded or transposed copy is made.
``launches`` counts kernel launches, ``launches_wgmma`` and
``launches_fma`` those of each route.

The libraries are built with ``nvcc`` into ``build/flash_attention/`` at
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

CSRC = Path(__file__).resolve().parent / "csrc"
WGMMA_SOURCE = CSRC / "flash_attention_wgmma.cu"
FMA_SOURCE = CSRC / "flash_attention.cu"
_LIBS = {
    "wgmma": NvccLibrary("flash_attention", WGMMA_SOURCE, {
        "flash_attention_wgmma_launch": [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 6
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
           ctypes.c_float, ctypes.c_void_p]}),
    "fma": NvccLibrary("flash_attention", FMA_SOURCE, {
        "flash_attention_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
           ctypes.c_float, ctypes.c_void_p]}),
}
HEAD_DIMS = (16, 32, 64, 128, 256)          # compiled into the FMA kernel
WGMMA_HEAD_DIMS = (64, 128)                 # compiled into the wgmma kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535

launches = 0
launches_wgmma = 0
launches_fma = 0
_lock = threading.Lock()


def reset_launch_counts() -> None:
    global launches, launches_wgmma, launches_fma
    with _lock:
        launches = launches_wgmma = launches_fma = 0


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call runs: ``"wgmma"`` for bf16 at head dims 64
    and 128, ``"fma"`` otherwise."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "fma"


def plain_version(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None):
    """The plain-torch version of the kernel ``route`` picks for q: on the
    wgmma route P is rounded to bf16 before P.V, as the kernel does."""
    wgmma = route(q.dtype, q.shape[3]) == "wgmma"
    return reference_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap,
                               p_dtype=torch.bfloat16 if wgmma else None)


def build(verbose: bool = False, which: Optional[str] = None):
    """Compile the kernel libraries (``which``: one route's only) if these
    sources have not been built yet; returns the paths (``verbose``
    prints ptxas's report)."""
    names = [which] if which is not None else list(_LIBS)
    return [_LIBS[n].build(verbose) for n in names]


def load() -> None:
    """Load every library (built first if needed)."""
    for lib in _LIBS.values():
        lib.load()


def check_tma(*tensors) -> None:
    """Raise ``ValueError`` unless TMA can read each [B, S, heads, D]
    tensor in place: a 16-byte aligned base pointer and, for every dim of
    more than one element, a stride of a multiple of 16 bytes."""
    for t in tensors:
        item = t.element_size()
        if t.data_ptr() % 16:
            raise ValueError(f"TMA needs a 16-byte aligned base pointer; "
                             f"this view starts at {t.data_ptr():#x}")
        for dim in range(3):
            if t.shape[dim] > 1 and (t.stride(dim) * item) % 16:
                raise ValueError(
                    f"TMA needs strides of a multiple of 16 bytes; dim "
                    f"{dim} of a {tuple(t.shape)} view has stride "
                    f"{t.stride(dim)} ({t.stride(dim) * item} bytes)")


def _tma_strides(t):
    """t's element strides over (b, s, h); a dim of one element gets the
    stride of a contiguous layout (TMA checks it, never steps along it)."""
    B, S, heads, D = t.shape
    dense = (S * heads * D, heads * D, D)
    return [t.stride(i) if t.shape[i] > 1 else dense[i] for i in range(3)]


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
    ignored: the CUDA kernels run their own fixed tiles, and the plain
    version has no tiles, so the output does not depend on them.  The
    GPU's own tile knobs come with autotune.
    """
    _check(q, k, v, window, softcap, block_q, block_k)
    if q.device.type == "cpu":
        return plain_version(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, "
                         f"not {q.device}")
    if route(q.dtype, q.shape[3]) == "wgmma":
        return _wgmma(q, k, v, causal, window, softcap)
    return _fma(q, k, v, causal, window, softcap)


def _count(which: str) -> None:
    global launches, launches_wgmma, launches_fma
    with _lock:
        launches += 1
        if which == "wgmma":
            launches_wgmma += 1
        else:
            launches_fma += 1


def _wgmma(q, k, v, causal, window, softcap):
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    check_tma(q, k, v)
    if -(-Sq // 128) > _MAX_GRID_Y:          # 128 q rows per block
        raise ValueError(f"Sq = {Sq} exceeds the kernel's grid")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if Sk == 0:                  # nothing visible: zeros, as the kernel writes
        return out.zero_()
    strides = (ctypes.c_longlong * 12)(
        *_tma_strides(q), *_tma_strides(k), *_tma_strides(v),
        *out.stride()[:3])
    lib = _LIBS["wgmma"].load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, Kh, Sq, Sk, D, strides, int(causal),
            0 if window is None else int(window),
            0.0 if softcap is None else float(softcap),
            1.0 / math.sqrt(D), stream)
    if err < 0:
        raise RuntimeError(f"flash_attention (wgmma): TMA tensor map "
                           f"encoding failed (CUresult {-err})")
    if err != 0:
        raise RuntimeError(f"flash_attention (wgmma) kernel launch failed: "
                           f"CUDA error {err}")
    _count("wgmma")
    return out


def _fma(q, k, v, causal, window, softcap):
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    if B * H > _MAX_GRID_Y:
        raise ValueError(f"B*H = {B * H} exceeds the kernel's grid "
                         f"({_MAX_GRID_Y})")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3])
    lib = _LIBS["fma"].load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, H, Kh, Sq, Sk, D, strides, int(causal),
            0 if window is None else int(window),
            0.0 if softcap is None else float(softcap),
            1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention (fma) kernel launch failed: "
                           f"CUDA error {err}")
    _count("fma")
    return out

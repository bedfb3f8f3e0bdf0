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

Gradients.  When grad is enabled and q, k or v requires grad, a CUDA call
goes through an ``autograd.Function``: the forward kernel also writes
each row's log-sum-exp (float32 [B, H, Sq], an optional pointer of both
forwards; null on every other call, which then launches exactly as
before; on the FMA route the default tile alone has that store), and a
backward kernel of the same route gives dq, dk, dv in q's dtype.  Both
recompute P from the log-sum-exp, are deterministic (no atomics; two
calls give the same bits) and give a row with nothing visible zero
gradient:

* ``"wgmma"`` (``csrc/flash_attention_bwd_wgmma.cu``): a ``rowsum(dO *
  O)`` pre-pass, dQ, dK/dV per q head and a fixed-order sum over each KV
  head's group, every product on the tensor cores.  Their operands are
  bf16, so it rounds P to bf16 before P^T.dO and dS to bf16 before
  dS^T.Q and dS.K, and nowhere else; its plain version is
  ``ref.attention_grads(..., operand_dtype=torch.bfloat16)``, which
  rounds at those two places.  TMA reads q, k, v and dO in place: q, k,
  v or o that break the 16-byte rule raise ``ValueError`` (as in the
  forward); dO is autograd's cotangent, whose layout the caller does not
  choose, so a dO view that breaks it (or is broadcast, a stride of 0)
  is copied to a contiguous tensor first.
* ``"fma"`` (``csrc/flash_attention_bwd.cu``): the same three steps in
  float32 FMAs on float32 or bf16 inputs (P and dS stay float32); its
  plain version is ``ref.attention_grads`` (autograd of the plain
  version with P in float32), which the float32 path holds to 1e-5.

On CPU tensors ordinary autograd differentiates the plain version.

The tile knobs (``block_q``, ``block_k``, ``num_warps``, ``pipeline``, the
reference's) pick one of the route's instantiations on CUDA tensors
(:func:`resolve_tiles`; the sets are :func:`supported_tiles`) or raise
``ValueError`` naming the set; all ``None`` is the route's default
launch.  As in the reference, ``block_q``/``block_k`` are first clamped
to the sequence (to its power-of-two ceiling, no lower than the route's
smallest tile).  A knob without a counterpart in a route's design takes
only the value that design implies (``num_warps`` 4 on the wgmma route,
the warps of a warpgroup; ``pipeline`` 1 on the FMA route, which stages
one KV tile at a time).  On CPU tensors the plain version has no tiles
and takes any positive knob.  :func:`autotune_space` and
:func:`autotune_bench` are the reference's autotune hooks.
``launches`` counts forward kernel launches, ``launches_wgmma`` and
``launches_fma`` those of each route, ``launches_bwd`` the backward's
launch sets, and ``launches_bwd_wgmma`` and ``launches_bwd_fma`` those of
each route (``BWD_KERNELS`` kernels a set).  :func:`fwd_work` and
:func:`bwd_work` give a launch's operations and bytes (its bound); each
launch adds them to ``kernels.add_work``'s tally while a step is counted.

The libraries are built with ``nvcc`` into ``build/flash_attention/`` at
first use (``kernels/build.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import add_work, check_positive
from repro_torch.kernels.build import NvccLibrary
from repro_torch.kernels.flash_attention.ref import reference_attention
from repro_torch.kernels.tma import check_tma, tma_strides

CSRC = Path(__file__).resolve().parent / "csrc"
WGMMA_SOURCE = CSRC / "flash_attention_wgmma.cu"
FMA_SOURCE = CSRC / "flash_attention.cu"
BWD_SOURCE = CSRC / "flash_attention_bwd.cu"
BWD_WGMMA_SOURCE = CSRC / "flash_attention_bwd_wgmma.cu"
_LIBS = {
    "wgmma": NvccLibrary("flash_attention", WGMMA_SOURCE, {
        "flash_attention_wgmma_launch": [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 6
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
           ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2}),
    "fma": NvccLibrary("flash_attention", FMA_SOURCE, {
        "flash_attention_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
           ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2}),
    "bwd": NvccLibrary("flash_attention", BWD_SOURCE, {
        "flash_attention_bwd_launch": [ctypes.c_void_p] * 10
        + [ctypes.c_int] * 7
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
           ctypes.c_float, ctypes.c_void_p]}),
    "bwd_wgmma": NvccLibrary("flash_attention", BWD_WGMMA_SOURCE, {
        "flash_attention_bwd_wgmma_launch": [ctypes.c_void_p] * 12
        + [ctypes.c_int] * 6
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
           ctypes.c_float, ctypes.c_void_p]}),
}
HEAD_DIMS = (16, 32, 64, 128, 256)          # compiled into the FMA kernel
WGMMA_HEAD_DIMS = (64, 128)                 # compiled into the wgmma kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535
_SMEM_LIMIT = 232448            # a block's shared memory on sm_90
# kernels a backward launch set runs: the D_i pre-pass, dQ, dK/dV and
# (wgmma) the sum over each KV head's group
BWD_KERNELS = {"wgmma": 4, "fma": 3}
_BWD_PAD_ROWS = 128             # the wgmma backward's row statistics' padding

# (block_q, block_k, num_warps, pipeline) of each route's default launch
DEFAULT_TILES = {"wgmma": (128, 128, 4, 2), "fma": (64, 64, 8, 1)}
# the FMA kernel's tiles (block_q, block_k, num_warps) beyond its default,
# compiled for float32 at these head dims (csrc/flash_attention.cu)
FMA_TILES = ((16, 32, 2), (16, 64, 2), (32, 32, 4), (32, 64, 4),
             (32, 32, 8), (32, 64, 8), (64, 32, 4), (64, 64, 4),
             (64, 32, 8), (128, 32, 8), (128, 64, 8))
FMA_TILE_DIMS = (64, 128)
WGMMA_BLOCKS = (64, 128)        # block_q (64 rows a warpgroup), block_k
WGMMA_STAGES = (1, 2, 3, 4)

launches = 0
launches_wgmma = 0
launches_fma = 0
launches_bwd = 0
launches_bwd_wgmma = 0
launches_bwd_fma = 0
_lock = threading.Lock()


def reset_launch_counts() -> None:
    global launches, launches_wgmma, launches_fma
    global launches_bwd, launches_bwd_wgmma, launches_bwd_fma
    with _lock:
        launches = launches_wgmma = launches_fma = 0
        launches_bwd = launches_bwd_wgmma = launches_bwd_fma = 0


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


def _wgmma_smem(D: int, bq: int, bk: int, stages: int) -> int:
    """Shared memory of a wgmma launch: Q, the K/V ring, the barriers and
    the alignment slack (csrc/flash_attention_wgmma.cu's Smem)."""
    return bq * D * 2 + 2 * stages * bk * D * 2 + 8 * (1 + 4 * stages) + 1024


@functools.lru_cache(maxsize=None)
def supported_tiles(route: str, dtype: torch.dtype = torch.float32,
                    head_dim: int = 64) -> tuple:
    """Every (block_q, block_k, num_warps, pipeline) the card's kernel of
    ``route`` has for this dtype and head dim, the default first.  A pure
    function: no device is touched."""
    if route == "wgmma":
        out = [DEFAULT_TILES["wgmma"]]
        out += [(bq, bk, 4, st) for bq in WGMMA_BLOCKS
                for bk in WGMMA_BLOCKS for st in WGMMA_STAGES
                if _wgmma_smem(head_dim, bq, bk, st) <= _SMEM_LIMIT
                and (bq, bk, 4, st) != DEFAULT_TILES["wgmma"]]
        return tuple(out)
    if route != "fma":
        raise ValueError(f"unknown route {route!r}")
    out = [DEFAULT_TILES["fma"]]
    if dtype == torch.float32 and head_dim in FMA_TILE_DIMS:
        out += [(bq, bk, nw, 1) for bq, bk, nw in FMA_TILES]
    return tuple(out)


def _pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()



@functools.lru_cache(maxsize=4096)
def resolve_tiles(route: str, dtype: torch.dtype, head_dim: int, sq: int,
                  sk: int, block_q=None, block_k=None, num_warps=None,
                  pipeline=None) -> tuple:
    """The (block_q, block_k, num_warps, pipeline) a CUDA call of
    ``route`` launches.  All ``None``: the route's default launch.
    Otherwise a knob left ``None`` takes the default's value,
    ``block_q``/``block_k`` are clamped to the sequence (its power-of-two
    ceiling, no lower than the route's smallest tile; the reference
    clamps to the sequence rounded up to 8) and the result must be one of
    :func:`supported_tiles`, else ``ValueError`` names the set."""
    check_positive("flash_attention", block_q=block_q, block_k=block_k,
                   num_warps=num_warps, pipeline=pipeline)
    default = DEFAULT_TILES[route]
    knobs = (block_q, block_k, num_warps, pipeline)
    if all(k is None for k in knobs):
        return default
    bq, bk, nw, st = (d if k is None else int(k)
                      for k, d in zip(knobs, default))
    tiles = supported_tiles(route, dtype, head_dim)
    bq = min(bq, max(_pow2_ceil(sq), min(t[0] for t in tiles)))
    bk = min(bk, max(_pow2_ceil(sk), min(t[1] for t in tiles)))
    if (bq, bk, nw, st) not in tiles:
        raise ValueError(
            f"flash_attention ({route}, {str(dtype).split('.')[-1]}, D "
            f"{head_dim}): no instantiation for block_q={bq}, block_k={bk},"
            f" num_warps={nw}, pipeline={st}; (block_q, block_k, num_warps,"
            f" pipeline) in {tiles}")
    return bq, bk, nw, st


def build(verbose: bool = False, which: Optional[str] = None):
    """Compile the kernel libraries (``which``: ``"wgmma"``, ``"fma"``,
    ``"bwd"`` or ``"bwd_wgmma"`` only) if these sources have not been
    built yet; returns the paths (``verbose`` prints ptxas's report)."""
    names = [which] if which is not None else list(_LIBS)
    return [_LIBS[n].build(verbose) for n in names]


def load() -> None:
    """Load every library (built first if needed)."""
    for lib in _LIBS.values():
        lib.load()


def _check(q, k, v, window, softcap):
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


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    num_warps: Optional[int] = None,
                    pipeline: Optional[int] = None):
    """q [B,Sq,H,D], k/v [B,Sk,Kh,D] -> [B,Sq,H,D] (q.dtype).

    ``block_q``/``block_k``/``num_warps``/``pipeline``: the tile of a
    CUDA launch (module docstring); ``None`` each, the route's default.
    The plain version of a CPU call has no tiles.
    """
    _check(q, k, v, window, softcap)
    if q.device.type == "cpu":
        check_positive("flash_attention", block_q=block_q, block_k=block_k,
                       num_warps=num_warps, pipeline=pipeline)
        return plain_version(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, "
                         f"not {q.device}")
    which = route(q.dtype, q.shape[3])
    tiles = resolve_tiles(which, q.dtype, q.shape[3], q.shape[1],
                          k.shape[1], block_q, block_k, num_warps, pipeline)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if which == "fma" and tiles != DEFAULT_TILES["fma"]:
            raise ValueError(
                f"flash_attention (fma): a call that asks for a gradient "
                f"launches the default tile {DEFAULT_TILES['fma']}, the "
                f"only one compiled with the log-sum-exp store; got {tiles}")
        return _Flash.apply(q, k, v, causal, window, softcap, which, tiles)
    return _forward(q, k, v, causal, window, softcap, which, tiles)[0]


def _forward(q, k, v, causal, window, softcap, which, tiles, lse=False):
    """(out, lse or None): one launch of route ``which``; ``lse`` asks the
    kernel for the rows' log-sum-exp, float32 [B, H, Sq]."""
    B, Sq, H, _ = q.shape
    lse_t = torch.empty((B, H, Sq), dtype=torch.float32,
                        device=q.device) if lse else None
    launch = _wgmma if which == "wgmma" else _fma
    return launch(q, k, v, causal, window, softcap, tiles, lse_t), lse_t


class _Flash(torch.autograd.Function):
    """The forward kernel of the route, with each row's log-sum-exp
    saved, differentiated by the backward kernel (``_backward``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, which, tiles):
        out, lse = _forward(q, k, v, causal, window, softcap, which, tiles,
                            lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, dout, lse, *ctx.mask)
        return dq, dk, dv, None, None, None, None, None


def _count(which: str) -> None:
    global launches, launches_wgmma, launches_fma
    global launches_bwd, launches_bwd_wgmma, launches_bwd_fma
    with _lock:
        if which.startswith("bwd"):
            launches_bwd += 1
            if which == "bwd_wgmma":
                launches_bwd_wgmma += 1
            else:
                launches_bwd_fma += 1
            return
        launches += 1
        if which == "wgmma":
            launches_wgmma += 1
        else:
            launches_fma += 1


def _wgmma(q, k, v, causal, window, softcap,
           tiles=DEFAULT_TILES["wgmma"], lse=None):
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    bq, bk, _, stages = tiles
    check_tma(q, k, v)
    if -(-Sq // bq) > _MAX_GRID_Y:           # bq q rows per block
        raise ValueError(f"Sq = {Sq} exceeds the kernel's grid")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if Sk == 0:                  # nothing visible: zeros, as the kernel writes
        if lse is not None:
            lse.fill_(-math.inf)
        return out.zero_()
    strides = (ctypes.c_longlong * 12)(
        *tma_strides(q), *tma_strides(k), *tma_strides(v),
        *out.stride()[:3])
    lib = _LIBS["wgmma"].load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, Kh, Sq, Sk, D, strides, int(causal),
            0 if window is None else int(window),
            0.0 if softcap is None else float(softcap),
            1.0 / math.sqrt(D), bq, bk, stages,
            None if lse is None else lse.data_ptr(), stream)
    if err < 0:
        raise RuntimeError(f"flash_attention (wgmma): TMA tensor map "
                           f"encoding failed (CUresult {-err})")
    if err != 0:
        raise RuntimeError(f"flash_attention (wgmma) kernel launch failed: "
                           f"CUDA error {err}")
    _count("wgmma")
    _add_work(fwd_work, q, k, causal, window)
    return out


def _fma(q, k, v, causal, window, softcap, tiles=DEFAULT_TILES["fma"],
         lse=None):
    B, Sq, H, D = q.shape
    bq, bk, nw, _ = tiles
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
            1.0 / math.sqrt(D), bq, bk, nw,
            None if lse is None else lse.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention (fma) kernel launch failed: "
                           f"CUDA error {err}")
    _count("fma")
    _add_work(fwd_work, q, k, causal, window)
    return out


def _backward(q, k, v, out, dout, lse, causal, window, softcap):
    """(dq, dk, dv) in q's dtype from one launch set of the backward
    kernel of ``route(q.dtype, D)``; ``lse`` is the forward's float32
    [B, H, Sq]."""
    if route(q.dtype, q.shape[3]) == "wgmma":
        return _backward_wgmma(q, k, v, out, dout, lse, causal, window,
                               softcap)
    return _backward_fma(q, k, v, out, dout, lse, causal, window, softcap)


def _tma_readable(t) -> bool:
    """Whether TMA can read ``t`` in place: unit stride along D,
    ``check_tma``'s rule, and no broadcast dim."""
    try:
        check_tma(t)
    except ValueError:
        return False
    return t.stride(-1) == 1 and all(
        st != 0 for n, st in zip(t.shape, t.stride()) if n > 1)


def _backward_wgmma(q, k, v, out, dout, lse, causal, window, softcap):
    """The tensor-core route (``csrc/flash_attention_bwd_wgmma.cu``: the
    D_i pre-pass, dQ, dK/dV per q head, the group sum).  A dout view that
    TMA cannot read in place is copied to a contiguous tensor; q, k, v
    and out that it cannot read raise ``ValueError``."""
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    check_tma(q, k, v, out)
    dout = dout.to(q.dtype)
    if not _tma_readable(dout):
        dout = dout.contiguous()
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, Kh, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if Sq == 0 or Sk == 0 or B == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    sq_pad = -(-Sq // _BWD_PAD_ROWS) * _BWD_PAD_ROWS
    stats = torch.empty((B, H, sq_pad, 2), dtype=torch.float32,
                        device=q.device)
    dk_part = torch.empty((B, Sk, H, D), dtype=torch.float32,
                          device=q.device)
    dv_part = torch.empty_like(dk_part)
    strides = (ctypes.c_longlong * 24)(
        *tma_strides(q), *tma_strides(k), *tma_strides(v),
        *tma_strides(dout),
        *(st for t in (out, dq, dk, dv) for st in t.stride()[:3]))
    lib = _LIBS["bwd_wgmma"].load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_bwd_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), stats.data_ptr(),
            dk_part.data_ptr(), dv_part.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, Kh, Sq, Sk, D, strides,
            int(causal), 0 if window is None else int(window),
            0.0 if softcap is None else float(softcap), 1.0 / math.sqrt(D),
            stream)
    if err < 0:
        raise RuntimeError(f"flash_attention backward (wgmma): TMA tensor "
                           f"map encoding failed (CUresult {-err})")
    if err != 0:
        raise RuntimeError(f"flash_attention backward (wgmma) kernel "
                           f"launch failed: CUDA error {err}")
    _count("bwd_wgmma")
    _add_work(bwd_work, q, k, causal, window)
    return dq, dk, dv


def _backward_fma(q, k, v, out, dout, lse, causal, window, softcap):
    """The FMA route (``csrc/flash_attention_bwd.cu``: the D_i pre-pass,
    dK/dV summed over each KV head's group, dQ)."""
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    if B * H > _MAX_GRID_Y:
        raise ValueError(f"B*H = {B * H} exceeds the backward kernel's "
                         f"grid ({_MAX_GRID_Y})")
    dout = dout.to(q.dtype)
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, Kh, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if Sq == 0 or Sk == 0 or B == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    di = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *(st for t in (q, k, v, out, dout, dq, dk, dv)
          for st in t.stride()[:3]))
    lib = _LIBS["bwd"].load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype], B, H, Kh, Sq,
            Sk, D, strides, int(causal),
            0 if window is None else int(window),
            0.0 if softcap is None else float(softcap),
            1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward (fma) kernel "
                           f"launch failed: CUDA error {err}")
    _count("bwd_fma")
    _add_work(bwd_work, q, k, causal, window)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the work of one launch: the bounds ``chip_smoke.py`` holds the kernels
# to, and what ``launch.roofline.count_step`` adds for each launch
# ---------------------------------------------------------------------------

def visible_pairs(Sq: int, Sk: int, causal: bool,
                  window: Optional[int]) -> int:
    """(query, key) pairs the mask leaves visible (top-left causal)."""
    if window is None:
        if not causal:
            return Sq * Sk
        full = max(Sq - Sk, 0)                # rows that see every key
        return min(Sq, Sk) * (min(Sq, Sk) + 1) // 2 + full * Sk
    i = np.arange(Sq)
    hi = np.minimum(i if causal else Sk - 1, Sk - 1)
    lo = np.maximum(i - window + 1, 0)
    return int(np.maximum(hi - lo + 1, 0).sum())


def fwd_work(B, Sq, Sk, H, Kh, D, causal, window, itemsize):
    """(operations, bytes) of a forward launch: the two products QK^T and
    PV over the visible pairs; q, k, v read once and o written once.  The
    softmax's exp/max/sum (about 1/(2D) of the operations) and the
    log-sum-exp store are not counted."""
    flops = 4 * D * visible_pairs(Sq, Sk, causal, window) * B * H
    nbytes = itemsize * (2 * B * Sq * H * D + 2 * B * Sk * Kh * D)
    return flops, nbytes


def bwd_work(B, Sq, Sk, H, Kh, D, causal, window, itemsize):
    """(operations, bytes) of a backward launch set: the five products
    (QK^T again, dO V^T, P^T dO, dS^T Q, dS K) over the visible pairs; q,
    o, dO, dq and k, v, dk, dv each moved once and the float32
    log-sum-exp read."""
    flops = 10 * D * visible_pairs(Sq, Sk, causal, window) * B * H
    nbytes = itemsize * (4 * B * Sq * H * D + 4 * B * Sk * Kh * D) \
        + 4 * B * H * Sq
    return flops, nbytes


def _add_work(formula, q, k, causal, window):
    B, Sq, H, D = q.shape
    add_work(formula, B, Sq, k.shape[1], H, k.shape[2], D, causal, window,
             q.element_size())


# ---------------------------------------------------------------------------
# autotune hooks (repro_torch.kernels.autotune)
# ---------------------------------------------------------------------------

def autotune_space():
    """Tunable tiling/scheduling space of the flash forward (the
    reference's: knobs, ladders, ``inert`` flags, the tile budget).  On
    the card ``num_warps`` and ``pipeline`` are live where the route has
    a counterpart; points outside the route's set are refused."""
    from repro_torch.core.space import Knob, ProductLeq, Space, pow2_knob
    return Space(
        knobs=(
            pow2_knob("block_q", 512, 16, 1024,
                      description="query tile rows"),
            pow2_knob("block_k", 512, 16, 1024,
                      description="kv tile rows"),
            pow2_knob("num_warps", 4, 1, 8, inert=True,
                      description="GPU warps per block (inert off-GPU)"),
            Knob("pipeline", "int", 2, lo=1, hi=4, inert=True,
                 description="GPU pipeline stages (inert off-GPU)"),
        ),
        # the reference's [bq, bk] score tile budget
        constraints=(ProductLeq(("block_q", "block_k"), limit=512 * 512),),
    )


def autotune_native(D: int = 64, dtype=torch.float32, **shape) -> dict:
    """The default launch's tiles of the route a bench of this dtype and
    head dim takes, as a point of :func:`autotune_space`."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return dict(zip(("block_q", "block_k", "num_warps", "pipeline"),
                    DEFAULT_TILES[route(dtype, D)]))


def autotune_bench(B: int = 1, S: int = 192, H: int = 4, Kh: int = 2,
                   D: int = 64, causal: bool = True, seed: int = 0,
                   dtype=torch.float32, device: str = "cuda"):
    """``build(cfg) -> run()`` factory for ``KernelEvaluator`` (the
    reference's bench; ``dtype`` bfloat16 reaches the wgmma route at D 64
    and 128).  Inputs from ``seed``, made on ``device``."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen).to(dev, dtype)
               for shape in ((B, S, H, D), (B, S, Kh, D), (B, S, Kh, D)))

    def build(cfg):                      # cfg None: the default launch
        kw = {} if cfg is None else dict(
            block_q=int(cfg["block_q"]), block_k=int(cfg["block_k"]),
            num_warps=int(cfg.get("num_warps", 0)) or None,
            pipeline=int(cfg.get("pipeline", 0)) or None)

        def run():
            return flash_attention(q, k, v, causal=causal, **kw)
        return run
    return build

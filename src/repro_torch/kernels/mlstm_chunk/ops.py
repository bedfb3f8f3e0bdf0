"""Wrapper of the hand-written CUDA chunkwise mLSTM kernels
(``csrc/mlstm_chunk_wgmma.cu`` and ``csrc/mlstm_chunk.cu``).

``mlstm_chunk(q, k, v, logi, logf)`` takes the model-zoo layout q/k/v
[B,S,H,P] (k already scaled by 1/sqrt(P)) and float32 gates [B,S,H], and
returns h [B,S,H,P] in q's dtype.  Which kernel runs is decided from the
dtype, P and the chunk alone (``route``).  On CPU tensors it returns that
kernel's plain-torch version (``plain_version``); on CUDA tensors it
launches the kernel on the current stream or raises:

* ``"wgmma"``: bf16 with P in ``WGMMA_HEAD_DIMS`` and a chunk in
  ``WGMMA_CHUNKS`` runs the tensor-core kernel: the stabilisers of every
  chunk from the gates first, the chunk states in bf16, then every
  output tile of every chunk at once.  It rounds (q k^T) o W, k o wk and
  the stored state to bf16, so its plain version is
  ``mlstm_chunkwise(..., operand_dtype=torch.bfloat16)``.  TMA reads q, k,
  v in place (``check_tma``); it needs float32 scratch of about 5 B*H*S
  elements and bf16 states of B*H*(S/chunk - 1)*P^2 elements, which the
  wrapper allocates.
* ``"fma"``: float32, and bf16 at the other shapes, runs the fp32-FMA
  kernel, whose float32 path holds the reference's 5e-5; it needs a
  float32 scratch of B*H*S*chunk elements for the chunks' q k^T.

A failed build or launch raises; nothing retries on the other route.
Both kernels read the inputs in place through their strides.

Gradients.  When grad is enabled and an input requires grad, a CUDA call
goes through an ``autograd.Function``: its forward is the routed launch
above, unchanged, and its backward launches the same route's backward,
chosen with the forward and before any launch.  Each gives dq, dk, dv in
q's dtype and d logi, d logf in float32 from q, k, v, the gates, the
forward's output and its cotangent, holds the stabilisers constant (h
does not depend on them) and is deterministic (no atomics; two calls give
the same bits).  A failed build or launch raises; nothing retries on the
other route.

* ``"wgmma"``: ``csrc/mlstm_chunk_bwd_wgmma.cu`` (``_backward_wgmma``):
  every P x P product (the forward carry (k o wk)^T v, the reverse carry
  (scale_in q)^T dnum, C dnum, G_C v, G_C^T (k o wk)) and every causal
  chunk product (q k^T, dh v^T, dS k, dS^T q, A^T dnum) on wgmma with
  float32 accumulators; the rank-one terms of the augmented carries (n,
  G_n, beta, the ones-column of v~) in float32 beside them.  Besides the
  forward's roundings (S o W in A^T dnum, k o wk in the carry and in
  G_C^T (k o wk), the carried C in C dnum) it rounds to bf16, where a
  product reads them and nowhere else: dnum = dh / den (the reverse
  carry, C dnum, A^T dnum), scale_in o q (the reverse carry), dS (dS k,
  dS^T q) and G_C (G_C v, G_C^T (k o wk)).  Its plain version is
  ``ref.mlstm_chunkwise_grads(..., operand_dtype=torch.bfloat16,
  grad_operand_dtype=torch.bfloat16)``.  Its workspace is about 3
  B*H*S*P^2/chunk bf16 (C entering and G_C leaving each chunk, C as two
  slabs hi = bf16(C) and lo = bf16(C - hi)), 3 B*H*S*P bf16 (k o wk,
  scale_in q, dnum) and B*H*S*chunk x 12 bytes (S and dh v^T in float32,
  A and dS in bf16): 533.5 MB at xlstm-1.3b's layer at B=1, chunk 256
  (``wgmma_workspace_bytes``), against the FMA backward's 590 MB.
* ``"fma"``: ``csrc/mlstm_chunk_bwd.cu`` (``_backward``, fp32 FMAs on
  float32 or bf16 inputs; every P of ``HEAD_DIMS``, chunks up to
  ``BWD_MAX_CHUNK``, else ``ValueError``), without roundings: its plain
  version is ``ref.mlstm_chunkwise_grads``.  (Its ``rounded`` flag makes
  the wgmma forward's bf16 roundings, for a call made directly.)  It
  needs float32 scratch of about 2 B*H*S*P^2/chunk (the carries C~ = [C,
  n] entering and G leaving each chunk, [B*H, S/chunk, P, P+1] each: 269
  MB each at xlstm-1.3b's layer at B=1, chunk 256) and 3 B*H*S*chunk (the
  chunks' score matrices), which the wrapper allocates.

On CPU tensors autograd differentiates the plain version.

The reference's scheduling knobs ``num_warps``/``pipeline`` pick, on CUDA
tensors, one of the route's launches (:func:`resolve_tiles`; the sets
are :func:`supported_tiles`) or raise ``ValueError`` naming the set;
``None`` is the route's default.  On the wgmma route ``pipeline`` is the
state pass's ring depth (1 to 4; 3) and ``num_warps`` the output pass's
consumer warps (4 or 8: one or two warpgroups; 8 up to chunk 256, 4
above, where two fit in shared memory).  On the FMA route ``num_warps``
is the sequential pass's threads (4 or 8 warps; 8), and ``pipeline``
takes only 1: that kernel stages one tile at a time.  ``chunk`` is the
third knob.  On CPU tensors the plain version takes any positive knob.
:func:`autotune_space` and :func:`autotune_bench` are the reference's
autotune hooks.
``launches`` counts forward kernel launches (one per call, whatever the
passes), ``launches_wgmma`` and ``launches_fma`` those of each route,
``launches_bwd`` the backward's (one per call, ``BWD_KERNELS[route]``
kernels), ``launches_bwd_wgmma`` and ``launches_bwd_fma`` those of each
route.

The libraries are built with ``nvcc`` into ``build/mlstm_chunk/`` at
first use (``kernels/build.py``).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import check_positive
from repro_torch.kernels.build import NvccLibrary
from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunkwise
from repro_torch.kernels.tma import check_tma, tma_strides

CSRC = Path(__file__).resolve().parent / "csrc"
WGMMA_SOURCE = CSRC / "mlstm_chunk_wgmma.cu"
FMA_SOURCE = CSRC / "mlstm_chunk.cu"
BWD_SOURCE = CSRC / "mlstm_chunk_bwd.cu"
BWD_WGMMA_SOURCE = CSRC / "mlstm_chunk_bwd_wgmma.cu"
_LIBS = {
    "wgmma": NvccLibrary("mlstm_chunk", WGMMA_SOURCE, {
        "mlstm_chunk_wgmma_launch": [ctypes.c_void_p] * 10
        + [ctypes.c_int] * 5 + [ctypes.c_void_p] + [ctypes.c_int] * 2
        + [ctypes.c_void_p]}),
    "fma": NvccLibrary("mlstm_chunk", FMA_SOURCE, {
        "mlstm_chunk_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]}),
    "bwd": NvccLibrary("mlstm_chunk", BWD_SOURCE, {
        "mlstm_chunk_bwd_launch": [ctypes.c_void_p] * 21
        + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_void_p]}),
    "bwd_wgmma": NvccLibrary("mlstm_chunk", BWD_WGMMA_SOURCE, {
        "mlstm_chunk_bwd_wgmma_launch": [ctypes.c_void_p] * 13
        + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2,
        "mlstm_chunk_bwd_wgmma_workspace": [ctypes.c_int] * 5
        + [ctypes.c_void_p]}),
}
HEAD_DIMS = (16, 32, 64, 128, 256, 512, 1024)   # compiled into the FMA kernel
WGMMA_HEAD_DIMS = (64, 128, 256, 512, 1024)     # and into the wgmma kernel
WGMMA_CHUNKS = (128, 256, 512, 1024)
MAX_CHUNK = 2048                # the mlstm_chunk knob's upper end
BWD_MAX_CHUNK = 1024            # the backward kernel's largest chunk
# kernels of one backward launch by route (the wgmma route's at two or
# more chunks; 11 at one chunk, which has no carry)
BWD_KERNELS = {"wgmma": 13, "fma": 10}
_BWD_ROWS = 8                   # csrc: kRowArrays
_TILE = 64                      # csrc: kTile
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID = 65535               # grid.y / grid.z limit
_SMEM_LIMIT = 232448            # a block's shared memory on sm_90
WARPS = (8, 4)                  # num_warps of either route, default first
STATE_STAGES = (1, 2, 3, 4)     # the wgmma state pass's ring depths

launches = 0
launches_wgmma = 0
launches_fma = 0
launches_bwd = 0
launches_bwd_wgmma = 0
launches_bwd_fma = 0
_lock = threading.Lock()


def reset_launch_counts() -> None:
    global launches, launches_wgmma, launches_fma, launches_bwd, \
        launches_bwd_wgmma, launches_bwd_fma
    with _lock:
        launches = launches_wgmma = launches_fma = launches_bwd = 0
        launches_bwd_wgmma = launches_bwd_fma = 0


def route(dtype: torch.dtype, head_dim: int, chunk: int) -> str:
    """The kernel a CUDA call runs, from the dtype, P and the chunk in use
    (``min(chunk, S)``): ``"wgmma"`` for bf16 with P in
    ``WGMMA_HEAD_DIMS`` and a chunk in ``WGMMA_CHUNKS``, ``"fma"``
    otherwise."""
    if (dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS
            and chunk in WGMMA_CHUNKS):
        return "wgmma"
    return "fma"


def plain_version(q, k, v, logi, logf, chunk: int):
    """The plain-torch version of the kernel ``route`` picks: on the wgmma
    route (q k^T) o W, k o wk and the carried state are rounded to bf16
    before their products, as the kernel does."""
    c = min(chunk, q.shape[1])
    wgmma = route(q.dtype, q.shape[3], c) == "wgmma"
    return mlstm_chunkwise(q, k, v, logi, logf, c,
                           operand_dtype=torch.bfloat16 if wgmma else None)


def _out_tile(P: int, chunk: int, wg: int) -> int:
    """The wgmma output pass's column tile (csrc: out_tile)."""
    return 64 if P == 64 else (256 if wg == 2 and P >= 256
                               and chunk <= 256 else 128)


def _out_stages(P: int, chunk: int, wg: int) -> int:
    """The ring stages of the wgmma output pass's shared memory (csrc:
    OutLayout); it launches with two or more."""
    q_stage = wg * 8192
    b_stage = max(_out_tile(P, chunk, wg) // 64, 2) * 8192
    fixed = chunk * 64 * wg * 2 + (2 * chunk + 2 * 64 * wg + 1024) * 4 + 64
    return min((_SMEM_LIMIT - 1024 - fixed) // (q_stage + b_stage), 4)


def default_tiles(which: str, chunk: int) -> tuple:
    """(num_warps, pipeline) of the route's default launch at ``chunk``."""
    if which == "wgmma":
        return (8 if chunk <= 256 else 4), 3
    return 8, 1


@functools.lru_cache(maxsize=None)
def supported_tiles(which: str, head_dim: int, chunk: int) -> tuple:
    """Every (num_warps, pipeline) the card's kernel of route ``which``
    has at this P and chunk, the default first.  A pure function: no
    device is touched."""
    if which == "fma":
        return tuple((nw, 1) for nw in WARPS)
    if which != "wgmma":
        raise ValueError(f"unknown route {which!r}")
    out = [default_tiles("wgmma", chunk)]
    out += [(nw, st) for nw in WARPS for st in STATE_STAGES
            if _out_stages(head_dim, chunk, nw // 4) >= 2
            and (nw, st) not in out]
    return tuple(out)



@functools.lru_cache(maxsize=4096)
def resolve_tiles(which: str, head_dim: int, chunk: int, num_warps=None,
                  pipeline=None) -> tuple:
    """The (num_warps, pipeline) a CUDA call of route ``which`` launches
    at ``chunk``: the default for a knob left ``None``; a pair outside
    :func:`supported_tiles` raises ``ValueError`` naming the set."""
    check_positive("mlstm_chunk", num_warps=num_warps, pipeline=pipeline)
    dnw, dst = default_tiles(which, chunk)
    got = (dnw if num_warps is None else int(num_warps),
           dst if pipeline is None else int(pipeline))
    tiles = supported_tiles(which, head_dim, chunk)
    if got not in tiles:
        raise ValueError(
            f"mlstm_chunk ({which}, P {head_dim}, chunk {chunk}): no launch "
            f"for num_warps={got[0]}, pipeline={got[1]}; (num_warps, "
            f"pipeline) in {tiles}")
    return got


def build(verbose: bool = False, which: Optional[str] = None):
    """Compile the kernel libraries (``which``: ``"wgmma"``, ``"fma"``,
    ``"bwd"`` or ``"bwd_wgmma"`` only) if these sources have not been built yet; returns the
    paths (``verbose`` prints ptxas's report)."""
    names = [which] if which is not None else list(_LIBS)
    return [_LIBS[n].build(verbose) for n in names]


def load() -> None:
    """Load every library (built first if needed)."""
    for lib in _LIBS.values():
        lib.load()


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
                num_warps: Optional[int] = None,
                pipeline: Optional[int] = None):
    """q/k/v [B,S,H,P], logi/logf [B,S,H] float32 -> h [B,S,H,P] (q.dtype).

    The chunk is ``min(chunk, S)`` and must divide S, as the reference
    asserts.  ``num_warps``/``pipeline``: the launch of a CUDA call
    (module docstring); ``None`` each, the route's default.
    """
    _check(q, k, v, logi, logf, chunk)
    B, S, H, P = q.shape
    c = min(chunk, S)
    if S and S % c:
        raise ValueError(f"chunk {c} must divide the sequence length {S}")
    if q.device.type == "cpu":
        check_positive("mlstm_chunk", num_warps=num_warps, pipeline=pipeline)
        return plain_version(q, k, v, logi, logf, c)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_chunk runs on cpu or cuda, not {q.device}")
    which = route(q.dtype, P, c)
    tiles = resolve_tiles(which, P, c, num_warps, pipeline)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, logi, logf)):
        if c > BWD_MAX_CHUNK:
            raise ValueError(
                f"mlstm_chunk: the backward kernel takes chunks 1 to "
                f"{BWD_MAX_CHUNK} that divide S; a call that asks for a "
                f"gradient at chunk {c} is refused")
        return _MlstmChunk.apply(q, k, v, logi, logf, c, which, tiles)
    return _forward(q, k, v, logi, logf, c, which, tiles)


def _forward(q, k, v, logi, logf, c, which, tiles):
    launch = _wgmma if which == "wgmma" else _fma
    return launch(q, k, v, logi, logf, c, tiles=tiles)


class _MlstmChunk(torch.autograd.Function):
    """The routed forward launch, differentiated by the same route's
    backward (``_backward_wgmma`` or ``_backward``)."""

    @staticmethod
    def forward(ctx, q, k, v, logi, logf, c, which, tiles):
        out = _forward(q, k, v, logi, logf, c, which, tiles)
        ctx.save_for_backward(q, k, v, logi, logf, out)
        ctx.chunk, ctx.which = c, which
        return out

    @staticmethod
    def backward(ctx, dh):
        q, k, v, logi, logf, out = ctx.saved_tensors
        if ctx.which == "wgmma":
            grads = _backward_wgmma(q, k, v, logi, logf, out, dh, ctx.chunk)
        else:
            grads = _backward(q, k, v, logi, logf, out, dh, ctx.chunk, False)
        return (*grads, None, None, None)


def _count(which: str) -> None:
    global launches, launches_wgmma, launches_fma, launches_bwd, \
        launches_bwd_wgmma, launches_bwd_fma
    with _lock:
        if which in ("bwd_wgmma", "bwd_fma"):
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


def _gate_strides(logi, logf):
    return [*logi.stride(), *logf.stride()]


def _wgmma(q, k, v, logi, logf, c, library: Optional[NvccLibrary] = None,
           tiles: Optional[tuple] = None):
    """The wgmma route's launch at ``tiles`` = (num_warps, pipeline) (the
    default launch at None); ``library`` is one built from a variant of
    ``WGMMA_SOURCE`` with the same entry point (the route's own by
    default)."""
    B, S, H, P = q.shape
    nw, stages = default_tiles("wgmma", c) if tiles is None else tiles
    check_tma(q, k, v)
    n, bh = S // c, B * H
    if max(n, bh) > _MAX_GRID:
        raise ValueError(f"S / chunk = {n} or B*H = {bh} exceeds the "
                         f"kernel's grid ({_MAX_GRID})")
    out = torch.empty((B, S, H, P), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    f32 = dict(dtype=torch.float32, device=q.device)
    slabs = max(n - 1, 1)
    gates = torch.empty((bh, 5, S), **f32)
    chunks = torch.empty((bh, 3, n), **f32)
    n_states = torch.empty((bh, slabs, P), **f32)
    states = torch.empty((bh, slabs, P, P), dtype=torch.bfloat16,
                         device=q.device)
    strides = (ctypes.c_longlong * 18)(
        *tma_strides(q), *tma_strides(k), *tma_strides(v),
        *_gate_strides(logi, logf), *out.stride()[:3])
    lib = (_LIBS["wgmma"] if library is None else library).load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mlstm_chunk_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), logi.data_ptr(),
            logf.data_ptr(), out.data_ptr(), gates.data_ptr(),
            chunks.data_ptr(), n_states.data_ptr(), states.data_ptr(),
            B, S, H, P, c, strides, stages, nw // 4, stream)
    if err < 0:
        raise RuntimeError(f"mlstm_chunk (wgmma): TMA tensor map encoding "
                           f"failed (CUresult {-err})")
    if err != 0:
        raise RuntimeError(f"mlstm_chunk (wgmma) kernel launch failed: "
                           f"CUDA error {err}")
    _count("wgmma")
    return out


def _fma(q, k, v, logi, logf, c, tiles: Optional[tuple] = None):
    B, S, H, P = q.shape
    nw = default_tiles("fma", c)[0] if tiles is None else tiles[0]
    if c > MAX_CHUNK:
        raise ValueError(f"chunk {c} exceeds the kernel's {MAX_CHUNK}")
    if B * H > _MAX_GRID:
        raise ValueError(f"B*H = {B * H} exceeds the kernel's grid "
                         f"({_MAX_GRID})")
    out = torch.empty((B, S, H, P), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    qk = torch.empty((B * H, S, c), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 18)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *_gate_strides(logi, logf), *out.stride()[:3])
    lib = _LIBS["fma"].load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mlstm_chunk_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), logi.data_ptr(),
            logf.data_ptr(), out.data_ptr(), qk.data_ptr(), _DTYPES[q.dtype],
            B, S, H, P, c, strides, nw, stream)
    if err != 0:
        raise RuntimeError(f"mlstm_chunk (fma) kernel launch failed: CUDA "
                           f"error {err}")
    _count("fma")
    return out


def _backward(q, k, v, logi, logf, h, dh, c, rounded: bool):
    """(dq, dk, dv, dlogi, dlogf) from one launch of the backward kernel
    (module docstring): q, k, v, the gates and the forward's output ``h``
    read in place, the cotangent ``dh`` copied to a contiguous tensor only
    if it has no unit stride along P or is broadcast; ``rounded``: the
    wgmma route's roundings."""
    B, S, H, P = q.shape
    if B * H > _MAX_GRID:
        raise ValueError(f"B*H = {B * H} exceeds the kernel's grid "
                         f"({_MAX_GRID})")
    if dh.stride(-1) != 1 or 0 in dh.stride():
        dh = dh.contiguous()
    dq, dk, dv = (torch.empty((B, S, H, P), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    f32 = dict(dtype=torch.float32, device=q.device)
    dli, dlf = (torch.empty((B, S, H), **f32) for _ in range(2))
    if dq.numel() == 0:
        return dq, dk, dv, dli.zero_(), dlf.zero_()
    n, bh = S // c, B * H
    npt, nct = -(-P // _TILE), -(-(P + 1) // _TILE)
    rows = torch.empty((bh, _BWD_ROWS, S), **f32)
    chunks = torch.empty((bh, 3, n), **f32)
    states = torch.empty((bh, n, P, P + 1), **f32)
    grads = torch.empty((bh, n, P, P + 1), **f32)
    sc, dsc, ec = (torch.empty((bh, S, c), **f32) for _ in range(3))
    part = torch.empty((bh, 2, npt, S), **f32)
    dpart = torch.empty((bh, n, npt * nct), **f32)
    strides = (ctypes.c_longlong * 21)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *h.stride()[:3],
        *dh.stride()[:3], *_gate_strides(logi, logf))
    lib = _LIBS["bwd"].load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mlstm_chunk_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), h.data_ptr(),
            dh.data_ptr(), logi.data_ptr(), logf.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dli.data_ptr(), dlf.data_ptr(),
            rows.data_ptr(), chunks.data_ptr(), states.data_ptr(),
            grads.data_ptr(), sc.data_ptr(), dsc.data_ptr(), ec.data_ptr(),
            part.data_ptr(), dpart.data_ptr(), _DTYPES[q.dtype], B, S, H, P,
            c, strides, int(rounded), stream)
    if err != 0:
        raise RuntimeError(f"mlstm_chunk backward kernel launch failed: "
                           f"CUDA error {err}")
    _count("bwd_fma")
    return dq, dk, dv, dli, dlf


def wgmma_workspace_bytes(B: int, S: int, H: int, P: int, c: int,
                          library: Optional[NvccLibrary] = None) -> int:
    """Bytes of the wgmma backward's workspace at this shape (the
    library's own count; builds and loads it)."""
    size = ctypes.c_longlong(0)
    lib = (_LIBS["bwd_wgmma"] if library is None else library).load()
    err = lib.mlstm_chunk_bwd_wgmma_workspace(B, S, H, P, c,
                                              ctypes.byref(size))
    if err != 0:
        raise ValueError(f"mlstm_chunk backward (wgmma): no launch for "
                         f"[B, S, H, P] = {[B, S, H, P]}, chunk {c}")
    return size.value


def _backward_wgmma(q, k, v, logi, logf, h, dh, c,
                    library: Optional[NvccLibrary] = None):
    """(dq, dk, dv, dlogi, dlogf) from one launch of the wgmma backward
    (module docstring): q, k, v (TMA) and the gates read in place, the
    forward's output ``h`` and the cotangent ``dh`` too unless their rows
    are not 16-byte aligned runs (then copied to contiguous tensors; dh
    also when broadcast).  ``library``: one built from a variant of
    ``BWD_WGMMA_SOURCE`` with the same entry points (the route's own by
    default)."""
    B, S, H, P = q.shape
    if route(q.dtype, P, c) != "wgmma" or q.dtype != dh.dtype:
        raise ValueError(f"mlstm_chunk backward (wgmma) takes bf16 at P in "
                         f"{WGMMA_HEAD_DIMS} and chunks in {WGMMA_CHUNKS}; "
                         f"got {q.dtype} (dh {dh.dtype}), P {P}, chunk {c}")
    check_tma(q, k, v)

    def aligned_rows(t):                 # TMA and 16-byte loads read rows
        return not (0 in t.stride() or t.stride(-1) != 1
                    or t.data_ptr() % 16
                    or any(t.shape[d] > 1 and t.stride(d) % 8
                           for d in range(3)))
    h, dh = (t if aligned_rows(t) else t.contiguous() for t in (h, dh))
    dq, dk, dv = (torch.empty((B, S, H, P), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    f32 = dict(dtype=torch.float32, device=q.device)
    dli, dlf = (torch.empty((B, S, H), **f32) for _ in range(2))
    if dq.numel() == 0:
        return dq, dk, dv, dli.zero_(), dlf.zero_()
    lib = (_LIBS["bwd_wgmma"] if library is None else library).load()
    work = torch.empty(wgmma_workspace_bytes(B, S, H, P, c, library) + 1024,
                       dtype=torch.uint8, device=q.device)
    skew = (-work.data_ptr()) % 1024         # the pieces 1024-byte aligned
    strides = (ctypes.c_longlong * 21)(
        *tma_strides(q), *tma_strides(k), *tma_strides(v), *h.stride()[:3],
        *tma_strides(dh), *_gate_strides(logi, logf))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mlstm_chunk_bwd_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), h.data_ptr(),
            dh.data_ptr(), logi.data_ptr(), logf.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dli.data_ptr(), dlf.data_ptr(),
            work.data_ptr() + skew, B, S, H, P, c, strides, stream)
    if err < 0:
        raise RuntimeError(f"mlstm_chunk backward (wgmma): TMA tensor map "
                           f"encoding failed (CUresult {-err})")
    if err != 0:
        raise RuntimeError(f"mlstm_chunk backward (wgmma) kernel launch "
                           f"failed: CUDA error {err}")
    _count("bwd_wgmma")
    return dq, dk, dv, dli, dlf


# ---------------------------------------------------------------------------
# autotune hooks (repro_torch.kernels.autotune)
# ---------------------------------------------------------------------------

def autotune_space():
    """Tunable chunking/scheduling space of the mLSTM forward (the
    reference's: knobs, ladders, ``inert`` flags; no cross-knob
    constraint).  On the card ``num_warps`` and ``pipeline`` are live
    where the route has a counterpart; other points are refused."""
    from repro_torch.core.space import Knob, Space, pow2_knob
    return Space(
        knobs=(
            pow2_knob("chunk", 256, 16, 512,
                      description="sequence chunk width"),
            pow2_knob("num_warps", 4, 1, 8, inert=True,
                      description="GPU warps per block (inert off-GPU)"),
            Knob("pipeline", "int", 2, lo=1, hi=4, inert=True,
                 description="GPU pipeline stages (inert off-GPU)"),
        ),
    )


def autotune_native(S: int = 256, P: int = 32, dtype=torch.float32,
                    chunk: int = 256, **shape) -> dict:
    """The default launch at ``chunk`` (the wrapper's default chunk) of
    the route a bench of this dtype and P takes, as a point of
    :func:`autotune_space`."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    c = min(chunk, S)
    nw, st = default_tiles(route(dtype, P, c), c)
    return {"chunk": chunk, "num_warps": nw, "pipeline": st}


def autotune_bench(B: int = 1, S: int = 256, H: int = 2, P: int = 32,
                   seed: int = 0, dtype=torch.float32, device: str = "cuda"):
    """``build(cfg) -> run()`` factory for ``KernelEvaluator`` (the
    reference's bench and input scales; ``dtype`` bfloat16 reaches the
    wgmma route at P 64-1024 and chunks 128-512).  Inputs from ``seed``,
    made on ``device``; the gates stay float32."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen)
    q = (randn(B, S, H, P) * 0.5).to(dev, dtype)
    k = (randn(B, S, H, P) * 0.5 / P ** 0.5).to(dev, dtype)
    v = (randn(B, S, H, P) * 0.5).to(dev, dtype)
    logi = randn(B, S, H).to(dev)
    logf = (-torch.nn.functional.softplus(-randn(B, S, H) * 2.0)).to(dev)

    def build(cfg):                      # cfg None: the default launch
        kw = {} if cfg is None else dict(
            chunk=int(cfg["chunk"]),
            num_warps=int(cfg.get("num_warps", 0)) or None,
            pipeline=int(cfg.get("pipeline", 0)) or None)

        def run():
            return mlstm_chunk(q, k, v, logi, logf, **kw)
        return run
    return build

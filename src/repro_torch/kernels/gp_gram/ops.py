"""Wrappers of the hand-written CUDA Matérn-5/2 kernels (``csrc/gp_gram.cu``):
the Gram / cross-Gram forward and the Gram's backward in (lengthscale,
signal variance).

The kernels are compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface the first time a CUDA tensor reaches a
wrapper, and loaded with ``ctypes`` (``kernels/build.py``).  The library
lands in ``build/gp_gram/`` at the root of the checkout, named by a hash of
the source, so an edited source is rebuilt and an unchanged one is reused.

A wrapper given CPU tensors returns the plain-torch version (``ref.py``),
with ordinary autograd; given CUDA tensors it launches a kernel on the
current stream or raises.  On CUDA tensors :func:`matern52_gram` is a
``torch.autograd.Function`` whose backward is the backward kernel, so the
GP's marginal-likelihood gradient runs on the card's kernels.

The forward takes the reference's tile knobs (``block``, ``block_m``,
``num_warps``, ``pipeline``): on CUDA tensors each value picks one of the
kernel's instantiations (:func:`resolve_tiles`) or raises ``ValueError``
naming the set; all ``None`` is the default launch.  Every tiling sums
each output in one fixed order, so its bits equal the default launch's.
On CPU tensors the plain version has no tiles and takes any positive
knob, as the reference's interpret mode does.  :func:`autotune_space` and
:func:`autotune_bench` are the reference's autotune hooks.

``gram_launches`` / ``cross_launches`` / ``gram_bwd_launches`` count
kernel launches.  A launch recorded while its stream is being captured
into a CUDA graph is not counted: it is kept per capture stream
(:func:`take_captured_launches`), and whoever replays the graph adds the
launches it holds (:func:`add_launches`).
"""

from __future__ import annotations

import ctypes
import functools
import threading
import types
from collections import Counter
from pathlib import Path

from typing import Optional

import torch

from repro_torch.kernels import check_positive
from repro_torch.kernels.build import NvccLibrary
from repro_torch.kernels.gp_gram import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "gp_gram.cu"
_LIB = NvccLibrary("gp_gram", SOURCE, {
    "matern52_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
    "matern52_gram_bwd_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
    + [ctypes.c_void_p]})
_MAX_GRID_Y = 65535             # grid.y limit: rows / block_n tiles
# the backward's launch (csrc: matern52_gram_bwd_launch): up to
# EXPANDED_MAX_D features and beyond _WIDE_MAX_D one block per _BWD_ROWS
# rows of i; in between the wide kernel, pair tiles of _WIDE_TILE in
# clusters of _WIDE_CLUSTER blocks, at most _WIDE_MAX_CLUSTERS of them
_BWD_ROWS = 64                  # kBwdRows
_WIDE_MAX_D = 512               # kWideMaxD
_WIDE_TILE = (16, 16)           # kWideRows, kWideCols
_WIDE_CLUSTER = 16              # kWideCluster
_WIDE_MAX_CLUSTERS = 16         # kWideMaxClusters

# the forward's instantiations: (block_n, block_m, num_warps), each with a
# cp.async ring of 1 to 4 d chunks (pipeline); the default launch first
TILES = (32, 64, 128)           # block_n and block_m
WARPS = (1, 2, 4, 8)
STAGES = (1, 2, 3, 4)
DEFAULT_TILES = (32, 32, 8, 1)  # (block_n, block_m, num_warps, pipeline)

gram_launches = 0
cross_launches = 0
gram_bwd_launches = 0
_COUNTERS = {"gram": "gram_launches", "cross": "cross_launches",
             "gram_bwd": "gram_bwd_launches"}
_captured: dict = {}            # capture stream -> Counter of launches
_lock = threading.Lock()


def reset_launch_counts() -> None:
    global gram_launches, cross_launches, gram_bwd_launches
    with _lock:
        gram_launches = cross_launches = gram_bwd_launches = 0


def _count(kind: str) -> None:
    """One launch of ``kind`` on the current stream: counted, or kept for
    the graph that stream is capturing."""
    capturing = torch.cuda.is_current_stream_capturing()
    with _lock:
        if capturing:
            key = torch.cuda.current_stream().cuda_stream
            _captured.setdefault(key, Counter())[kind] += 1
        else:
            globals()[_COUNTERS[kind]] += 1


def take_captured_launches(stream: torch.cuda.Stream) -> Counter:
    """The launches recorded while ``stream`` captured a graph (and forget
    them): what one replay of that graph launches."""
    with _lock:
        return _captured.pop(stream.cuda_stream, Counter())


def add_launches(counts: Counter, times: int = 1) -> None:
    """Count ``times`` replays of a graph holding ``counts`` launches."""
    with _lock:
        for kind, k in counts.items():
            globals()[_COUNTERS[kind]] += k * times


def build(verbose: bool = False) -> Path:
    """Compile the kernel library if this source has not been built yet;
    returns its path (``verbose`` prints ptxas's report)."""
    return _LIB.build(verbose)


def _check(xa, xb, lengthscale, signal_var):
    for name, t in (("xa", xa), ("xb", xb), ("lengthscale", lengthscale)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != xa.device:
            raise ValueError(f"{name} is on {t.device}, xa on {xa.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xa.dim() != 2 or xb.dim() != 2 or lengthscale.dim() != 1:
        raise ValueError(f"want xa [n,d], xb [m,d], lengthscale [d]; got "
                         f"{tuple(xa.shape)}, {tuple(xb.shape)}, "
                         f"{tuple(lengthscale.shape)}")
    d = xa.shape[1]
    if xb.shape[1] != d or lengthscale.shape[0] != d:
        raise ValueError(f"feature widths differ: xa {d}, xb {xb.shape[1]},"
                         f" lengthscale {lengthscale.shape[0]}")
    if isinstance(signal_var, torch.Tensor):
        if signal_var.numel() != 1 or signal_var.dtype != torch.float32 \
                or signal_var.device != xa.device:
            raise ValueError("signal_var must be one float32 value on "
                             f"{xa.device}")


def _on_cuda(xa) -> bool:
    if xa.device.type == "cpu":
        return False
    if xa.device.type != "cuda":
        raise ValueError(f"gp_gram runs on cpu or cuda, not {xa.device}")
    return True


def _sv_tensor(signal_var, device) -> torch.Tensor:
    if isinstance(signal_var, torch.Tensor):
        return signal_var.reshape(1).contiguous()
    return torch.full((1,), float(signal_var), dtype=torch.float32,
                      device=device)


@functools.lru_cache(maxsize=None)
def supported_tiles() -> dict:
    """The forward kernel's instantiations, by knob: every combination of
    these values launches (the reference's knob names)."""
    return types.MappingProxyType({"block_n": TILES, "block_m": TILES,
                                   "num_warps": WARPS, "pipeline": STAGES})



@functools.lru_cache(maxsize=4096)
def resolve_tiles(block=None, block_m=None, num_warps=None,
                  pipeline=None) -> tuple:
    """(block_n, block_m, num_warps, pipeline) the card runs for these
    knobs: all ``None`` is the default launch :data:`DEFAULT_TILES`; a
    knob left ``None`` takes the default's value (``block_m``: square
    tiles, as in the reference).  Raises ``ValueError`` naming the set
    for a value the kernel has no instantiation of.  A pure function of
    the knobs (no device is touched)."""
    check_positive("gp_gram", block=block, block_m=block_m,
                   num_warps=num_warps, pipeline=pipeline)
    bn = DEFAULT_TILES[0] if block is None else int(block)
    bm = bn if block_m is None else int(block_m)
    if block is None and block_m is None:
        bm = DEFAULT_TILES[1]
    nw = DEFAULT_TILES[2] if num_warps is None else int(num_warps)
    st = DEFAULT_TILES[3] if pipeline is None else int(pipeline)
    got = {"block_n": bn, "block_m": bm, "num_warps": nw, "pipeline": st}
    bad = [k for k, v in supported_tiles().items() if got[k] not in v]
    if bad:
        raise ValueError(
            f"gp_gram: the card's kernel has no instantiation for "
            f"{', '.join(f'{k}={got[k]}' for k in bad)}; supported: "
            + ", ".join(f"{k} in {v}" for k, v in supported_tiles().items()))
    return bn, bm, nw, st


def bwd_grid(n: int, d: int) -> tuple:
    """(blocks, partial rows) of the backward kernel's launch for x [n, d]:
    the grid the CUDA launcher takes, and the rows of its [rows, d + 1]
    scratch (0: none, one launch; else a second, one-block launch adds
    them in order).  A pure function of the shape (no device is
    touched)."""
    if n <= 0:
        return 0, 0
    if ref.EXPANDED_MAX_D < d <= _WIDE_MAX_D:
        rows, cols = _WIDE_TILE
        tiles = -(-n // rows) * -(-n // cols)
        clusters = min(-(-tiles // _WIDE_CLUSTER), _WIDE_MAX_CLUSTERS)
        return clusters * _WIDE_CLUSTER, clusters if clusters > 1 else 0
    tiles = -(-n // _BWD_ROWS)
    return tiles, tiles if tiles > 1 else 0


def _launch(xa, xb, lengthscale, signal_var, kind: str,
            tiles: tuple = DEFAULT_TILES):
    """The forward kernel on checked CUDA tensors: [n, m]."""
    n, d = xa.shape
    m = xb.shape[0]
    bn, bm, nw, st = tiles
    if -(-n // bn) > _MAX_GRID_Y:
        raise ValueError(f"{n} rows exceed the kernel's grid "
                         f"({_MAX_GRID_Y * bn} at block_n {bn})")
    out = torch.empty((n, m), dtype=torch.float32, device=xa.device)
    if n == 0 or m == 0:
        return out
    sv = _sv_tensor(signal_var, xa.device)
    lib = _LIB.load()
    with torch.cuda.device(xa.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.matern52_launch(
            xa.data_ptr(), xb.data_ptr(), lengthscale.data_ptr(),
            sv.data_ptr(), out.data_ptr(), n, m, d, bn, bm, nw, st, stream)
        if err != 0:
            raise RuntimeError(f"gp_gram kernel launch failed: CUDA error "
                               f"{err}")
        _count(kind)
    return out


def _launch_bwd(x, lengthscale, signal_var, g):
    """The backward kernel on checked CUDA tensors: a [d + 1] tensor of
    (dL/dlengthscale, dL/dsignal_var)."""
    n, d = x.shape
    out = torch.empty((d + 1,), dtype=torch.float32, device=x.device)
    if n == 0:
        return out.zero_()
    rows = bwd_grid(n, d)[1]
    partial = (torch.empty((rows, d + 1), dtype=torch.float32,
                           device=x.device) if rows else None)
    sv = _sv_tensor(signal_var, x.device)
    lib = _LIB.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.matern52_gram_bwd_launch(
            x.data_ptr(), lengthscale.data_ptr(), sv.data_ptr(),
            g.data_ptr(), None if partial is None else partial.data_ptr(),
            out.data_ptr(), n, d, stream)
        if err != 0:
            raise RuntimeError(f"gp_gram backward kernel launch failed: "
                               f"CUDA error {err}")
        _count("gram_bwd")
    return out


class _Gram(torch.autograd.Function):
    """The Gram on the forward kernel, differentiated by the backward
    kernel in (lengthscale, signal_var); x gets no gradient."""

    @staticmethod
    def forward(ctx, x, lengthscale, signal_var, tiles=DEFAULT_TILES):
        ctx.sv_is_tensor = isinstance(signal_var, torch.Tensor)
        ctx.sv_shape = signal_var.shape if ctx.sv_is_tensor else None
        sv = _sv_tensor(signal_var, x.device)
        ctx.save_for_backward(x, lengthscale, sv)
        return _launch(x, x, lengthscale, sv, "gram", tiles)

    @staticmethod
    def backward(ctx, grad):
        x, lengthscale, sv = ctx.saved_tensors
        out = _launch_bwd(x, lengthscale, sv, grad.contiguous())
        d = x.shape[1]
        dsv = out[d:].reshape(ctx.sv_shape) if ctx.sv_is_tensor else None
        return None, out[:d], dsv, None


def matern52_gram(x, lengthscale, signal_var, *, block: Optional[int] = None,
                  block_m: Optional[int] = None,
                  num_warps: Optional[int] = None,
                  pipeline: Optional[int] = None):
    """x [n, d] -> Matérn-5/2 Gram [n, n] (f32); ARD lengthscale [d].
    Differentiable in ``lengthscale`` and ``signal_var``; on CUDA tensors
    through the backward kernel, which gives ``x`` no gradient (a CUDA
    ``x`` that requires one raises).  ``block``/``block_m``/
    ``num_warps``/``pipeline``: the forward's tile (module docstring);
    the output does not depend on them."""
    _check(x, x, lengthscale, signal_var)
    if not _on_cuda(x):
        check_positive("gp_gram", block=block, block_m=block_m,
                       num_warps=num_warps, pipeline=pipeline)
        return ref.matern52(x, x, lengthscale, signal_var)
    tiles = resolve_tiles(block, block_m, num_warps, pipeline)
    if x.requires_grad:
        raise ValueError("matern52_gram on CUDA differentiates in "
                         "lengthscale and signal_var only: x must not "
                         "require grad")
    if torch.is_grad_enabled() and (
            lengthscale.requires_grad or (isinstance(signal_var, torch.Tensor)
                                          and signal_var.requires_grad)):
        return _Gram.apply(x, lengthscale, signal_var, tiles)
    return _launch(x, x, lengthscale, signal_var, "gram", tiles)


def matern52_cross(xa, xb, lengthscale, signal_var, *,
                   block: Optional[int] = None,
                   block_m: Optional[int] = None,
                   num_warps: Optional[int] = None,
                   pipeline: Optional[int] = None):
    """Cross-Gram [n, m] of xa [n, d] against xb [m, d]; ``block`` tiles
    the xa rows, ``block_m`` the xb rows (the same knobs as
    :func:`matern52_gram`)."""
    _check(xa, xb, lengthscale, signal_var)
    if not _on_cuda(xa):
        check_positive("gp_gram", block=block, block_m=block_m,
                       num_warps=num_warps, pipeline=pipeline)
        return ref.matern52(xa, xb, lengthscale, signal_var)
    tiles = resolve_tiles(block, block_m, num_warps, pipeline)
    return _launch(xa, xb, lengthscale, signal_var, "cross", tiles)


def matern52_gram_bwd(x, lengthscale, signal_var, g):
    """(dL/dlengthscale [d], dL/dsignal_var []) of L = sum_ij g_ij K_ij,
    K = ``matern52_gram(x, lengthscale, signal_var)``, g [n, n] (not
    assumed symmetric); the backward kernel on CUDA tensors."""
    _check(x, x, lengthscale, signal_var)
    if not isinstance(g, torch.Tensor) or g.dtype != torch.float32 \
            or g.device != x.device or not g.is_contiguous() \
            or tuple(g.shape) != (x.shape[0],) * 2:
        raise ValueError(f"g must be a contiguous float32 [n, n] tensor on "
                         f"{x.device}")
    if not _on_cuda(x):
        return ref.matern52_gram_bwd(x, lengthscale, signal_var, g)
    out = _launch_bwd(x, lengthscale, signal_var, g)
    d = x.shape[1]
    return out[:d], out[d]


# ---------------------------------------------------------------------------
# autotune hooks (repro_torch.kernels.autotune)
# ---------------------------------------------------------------------------

def autotune_space():
    """The gram kernel's tunable tiling/scheduling space (the reference's:
    knobs, ladders, ``inert`` flags and the tile budget).  On the card
    ``num_warps`` and ``pipeline`` are live, as on the reference's GPU
    lowering; a point outside :func:`supported_tiles` is refused."""
    from repro_torch.core.space import Knob, ProductLeq, Space, pow2_knob
    return Space(
        knobs=(
            pow2_knob("block_n", 128, 8, 512,
                      description="output row tile"),
            pow2_knob("block_m", 128, 8, 512,
                      description="output column tile"),
            pow2_knob("num_warps", 4, 1, 8, inert=True,
                      description="GPU warps per block (inert off-GPU)"),
            Knob("pipeline", "int", 2, lo=1, hi=4, inert=True,
                 description="GPU pipeline stages (inert off-GPU)"),
        ),
        # the reference's VMEM/SMEM budget: the [bn, bm] output tile
        constraints=(ProductLeq(("block_n", "block_m"), limit=256 * 256),),
    )


def autotune_native(**shape) -> dict:
    """The default launch's tiles as a point of :func:`autotune_space`."""
    return dict(zip(("block_n", "block_m", "num_warps", "pipeline"),
                    DEFAULT_TILES))


def autotune_bench(n: int = 136, d: int = 8, seed: int = 0,
                   m: Optional[int] = None, device: str = "cuda"):
    """``build(cfg) -> run()`` factory for ``KernelEvaluator``: the Gram
    of x [n, d] (the reference's bench; n = 136 is off the tile ladder),
    or with ``m`` the cross-Gram of x against xb [m, d] (the candidate
    pool's shape).  Inputs from ``seed``, made on ``device``."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((n, d), generator=gen).to(dev)
    xb = None if m is None else torch.rand((m, d), generator=gen).to(dev)
    ls = torch.full((d,), 0.3, dtype=torch.float32, device=dev)

    def build(cfg):                      # cfg None: the default launch
        kw = {} if cfg is None else dict(
            block=int(cfg["block_n"]), block_m=int(cfg["block_m"]),
            num_warps=int(cfg.get("num_warps", 0)) or None,
            pipeline=int(cfg.get("pipeline", 0)) or None)

        def run():
            if xb is None:
                return matern52_gram(x, ls, 1.0, **kw)
            return matern52_cross(x, xb, ls, 1.0, **kw)
        return run
    return build

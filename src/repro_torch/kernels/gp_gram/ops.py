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

``gram_launches`` / ``cross_launches`` / ``gram_bwd_launches`` count
kernel launches.  A launch recorded while its stream is being captured
into a CUDA graph is not counted: it is kept per capture stream
(:func:`take_captured_launches`), and whoever replays the graph adds the
launches it holds (:func:`add_launches`).
"""

from __future__ import annotations

import ctypes
import threading
from collections import Counter
from pathlib import Path

import torch

from repro_torch.kernels.build import NvccLibrary
from repro_torch.kernels.gp_gram import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "gp_gram.cu"
_LIB = NvccLibrary("gp_gram", SOURCE, {
    "matern52_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    "matern52_gram_bwd_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
    + [ctypes.c_void_p]})
_MAX_ROWS = 65535 * 32          # grid.y limit times the 32-row tile
_BWD_ROWS = 64                  # rows of i per block of the backward kernel

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


def _launch(xa, xb, lengthscale, signal_var, kind: str):
    """The forward kernel on checked CUDA tensors: [n, m]."""
    n, d = xa.shape
    m = xb.shape[0]
    if n > _MAX_ROWS:
        raise ValueError(f"{n} rows exceed the kernel's grid ({_MAX_ROWS})")
    out = torch.empty((n, m), dtype=torch.float32, device=xa.device)
    if n == 0 or m == 0:
        return out
    sv = _sv_tensor(signal_var, xa.device)
    lib = _LIB.load()
    with torch.cuda.device(xa.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.matern52_launch(
            xa.data_ptr(), xb.data_ptr(), lengthscale.data_ptr(),
            sv.data_ptr(), out.data_ptr(), n, m, d, stream)
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
    tiles = (n + _BWD_ROWS - 1) // _BWD_ROWS
    partial = (torch.empty((tiles, d + 1), dtype=torch.float32,
                           device=x.device) if tiles > 1 else None)
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
    def forward(ctx, x, lengthscale, signal_var):
        ctx.sv_is_tensor = isinstance(signal_var, torch.Tensor)
        ctx.sv_shape = signal_var.shape if ctx.sv_is_tensor else None
        sv = _sv_tensor(signal_var, x.device)
        ctx.save_for_backward(x, lengthscale, sv)
        return _launch(x, x, lengthscale, sv, "gram")

    @staticmethod
    def backward(ctx, grad):
        x, lengthscale, sv = ctx.saved_tensors
        out = _launch_bwd(x, lengthscale, sv, grad.contiguous())
        d = x.shape[1]
        dsv = out[d:].reshape(ctx.sv_shape) if ctx.sv_is_tensor else None
        return None, out[:d], dsv


def matern52_gram(x, lengthscale, signal_var):
    """x [n, d] -> Matérn-5/2 Gram [n, n] (f32); ARD lengthscale [d].
    Differentiable in ``lengthscale`` and ``signal_var``; on CUDA tensors
    through the backward kernel, which gives ``x`` no gradient (a CUDA
    ``x`` that requires one raises)."""
    _check(x, x, lengthscale, signal_var)
    if not _on_cuda(x):
        return ref.matern52(x, x, lengthscale, signal_var)
    if x.requires_grad:
        raise ValueError("matern52_gram on CUDA differentiates in "
                         "lengthscale and signal_var only: x must not "
                         "require grad")
    if torch.is_grad_enabled() and (
            lengthscale.requires_grad or (isinstance(signal_var, torch.Tensor)
                                          and signal_var.requires_grad)):
        return _Gram.apply(x, lengthscale, signal_var)
    return _launch(x, x, lengthscale, signal_var, "gram")


def matern52_cross(xa, xb, lengthscale, signal_var):
    """Cross-Gram [n, m] of xa [n, d] against xb [m, d]."""
    _check(xa, xb, lengthscale, signal_var)
    if not _on_cuda(xa):
        return ref.matern52(xa, xb, lengthscale, signal_var)
    return _launch(xa, xb, lengthscale, signal_var, "cross")


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

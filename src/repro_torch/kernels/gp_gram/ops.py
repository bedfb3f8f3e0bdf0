"""Wrappers of the hand-written CUDA Matérn-5/2 kernel (``csrc/gp_gram.cu``).

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface the first time a CUDA tensor reaches a wrapper,
and loaded with ``ctypes`` (``kernels/build.py``).  The library lands in
``build/gp_gram/`` at the root of the checkout, named by a hash of the
source, so an edited source is rebuilt and an unchanged one is reused.

A wrapper given CPU tensors returns the plain-torch version (``ref.py``);
given CUDA tensors it launches the kernel on the current stream or
raises.  ``gram_launches`` / ``cross_launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels.build import NvccLibrary
from repro_torch.kernels.gp_gram.ref import matern52

SOURCE = Path(__file__).resolve().parent / "csrc" / "gp_gram.cu"
_LIB = NvccLibrary("gp_gram", SOURCE, {
    "matern52_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    + [ctypes.c_void_p]})
_MAX_ROWS = 65535 * 32          # grid.y limit times the 32-row tile

gram_launches = 0
cross_launches = 0
_lock = threading.Lock()


def reset_launch_counts() -> None:
    global gram_launches, cross_launches
    with _lock:
        gram_launches = cross_launches = 0


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


def _matern52(xa, xb, lengthscale, signal_var, kind: str):
    global gram_launches, cross_launches
    _check(xa, xb, lengthscale, signal_var)
    if xa.device.type == "cpu":
        return matern52(xa, xb, lengthscale, signal_var)
    if xa.device.type != "cuda":
        raise ValueError(f"gp_gram runs on cpu or cuda, not {xa.device}")
    n, d = xa.shape
    m = xb.shape[0]
    if n > _MAX_ROWS:
        raise ValueError(f"{n} rows exceed the kernel's grid ({_MAX_ROWS})")
    out = torch.empty((n, m), dtype=torch.float32, device=xa.device)
    if n == 0 or m == 0:
        return out
    if isinstance(signal_var, torch.Tensor):
        sv = signal_var.reshape(1).contiguous()
    else:
        sv = torch.full((1,), float(signal_var), dtype=torch.float32,
                        device=xa.device)
    lib = _LIB.load()
    with torch.cuda.device(xa.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.matern52_launch(
            xa.data_ptr(), xb.data_ptr(), lengthscale.data_ptr(),
            sv.data_ptr(), out.data_ptr(), n, m, d, stream)
    if err != 0:
        raise RuntimeError(f"gp_gram kernel launch failed: CUDA error {err}")
    with _lock:
        if kind == "gram":
            gram_launches += 1
        else:
            cross_launches += 1
    return out


def matern52_gram(x, lengthscale, signal_var):
    """x [n, d] -> Matérn-5/2 Gram [n, n] (f32); ARD lengthscale [d]."""
    return _matern52(x, x, lengthscale, signal_var, "gram")


def matern52_cross(xa, xb, lengthscale, signal_var):
    """Cross-Gram [n, m] of xa [n, d] against xb [m, d]."""
    return _matern52(xa, xb, lengthscale, signal_var, "cross")

"""Hand-written Hopper kernels of the port, and the autotune dogfood loop.

Each subpackage ships ``csrc/`` (the CUDA source), ``ops.py`` (the
wrapper: checks, build, launch, launch count) and ``ref.py`` (the
plain-torch version the CPU path and the on-card checks use).  Tiling
parameters (tiles, warps, ring depths, chunk widths) are keyword knobs of
the ops wrappers; :mod:`repro_torch.kernels.autotune` turns each wrapper's
``autotune_space()``/``autotune_bench()`` pair into a Sapphire search
problem, so the tuner tunes its own kernels on the card.

The reference's ``tuning_compiler_params`` maps ``num_warps``/
``pipeline`` to Triton's compiler parameters on its GPU lowering.  Here
each wrapper maps its knobs to the launch itself (``resolve_tiles`` of
each ops module): an instantiation of the kernel and its ring depth, or
a ``ValueError`` naming the set the kernel has.
"""

from __future__ import annotations

def check_positive(kernel: str, **knobs) -> None:
    """Raise ``ValueError`` unless every knob is ``None`` or a positive
    int: what a CPU call (the plain version, no tiles) accepts."""
    for name, v in knobs.items():
        if v is not None and (isinstance(v, bool) or int(v) != v
                              or int(v) < 1):
            raise ValueError(f"{kernel}: {name} must be a positive int or "
                             f"None, got {v!r}")


_AUTOTUNE_EXPORTS = ("KernelEvaluator", "kernel_bench", "kernel_space",
                     "tunable_kernels", "tune_kernel")


def __getattr__(name):
    # lazy: autotune imports the ops modules, which import this package
    if name in _AUTOTUNE_EXPORTS:
        from repro_torch.kernels import autotune
        return getattr(autotune, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

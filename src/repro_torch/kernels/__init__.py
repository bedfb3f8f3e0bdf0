"""Hand-written Hopper kernels of the port.

Each subpackage ships ``csrc/`` (the CUDA source), ``ops.py`` (the
wrapper: checks, build, launch, launch count) and ``ref.py`` (the
plain-torch version the CPU path and the on-card checks use).
"""

"""What the tensor-core kernels' TMA loads need of a [B, S, heads, D]
tensor read in place: checked in Python before a launch, so a view TMA
cannot read raises ``ValueError`` instead of faulting on the card."""

from __future__ import annotations


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


def tma_strides(t):
    """t's element strides over (b, s, h); a dim of one element gets the
    stride of a contiguous layout (TMA checks it, never steps along it)."""
    B, S, heads, D = t.shape
    dense = (S * heads * D, heads * D, D)
    return [t.stride(i) if t.shape[i] > 1 else dense[i] for i in range(3)]

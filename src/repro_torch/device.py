"""Device selection for the port's entry points: the card unless the
caller asks for the CPU, and never a silent fallback."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent.  On CUDA, float32 products are pinned to IEEE fp32: TF32 would
    not hold the Gram's |a|²+|b|²−2a·b cancellation near the diagonal."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not "
                "available; pass device='cpu' to run on the host")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: cuda or cpu")
    return dev

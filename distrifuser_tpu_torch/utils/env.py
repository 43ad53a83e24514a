"""Device resolution for the PyTorch port.

Counterpart of distrifuser_tpu/utils/env.py (``default_backend``,
``is_power_of_2``).  The port runs on a CUDA card unless the caller asks for
the CPU by name; finding no card is an error, never a quiet CPU run.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``: None means the first CUDA card.

    Raises when no card is present and the CPU was not asked for.  On a
    CUDA device this also pins the float32 precision flags
    (`set_precision_flags`)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found: the port runs on the card by default; "
                "pass device='cpu' to run the plain CPU path"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is unavailable")
        set_precision_flags()
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    return device


def set_precision_flags() -> None:
    """float32 matmuls and convolutions in full float32, not TF32.

    The JAX reference runs its float32 paths at full precision; cuDNN would
    otherwise run float32 convolutions in TF32 (about three decimal
    digits).  The bf16 main path is unaffected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def is_power_of_2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0

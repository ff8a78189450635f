"""Device selection and float32 precision for the port's entry points."""

from __future__ import annotations

from contextlib import contextmanager

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Asking for CUDA where there is none raises:
    nothing falls back to the CPU unless the caller passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


@contextmanager
def full_f32():
    """True float32 convolutions and matmuls: cuDNN runs f32 convolutions in
    TF32 by default, which keeps about three decimal digits, where the JAX
    reference's parity mode uses precision='highest'."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev

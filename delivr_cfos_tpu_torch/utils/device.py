"""Device selection, host-to-device upload, float32 precision and step
timing for the port's entry points."""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext

import numpy as np
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


def upload(volume: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``. uint16 travels as its int16 bit pattern
    (2 B/voxel; PyTorch's uint16 support is partial) and is widened to int32
    there."""
    volume = np.require(volume, requirements=["C", "W"])  # copies a read-only map
    if volume.dtype == np.uint16:
        t = torch.from_numpy(volume.view(np.int16)).to(device)
        return t.to(torch.int32) & 0xFFFF
    return torch.from_numpy(volume).to(device)


class StepSeconds(dict):
    """Wall seconds by step name. A step ends with a synchronize of its CUDA
    device, so the device work a step queued counts in that step."""

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device)

    @contextmanager
    def step(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self[name] = self.get(name, 0.0) + time.perf_counter() - t0


def timed(timer: StepSeconds | None, name: str):
    """``timer.step(name)``, or nothing where there is no timer."""
    return nullcontext() if timer is None else timer.step(name)

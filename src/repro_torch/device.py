"""Where the port's entry points run: the card, unless the caller asks for the CPU."""
from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card.

    Raises ``RuntimeError`` when the card is asked for (or implied) and
    there is none: the entry points never carry on quietly on the CPU.
    Pass ``device="cpu"`` to run the kernels' plain versions.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the host"
        )
    return dev


@contextlib.contextmanager
def full_f32():
    """Float32 products without TF32 on the card (cuBLAS and cuDNN), restored on exit."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def host_to_device(a, device: torch.device) -> torch.Tensor:
    """A device copy of the host array ``a`` that does not wait for the device.

    On the card the values go through a fresh pinned buffer and a
    non-blocking copy queued on the current stream (PyTorch's pinned
    allocator keeps the buffer until the copy has run), so the caller may
    change ``a`` at once and the host never waits for queued work. On the
    CPU it is a plain copy.
    """
    t = torch.from_numpy(np.array(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)

"""Where the port's entry points run: the card, unless the caller asks for the CPU."""
from __future__ import annotations

import contextlib

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

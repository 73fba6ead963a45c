"""Gradient compression with error feedback: the paper's idea applied per step.

CoNLoCNN compensates quantization error once, at conversion, by balancing
the mean error within a group. A training step that quantizes its
gradients has the same structure over time: the error each step injects
is carried and added back the next step (error feedback), so the mean
injected error tends to zero over the steps. The JAX package's
``repro/optim/compress.py`` with its two codecs, in 256-element blocks:

  * ``int8``: symmetric per-block int8 (scale ``max|x| / 127``);
  * ``elp4``: ELP_BSD FORMAT_A 4-bit per block (16 levels ``+-2^{0..7}``,
    scale ``max|x| / 128``), 8x smaller than float32.

``compressed_mean`` (a ``pmean`` of the dequantized codes over a mesh axis)
waits for the multi-device port (ROADMAP.md, queue 1 item 4).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.elp_bsd import FORMAT_A
from repro_torch.core.quantize import nn_quantize_idx
from repro_torch.kernels.ops import tree_map

F32 = torch.float32

_A4_LEVELS = np.asarray(FORMAT_A.levels(), np.float32)  # +-2^{0..7}, 16 levels
CODECS = ("int8", "elp4")


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    flat = x.reshape(-1)
    return F.pad(flat, (0, (-flat.numel()) % block)).reshape(-1, block)


def _quant_int8(x: torch.Tensor, block: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 codes ``[n_blocks, block]`` and float32 scales ``[n_blocks, 1]``."""
    flat = _blocks(x, block)
    scale = torch.amax(torch.abs(flat), dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_int8(q: torch.Tensor, scale: torch.Tensor, shape, size: int) -> torch.Tensor:
    return (q.to(F32) * scale).reshape(-1)[:size].reshape(shape)


def _quant_elp4(x: torch.Tensor, block: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Level indices (int8, 0..15) ``[n_blocks, block]`` and float32 scales ``[n_blocks, 1]``."""
    flat = _blocks(x, block)
    sf = torch.amax(torch.abs(flat), dim=1, keepdim=True) / 128.0 + 1e-12
    return nn_quantize_idx(flat / sf, _A4_LEVELS).to(torch.int8), sf


def _dequant_elp4(idx: torch.Tensor, sf: torch.Tensor, shape, size: int) -> torch.Tensor:
    levels = torch.as_tensor(_A4_LEVELS, device=idx.device)
    return (levels[idx.long()] * sf).reshape(-1)[:size].reshape(shape)


def quantize_with_feedback(g: torch.Tensor, err: torch.Tensor,
                           codec: str = "int8") -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback quantization of one gradient leaf: ``(g_hat, new error)`` with
    ``x = g + err`` (float32), ``g_hat`` its codec round trip and ``x - g_hat`` carried."""
    x = g.to(F32) + err
    if codec == "int8":
        xq = _dequant_int8(*_quant_int8(x), x.shape, x.numel())
    elif codec == "elp4":
        xq = _dequant_elp4(*_quant_elp4(x), x.shape, x.numel())
    else:
        raise ValueError(f"unknown gradient codec {codec!r} (known: {CODECS})")
    return xq, x - xq


def tree_quantize_with_feedback(grads: Any, err_state: Any,
                                codec: str = "int8") -> tuple[Any, Any]:
    """:func:`quantize_with_feedback` over every leaf: ``(quantized grads, new errors)``."""
    out = tree_map(lambda g, e: quantize_with_feedback(g, e, codec), grads, err_state)
    return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)


def init_error_state(params: Any) -> Any:
    """Zero float32 error buffers shaped as the parameters."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params)


def compressed_mean(x: torch.Tensor, axis_name: str, codec: str = "int8") -> torch.Tensor:
    """The JAX package's quantize-then-``pmean`` over a mesh axis; needs a device mesh."""
    raise NotImplementedError(
        "compressed_mean (a pmean over a device-mesh axis) is not ported to repro_torch yet; "
        "see ROADMAP.md (queue 1 item 4)")


def compression_ratio(codec: str) -> float:
    """Wire-size ratio of the codec against float32."""
    return {"int8": 4.0, "elp4": 8.0}[codec]

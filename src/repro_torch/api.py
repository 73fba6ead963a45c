"""One front door for CNNs: ``QuantScheme`` -> :func:`quantize` -> :class:`QuantizedModel`.

    from repro_torch import api
    from repro_torch.models import cnn

    params = cnn.init_params(cnn.ALEXNET, seed=0)            # on the card
    qm = api.quantize(cnn.ALEXNET, params,
                      api.QuantScheme(fmt="elp_bsd_a4", act="static"),
                      calib_data=images)                    # [n, B, H, W, C]
    logits = qm.forward(batch)   # convs on the tiled kernel, fc on the decode-step kernel

``quantize`` calibrates (observers, percentile clipping, the rho-gated
fold of ``W @ E[eps]`` into biases), then packs (SF -> TQL -> nearest
level -> Algorithm 1 -> ELP_BSD codes, nibble-packed for 4-bit). Entry
points run on the card unless the caller passes ``device="cpu"``; with no
card and no explicit CPU request they raise.

Not ported yet, each raising ``NotImplementedError`` (ROADMAP.md, queue 1):
the Sec. V search (``eval_fn``), ``save``/``load``, LM and speculative
schemes, and ``block_sizes="auto"`` (no autotune cache).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.api_schemes import NOT_PORTED, CnnAdapter, QuantScheme, as_adapter
from repro_torch.calib.policy import CalibrationTable
from repro_torch.core.elp_bsd import resolve_format, storage_bytes
from repro_torch.core.energy import network_energy_nj
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import PackedWeight, packed_tree_bytes

__all__ = ["ConversionReport", "QuantScheme", "QuantizedModel", "quantize", "resolve_format"]


@dataclasses.dataclass(frozen=True)
class ConversionReport:
    """What a conversion did, in numbers.

    ``packed_bytes`` counts runtime storage (one byte per u8 code, two
    nibble codes per byte, float32 scales); ``encoded_bytes`` is the
    paper's Table II accounting with codes bit-packed at
    ``bits_per_weight``; ``energy_nj`` is the Table II network energy.
    """

    fmt: str
    act: str
    act_bits: int | None
    raw_bytes: int
    packed_bytes: int
    packed_weight_bytes: int
    encoded_bytes: int
    energy_nj: float | None = None

    @property
    def compression(self) -> float:
        return self.raw_bytes / max(self.packed_bytes, 1)


def _encoded_bytes(tree: dict) -> int:
    """Bit-packed (Table II) byte accounting for a packed params dict."""
    total = 0
    for leaf in tree.values():
        if isinstance(leaf, PackedWeight):
            k, n = leaf.shape
            total += storage_bytes(k * n, leaf.fmt) + leaf.sf.numel() * 4
        else:
            total += leaf.numel() * leaf.element_size()
    return total


def _to_device(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).to(device)


def quantize(
    model,
    params: dict,
    scheme: QuantScheme | None = None,
    *,
    calib_data: Any = None,
    eval_fn: Callable | None = None,
    device=None,
) -> "QuantizedModel":
    """Run the CoNLoCNN conversion on one CNN: calibrate, fold, pack.

    Args:
      model: a ``CnnSpec``.
      params: the float parameter dict (tensors or numpy arrays).
      scheme: the :class:`QuantScheme` (default: 4-bit ELP_BSD weights,
        Algorithm 1 on, float activations).
      calib_data: stacked calibration images ``[n, B, H, W, C]``, required
        when ``scheme.act == "static"``.
      eval_fn: the Sec. V accuracy-constraint search, not ported yet.
      device: where the conversion and the model run (default: the card).
    """
    adapter = as_adapter(model)
    scheme = scheme if scheme is not None else QuantScheme()
    if eval_fn is not None:
        raise NotImplementedError(f"the Sec. V search (eval_fn, core/methodology.py) is {NOT_PORTED}")
    if scheme.spec_k:
        raise NotImplementedError(f"speculative schemes (the LM serve path) are {NOT_PORTED}")
    if scheme.block_sizes == "auto":
        raise NotImplementedError(f'block_sizes="auto" (the autotune cache) is {NOT_PORTED}')
    device = resolve_device(device)
    work = {k: _to_device(v, device) for k, v in params.items()}
    raw_bytes = packed_tree_bytes(work)

    table: CalibrationTable | None = None
    if scheme.act == "static":
        if calib_data is None:
            raise ValueError('scheme.act == "static" needs calib_data (stacked calibration batches)')
        table, work = adapter.calibrate(work, _to_device(calib_data, device), scheme)
    packed = adapter.pack(work, scheme, table)

    act_bits = scheme.resolved_act_bits()
    encoded_bytes = _encoded_bytes(packed)
    report = ConversionReport(
        fmt=scheme.format.name,
        act=scheme.act,
        act_bits=act_bits,
        raw_bytes=raw_bytes,
        packed_bytes=packed_tree_bytes(packed),
        packed_weight_bytes=packed_tree_bytes(packed, packed_only=True),
        encoded_bytes=encoded_bytes,
        energy_nj=network_energy_nj(
            adapter.spec.macs(), encoded_bytes, scheme.format.name, act_bits or 8
        )["total_nj"],
    )
    return QuantizedModel(packed, adapter, scheme, table=table, report=report)


class QuantizedModel:
    """The artifact of a conversion: packed params plus what serves them."""

    def __init__(
        self,
        params: dict,
        adapter: CnnAdapter,
        scheme: QuantScheme,
        *,
        table: CalibrationTable | None = None,
        report: ConversionReport | None = None,
    ):
        self.params = params
        self.adapter = adapter
        self.scheme = scheme
        self.table = table
        self.report = report

    @property
    def device(self) -> torch.device:
        leaf = next(iter(self.params.values()))
        return (leaf.codes if isinstance(leaf, PackedWeight) else leaf).device

    def to(self, device) -> "QuantizedModel":
        """The same artifact with its tensors on ``device``."""
        device = resolve_device(device)
        params = {k: v.to(device) for k, v in self.params.items()}
        return QuantizedModel(params, self.adapter, self.scheme, table=self.table,
                              report=self.report)

    def forward(self, x, *, impl: str | None = None, block_sizes=None) -> torch.Tensor:
        """Images ``[B, H, W, C]`` -> logits, on the params' device.

        The scheme's activation policy applies: static schemes quantize
        against the calibration table, dynamic ones per tensor at
        ``act_bits``. On the card ``impl="auto"`` (the default) takes the
        tiled kernel for the convs and the decode-step kernel for fc
        layers at batch <= 256; ``"tiled"`` / ``"fused"`` force one.
        """
        calib = act_bits = None
        if self.scheme.act == "static":
            calib = self.table
        elif self.scheme.act == "dynamic":
            act_bits = (self.report.act_bits if self.report else None) or 8
        return self.adapter.forward(
            self.params,
            _to_device(x, self.device),
            calib=calib,
            act_bits=act_bits,
            impl=impl or "auto",
            block_sizes=self.scheme.block_sizes if block_sizes is None else block_sizes,
        )

    def generate(self, *args, **kwargs):
        raise NotImplementedError(f"LM generation is {NOT_PORTED}")

    def serve(self, *args, **kwargs):
        raise NotImplementedError(f"LM serving is {NOT_PORTED}")

    def save(self, path: str) -> None:
        raise NotImplementedError(f"artifact save (checkpoint/manager.py) is {NOT_PORTED}")

    @classmethod
    def load(cls, path: str) -> "QuantizedModel":
        raise NotImplementedError(f"artifact load (checkpoint/manager.py) is {NOT_PORTED}")

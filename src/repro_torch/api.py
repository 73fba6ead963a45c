"""One front door: ``QuantScheme`` -> :func:`quantize` -> :class:`QuantizedModel`.

    from repro_torch import api
    from repro_torch.models import cnn

    params = cnn.init_params(cnn.ALEXNET, seed=0)            # on the card
    qm = api.quantize(cnn.ALEXNET, params,
                      api.QuantScheme(fmt="elp_bsd_a4", act="static"),
                      calib_data=images)                    # [n, B, H, W, C]
    logits = qm.forward(batch)   # convs on the tiled kernel, fc on the decode-step kernel

    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = get_config("qwen3_8b")
    params = transformer.init_params(cfg, seed=0)           # on the card
    qm = api.quantize(cfg, params, api.QuantScheme(fmt="elp4", act="static"),
                      calib_data=token_batches)             # [n, B, S]
    new_tokens = qm.generate(prompts, 16)                   # [B, S] -> [B, 16]

``quantize`` calibrates (observers, percentile clipping; for CNNs the
rho-gated fold of ``W @ E[eps]`` into biases), then packs (SF -> TQL ->
nearest level -> Algorithm 1 -> ELP_BSD codes, nibble-packed for 4-bit;
an LM per stacked layer slice). Entry points run on the card unless the
caller passes ``device="cpu"``; with no card and no explicit CPU request
they raise.

Not ported yet, each raising ``NotImplementedError`` (ROADMAP.md, queue 1):
the Sec. V search (``eval_fn``), ``save``/``load``, speculative schemes,
``serve`` (the continuous-batching engine) and ``block_sizes="auto"`` (no
autotune cache).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.api_schemes import NOT_PORTED, QuantScheme, as_adapter
from repro_torch.calib.policy import CalibrationTable
from repro_torch.core.elp_bsd import resolve_format, storage_bytes
from repro_torch.core.energy import network_energy_nj
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import PackedWeight, packed_tree_bytes, tree_leaves, tree_map

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
    """Bit-packed (Table II) byte accounting for a (nested) packed params dict."""
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, PackedWeight):
            k, n = leaf.shape
            stack = leaf.n_layers or 1
            total += storage_bytes(stack * k * n, leaf.fmt) + leaf.sf.numel() * 4
        else:
            total += leaf.numel() * leaf.element_size()
    return total


def _to_device(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).to(device)


def _tree_to_device(tree, device: torch.device):
    return tree_map(lambda v: v.to(device) if isinstance(v, PackedWeight)
                    else _to_device(v, device), tree)


def quantize(
    model,
    params: dict,
    scheme: QuantScheme | None = None,
    *,
    calib_data: Any = None,
    eval_fn: Callable | None = None,
    device=None,
) -> "QuantizedModel":
    """Run the CoNLoCNN conversion on one model: calibrate, (fold,) pack.

    Args:
      model: a ``CnnSpec`` or a decoder-LM ``ArchConfig``.
      params: the float parameter dict (tensors or numpy arrays; nested
        for an LM).
      scheme: the :class:`QuantScheme` (default: 4-bit ELP_BSD weights,
        Algorithm 1 on, float activations).
      calib_data: stacked calibration batches, required when
        ``scheme.act == "static"``: images ``[n, B, H, W, C]`` for a CNN,
        token ids ``[n, B, S]`` for an LM.
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
    work = _tree_to_device(params, device)
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
        )["total_nj"] if adapter.kind == "cnn" else None,
    )
    return QuantizedModel(packed, adapter, scheme, table=table, report=report)


class QuantizedModel:
    """The artifact of a conversion: packed params plus what serves them."""

    def __init__(
        self,
        params: dict,
        adapter,
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
        leaf = tree_leaves(self.params)[0]
        return (leaf.codes if isinstance(leaf, PackedWeight) else leaf).device

    def to(self, device) -> "QuantizedModel":
        """The same artifact with its tensors on ``device``."""
        device = resolve_device(device)
        return QuantizedModel(_tree_to_device(self.params, device), self.adapter, self.scheme,
                              table=self.table, report=self.report)

    def forward(self, x, *, impl: str | None = None, block_sizes=None) -> torch.Tensor:
        """Images ``[B, H, W, C]`` -> logits (CNN), tokens ``[B, S]`` -> last logits (LM).

        The scheme's activation policy applies: static schemes quantize
        against the calibration table, dynamic ones per tensor at
        ``act_bits``. On the card ``impl="auto"`` (the default) takes the
        tiled kernel for the convs and the decode-step kernel for fc
        layers at batch <= 256; ``"tiled"`` / ``"fused"`` force one. The LM
        path picks its kernels itself, so ``impl``/``block_sizes`` are an
        error there.
        """
        if self.adapter.kind == "lm":
            if impl is not None or block_sizes is not None:
                raise ValueError(
                    "impl/block_sizes are CNN execution overrides; the LM path picks its "
                    "matmul kernel from the row count (models/layers.matmul)"
                )
            return self.adapter.forward(self.params, _to_device(x, self.device))
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

    def generate(self, batch, max_new_tokens: int, *, greedy: bool = True, generator=None,
                 max_len: int | None = None) -> torch.Tensor:
        """LM generation on the packed weights: prompts ``[B, S]`` -> new tokens ``[B, n]``.

        Runs :func:`repro_torch.serve.engine.static_generate`: a whole-batch
        prefill (prefill matmuls on the tiled kernel, attention on the flash
        kernel), then lockstep decode steps (matmuls on the decode-step
        kernel). The JAX package routes greedy keyless calls to its
        continuous-batching ``ServeEngine``, which its own tests hold
        token-identical to ``static_generate``; until the engine is ported
        every call takes the static loop. Sampling (``greedy=False``) draws
        from ``generator``. ``max_len`` is the cache length (default: prompt
        plus new tokens).
        """
        if self.adapter.kind != "lm":
            return self.adapter.generate(self.params, batch, max_new_tokens)  # raises
        if self.scheme.spec_k:
            raise NotImplementedError(f"speculative decoding is {NOT_PORTED}")
        if isinstance(batch, dict):
            batch = {k: _to_device(v, self.device) for k, v in batch.items()}
        else:
            batch = _to_device(batch, self.device)
        return self.adapter.generate(self.params, batch, max_new_tokens, greedy=greedy,
                                     generator=generator, max_len=max_len)

    def serve(self, *args, **kwargs):
        raise NotImplementedError(f"continuous-batching LM serving (ServeEngine) is {NOT_PORTED}")

    def save(self, path: str) -> None:
        raise NotImplementedError(f"artifact save (checkpoint/manager.py) is {NOT_PORTED}")

    @classmethod
    def load(cls, path: str) -> "QuantizedModel":
        raise NotImplementedError(f"artifact load (checkpoint/manager.py) is {NOT_PORTED}")

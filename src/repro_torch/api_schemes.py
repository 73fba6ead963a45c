"""Quantization schemes and the CNN adapter behind :mod:`repro_torch.api`.

:class:`QuantScheme` is the JAX package's frozen description of one
CoNLoCNN conversion (weight format, granularity, nibble packing,
Algorithm 1, the activation policy and its calibration knobs, kernel
blocks, the Sec. V search knobs), validated the same way.
:class:`CnnAdapter` puts a :class:`~repro_torch.models.cnn.CnnSpec` behind
the calls :func:`repro_torch.api.quantize` makes. LM adapters are not
ported yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar

import torch

from repro_torch.calib.policy import CLIP_MODES, CalibrationTable
from repro_torch.core.elp_bsd import ElpBsdFormat, resolve_format
from repro_torch.models.cnn import CnnSpec

ACT_POLICIES = ("float", "dynamic", "static")
GRANULARITIES = (None, "per_tensor", "per_channel", "per_slice")

NOT_PORTED = "not ported to repro_torch yet; see ROADMAP.md (queue 1)"


@dataclasses.dataclass(frozen=True)
class QuantScheme:
    """A complete conversion configuration (the JAX package's, field for field).

    ``fmt`` is a preset name, an alias or an :class:`ElpBsdFormat`;
    ``act`` is ``"float"``, ``"dynamic"`` or ``"static"`` (calibrated
    scales, needs ``calib_data``); ``block_sizes`` is None or a
    ``(block_m, block_n, block_k)`` tuple. The speculative fields are
    validated but belong to the LM serve path, not ported yet.
    """

    fmt: str = "elp_bsd_a4"
    granularity: str | None = None
    nibble: bool | None = None
    compensate: bool = True
    act: str = "float"
    act_bits: int | None = None
    clip: str = "percentile"
    pct: float = 99.9
    rho_threshold: float = 0.25
    fold_bias: bool = True
    block_sizes: tuple[int, int, int] | str | None = None
    ac: float = 0.01
    bw_max: int = 8
    bw_min: int = 4
    spec_verify: str | None = None
    spec_k: int = 0
    spec_draft: str = "model"

    def __post_init__(self) -> None:
        object.__setattr__(self, "fmt", resolve_format(self.fmt).name)
        if (self.spec_verify is None) != (self.spec_k == 0):
            raise ValueError(
                "speculative schemes set BOTH spec_verify (the verify tier) and "
                "spec_k (the verify width), or neither"
            )
        if self.spec_verify is not None:
            if self.spec_k < 2:
                raise ValueError(f"spec_k is the verify width: need >= 2, got {self.spec_k}")
            if self.spec_verify != "float":
                object.__setattr__(self, "spec_verify", resolve_format(self.spec_verify).name)
        if self.spec_draft not in ("model", "ngram"):
            raise ValueError(f'spec_draft must be "model" or "ngram", got {self.spec_draft!r}')
        if self.act not in ACT_POLICIES:
            raise ValueError(f"act must be one of {ACT_POLICIES}, got {self.act!r}")
        if self.granularity not in GRANULARITIES:
            raise ValueError(f"granularity must be one of {GRANULARITIES}, got {self.granularity!r}")
        if self.clip not in CLIP_MODES:
            raise ValueError(f"clip must be one of {CLIP_MODES}, got {self.clip!r}")
        bs = self.block_sizes
        if isinstance(bs, list):
            bs = tuple(bs)
            object.__setattr__(self, "block_sizes", bs)
        ok = (
            bs is None
            or bs == "auto"
            or (isinstance(bs, tuple) and len(bs) == 3 and all(isinstance(b, int) for b in bs))
        )
        if not ok:
            raise ValueError(
                f'block_sizes must be None, "auto", or a (block_m, block_n, block_k) '
                f"tuple; got {self.block_sizes!r}"
            )
        if self.act_bits is not None and self.act_bits < 2:
            raise ValueError(f"act_bits must be >= 2, got {self.act_bits}")
        if not 2 <= self.bw_min <= self.bw_max:
            raise ValueError(
                f"need 2 <= bw_min <= bw_max, got bw_min={self.bw_min} bw_max={self.bw_max}"
            )

    @property
    def format(self) -> ElpBsdFormat:
        return resolve_format(self.fmt)

    def resolved_act_bits(self) -> int | None:
        """The activation bit-width the scheme implies (None = float)."""
        if self.act == "float":
            return None
        return self.act_bits if self.act_bits is not None else 8


def pack_cnn_params(
    params: dict,
    fmt: "ElpBsdFormat | str",
    *,
    compensate: bool = True,
    granularity: str = "per_tensor",
    nibble: bool | None = None,
) -> dict:
    """Pack every conv/fc weight as a PackedWeight (Sec. V + Algorithm 1).

    Biases stay float. The result drops into
    :func:`repro_torch.models.cnn.forward`, which then runs on the codes.
    """
    from repro_torch.kernels.ops import pack_conv_weight, pack_weight

    fmt = resolve_format(fmt)
    out: dict[str, Any] = {}
    for name, w in params.items():
        if name.endswith("_w") and w.ndim == 4:
            out[name] = pack_conv_weight(
                w, fmt, compensate=compensate, granularity=granularity, nibble=nibble
            )[0]
        elif name.endswith("_w") and w.ndim == 2:
            out[name] = pack_weight(
                w, fmt, compensate=compensate, granularity=granularity, nibble=nibble
            )[0]
        else:
            out[name] = w
    return out


@dataclasses.dataclass(frozen=True)
class CnnAdapter:
    """CNN families (AlexNet/VGG and the minis) behind the façade."""

    spec: CnnSpec
    kind: ClassVar[str] = "cnn"

    def forward(
        self,
        params: dict,
        x: torch.Tensor,
        *,
        calib: CalibrationTable | None = None,
        act_bits: int | None = None,
        impl: str = "auto",
        block_sizes=None,
    ) -> torch.Tensor:
        from repro_torch.models import cnn

        return cnn.forward(
            params, self.spec, x, act_bits, calib=calib, impl=impl, block_sizes=block_sizes
        )

    def calibrate(self, params: dict, calib_data: torch.Tensor, scheme: QuantScheme):
        from repro_torch.calib.runner import calibrate_cnn

        return calibrate_cnn(
            params,
            self.spec,
            calib_data,
            bits=scheme.resolved_act_bits() or 8,
            clip=scheme.clip,
            pct=scheme.pct,
            rho_threshold=scheme.rho_threshold,
            compensate=scheme.fold_bias,
        )

    def pack(self, params: dict, scheme: QuantScheme, table: CalibrationTable | None = None):
        del table  # CNN static scales ride the forward's calib argument
        return pack_cnn_params(
            params,
            scheme.format,
            compensate=scheme.compensate,
            granularity=scheme.granularity or "per_tensor",
            nibble=scheme.nibble,
        )


def as_adapter(model) -> CnnAdapter:
    """``CnnSpec`` -> :class:`CnnAdapter` (idempotent); LMs are not ported yet."""
    if isinstance(model, CnnSpec):
        return CnnAdapter(model)
    if isinstance(model, CnnAdapter):
        return model
    raise NotImplementedError(
        f"repro_torch converts CNNs (a CnnSpec); {type(model).__name__} models are {NOT_PORTED}"
    )

"""Quantization schemes and the model adapters behind :mod:`repro_torch.api`.

:class:`QuantScheme` is the JAX package's frozen description of one
CoNLoCNN conversion (weight format, granularity, nibble packing,
Algorithm 1, the activation policy and its calibration knobs, kernel
blocks, the Sec. V search knobs), validated the same way.
:class:`CnnAdapter` puts a :class:`~repro_torch.models.cnn.CnnSpec` and
:class:`LmAdapter` a decoder-LM
:class:`~repro_torch.configs.base.ArchConfig` behind the calls
:func:`repro_torch.api.quantize` makes. The packing walks live here:
:func:`pack_cnn_params` and :func:`pack_lm_params` (with
:func:`stamp_lm_act`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar

import torch

from repro_torch.calib.policy import CLIP_MODES, CalibrationTable
from repro_torch.configs.base import ArchConfig
from repro_torch.core.elp_bsd import ElpBsdFormat, resolve_format
from repro_torch.kernels.ops import PackedWeight
from repro_torch.models.cnn import CnnSpec
from repro_torch.runtime.quantized_params import ACT_SITE_BY_LEAF, QUANTIZABLE, quantize_stacked

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
    validated, but speculative decoding is not ported yet.
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

    def generate(self, params, batch, max_new_tokens: int, **kw):
        raise NotImplementedError(
            "CNN models classify — use QuantizedModel.forward(images); "
            "generate() is the LM serve path"
        )


def _map_named(fn, tree, name=None):
    """``fn(name, leaf)`` over a nested params dict, ``name`` the leaf's own key."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    return fn(name, tree)


def stamp_lm_act(packed: dict, calib: CalibrationTable) -> dict:
    """Stamp static activation quantizers onto a packed LM tree.

    Each PackedWeight gets the scale of the tap site measuring its input:
    the leaf's own site when the table has one, else
    :data:`~repro_torch.runtime.quantized_params.ACT_SITE_BY_LEAF`. Leaves
    without a measured site stay without activation quantization.
    """
    def visit(name, leaf):
        if isinstance(leaf, PackedWeight):
            sc = calib.lookup(name, default=ACT_SITE_BY_LEAF.get(name))
            if sc is not None:
                return dataclasses.replace(leaf, act_scale=sc.amax, act_bits=sc.bits)
        return leaf

    return _map_named(visit, packed)


def pack_lm_params(
    params: dict,
    cfg: ArchConfig,
    fmt: "ElpBsdFormat | str",
    *,
    compensate: bool = True,
    calib: CalibrationTable | None = None,
) -> dict:
    """Replace every quantizable matmul leaf with a stacked PackedWeight.

    ``calib`` (from :func:`repro_torch.calib.runner.calibrate_lm`) also
    runs :func:`stamp_lm_act`. The float leaves that are packed are not
    kept in the result.
    """
    del cfg  # the walk is name-driven, as in the JAX package
    fmt = resolve_format(fmt)

    def visit(name, leaf):
        if name in QUANTIZABLE and leaf.ndim >= 2:
            return quantize_stacked(leaf, fmt, compensate=compensate)
        return leaf

    packed = _map_named(visit, params)
    return stamp_lm_act(packed, calib) if calib is not None else packed


# Families whose forward supports the activation-tap contract, of those ported.
_LM_TAP_FAMILIES = ("dense",)


@dataclasses.dataclass(frozen=True)
class LmAdapter:
    """Decoder LMs (an ``ArchConfig`` of a ported family) behind the façade.

    ``forward(tokens)`` is a fresh-cache prefill returning the last
    position's logits. Static activation scales are baked into the
    PackedWeights at pack time.
    """

    cfg: ArchConfig
    kind: ClassVar[str] = "lm"

    def init_params(self, seed: int = 0, *, device=None):
        from repro_torch.models import get_model

        return get_model(self.cfg).init_params(self.cfg, seed, device=device)

    def _batch(self, x) -> dict:
        return x if isinstance(x, dict) else {"tokens": x}

    def forward(self, params, x, **kw):
        from repro_torch.models import get_model

        api = get_model(self.cfg)
        batch = self._batch(x)
        b, s = batch["tokens"].shape
        cache = api.init_cache(self.cfg, b, s + (self.cfg.frontend_tokens or 0),
                               device=params["embed"].device)
        logits, _ = api.prefill(params, self.cfg, batch, cache)
        return logits

    def tapped_forward(self, params):
        from repro_torch.calib.runner import TapCollector
        from repro_torch.models import transformer

        if self.cfg.family not in _LM_TAP_FAMILIES:
            raise NotImplementedError(
                f"activation taps are implemented for {_LM_TAP_FAMILIES} families, "
                f"not {self.cfg.family!r}"
            )

        def tapped(tokens):
            tc = TapCollector()
            transformer.forward(params, self.cfg, tokens, tap=tc)
            return tc.acts

        return tapped

    def calibrate(self, params, calib_data, scheme: QuantScheme):
        from repro_torch.calib.runner import calibrate_lm

        if self.cfg.family not in _LM_TAP_FAMILIES:
            raise NotImplementedError(
                f"static activation calibration needs the tap contract, implemented "
                f"for {_LM_TAP_FAMILIES} families — not {self.cfg.family!r}"
            )
        table = calibrate_lm(
            params, self.cfg, calib_data, bits=scheme.resolved_act_bits() or 8,
            clip=scheme.clip, pct=scheme.pct, rho_threshold=scheme.rho_threshold,
        )
        return table, params

    def pack(self, params, scheme: QuantScheme, table: CalibrationTable | None = None):
        if scheme.granularity not in (None, "per_slice"):
            raise ValueError(
                "stacked LM matmuls quantize per_slice (one SF per layer slice); "
                f"granularity={scheme.granularity!r} has no meaning here"
            )
        if scheme.act == "dynamic":
            raise ValueError(
                'LM serving implements act="float" and act="static" (calibrated '
                "scales baked into the packed weights); there is no dynamic-range "
                'activation path in the decode graph — use act="static" with '
                'calib_data, or act="float"'
            )
        return pack_lm_params(params, self.cfg, scheme.format, compensate=scheme.compensate,
                              calib=table)

    def stamp_act(self, packed, table: CalibrationTable):
        return stamp_lm_act(packed, table)

    def generate(self, params, batch, max_new_tokens: int, *, greedy: bool = True,
                 generator=None, max_len: int | None = None):
        """Lockstep generation through :func:`repro_torch.serve.engine.static_generate`.

        The JAX package sends greedy keyless calls to its continuous-batching
        ``ServeEngine``, which its own tests hold token-identical to
        ``static_generate``; until the engine is ported (ROADMAP.md, queue 1
        item 6) every call takes the static loop.
        """
        from repro_torch.serve.engine import ServeSetup, static_generate

        batch = self._batch(batch)
        b, s = batch["tokens"].shape
        if max_len is None:
            max_len = s + max_new_tokens + (self.cfg.frontend_tokens or 0)
        setup = ServeSetup(cfg=self.cfg, mesh=None, max_len=max_len, batch=b)
        return static_generate(setup, params, batch, max_new_tokens, greedy=greedy,
                               generator=generator)


def as_adapter(model):
    """``CnnSpec`` -> :class:`CnnAdapter`, ``ArchConfig`` -> :class:`LmAdapter` (idempotent)."""
    if isinstance(model, CnnSpec):
        return CnnAdapter(model)
    if isinstance(model, ArchConfig):
        return LmAdapter(model)
    if isinstance(model, (CnnAdapter, LmAdapter)):
        return model
    raise NotImplementedError(
        f"repro_torch converts CNNs (a CnnSpec) and decoder LMs (an ArchConfig); "
        f"{type(model).__name__} models are {NOT_PORTED}"
    )

"""Quantization schemes and the model adapters behind :mod:`repro_torch.api`.

:class:`QuantScheme` is the JAX package's frozen description of one
CoNLoCNN conversion (weight format, granularity, nibble packing,
Algorithm 1, the activation policy and its calibration knobs, kernel
blocks, the Sec. V search knobs), validated the same way and written to
an artifact's manifest in the same JSON.
:class:`CnnAdapter` puts a :class:`~repro_torch.models.cnn.CnnSpec` and
:class:`LmAdapter` a decoder-LM
:class:`~repro_torch.configs.base.ArchConfig` behind the calls
:func:`repro_torch.api.quantize` makes. The packing walks live here:
:func:`pack_cnn_params` and :func:`pack_lm_params` (with
:func:`stamp_lm_act`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Mapping

import torch

from repro_torch.calib.policy import CLIP_MODES, CalibrationTable
from repro_torch.configs.base import ArchConfig
from repro_torch.core.elp_bsd import ElpBsdFormat, resolve_format
from repro_torch.kernels.ops import PackedWeight
from repro_torch.models.cnn import CnnSpec, Conv, Fc, Pool
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
    ``(block_m, block_n, block_k)`` tuple. ``spec_verify``/``spec_k``/
    ``spec_draft`` make the scheme speculative
    (:meth:`speculative`): ``quantize`` then also builds the verify tier.
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

    @classmethod
    def speculative(cls, draft: str = "elp_bsd_a4", K: int = 4, verify: str = "float",
                    drafter: str = "model", **kw) -> "QuantScheme":
        """A self-speculative serving scheme.

        ``draft`` is the scheme's ``fmt``, the low-bit tier that drafts
        ``K - 1`` tokens a round; ``verify`` (``"float"`` or a wider ELP
        format) checks each run in one ``K``-wide forward and defines the
        served output. ``drafter`` is the draft source (``"model"``: the
        ``fmt`` tier decodes the drafts; ``"ngram"``: token-recycling lookup,
        no draft forwards). Any other field passes through ``**kw``.
        """
        return cls(fmt=draft, spec_verify=verify, spec_k=int(K), spec_draft=drafter, **kw)

    @property
    def format(self) -> ElpBsdFormat:
        return resolve_format(self.fmt)

    def resolved_act_bits(self) -> int | None:
        """The activation bit-width the scheme implies (None = float)."""
        if self.act == "float":
            return None
        return self.act_bits if self.act_bits is not None else 8

    def to_json(self) -> dict:
        doc = dataclasses.asdict(self)
        if isinstance(doc["block_sizes"], tuple):
            doc["block_sizes"] = list(doc["block_sizes"])
        return doc

    @classmethod
    def from_json(cls, doc: Mapping[str, Any]) -> "QuantScheme":
        unknown = set(doc) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown QuantScheme fields {sorted(unknown)}")
        kw = dict(doc)
        if isinstance(kw.get("block_sizes"), list):
            kw["block_sizes"] = tuple(kw["block_sizes"])
        return cls(**kw)


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

    def stamp_act(self, packed: dict, table: CalibrationTable) -> dict:
        del table  # the table rides the QuantizedModel, not the packed leaves
        return packed

    def generate(self, params, batch, max_new_tokens: int, **kw):
        raise NotImplementedError(
            "CNN models classify — use QuantizedModel.forward(images); "
            "generate() is the LM serve path"
        )

    def serve(self, params, requests, **kw):
        raise NotImplementedError(
            "CNN models classify — use QuantizedModel.forward(images); "
            "serve() is the LM continuous-batching path"
        )

    def model_json(self) -> dict:
        layers = []
        for layer in self.spec.layers:
            if isinstance(layer, Conv):
                layers.append(["conv", layer.ch, layer.k, layer.stride])
            elif isinstance(layer, Pool):
                layers.append(["pool", layer.k, layer.stride])
            elif isinstance(layer, Fc):
                layers.append(["fc", layer.out])
            else:
                raise TypeError(f"unknown CNN layer {layer!r}")
        return {"name": self.spec.name, "input_hw": self.spec.input_hw,
                "input_ch": self.spec.input_ch, "layers": layers}

    @staticmethod
    def model_from_json(doc: Mapping[str, Any]) -> CnnSpec:
        layers = []
        for rec in doc["layers"]:
            tag = rec[0]
            if tag == "conv":
                layers.append(Conv(int(rec[1]), int(rec[2]), int(rec[3])))
            elif tag == "pool":
                layers.append(Pool(int(rec[1]), int(rec[2])))
            elif tag == "fc":
                layers.append(Fc(int(rec[1])))
            else:
                raise ValueError(f"unknown CNN layer tag {tag!r}")
        return CnnSpec(name=str(doc["name"]), layers=tuple(layers),
                       input_hw=int(doc["input_hw"]), input_ch=int(doc["input_ch"]))


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


# Families whose forward supports the activation-tap contract (they run
# through models/transformer.py).
_LM_TAP_FAMILIES = ("dense", "moe", "vlm")


@dataclasses.dataclass(frozen=True)
class LmAdapter:
    """Decoder LMs (an ``ArchConfig`` of a ported family) behind the façade.

    ``forward(tokens)`` (or a batch dict with ``"tokens"`` and, for a
    ``vlm`` model, ``"frontend"``) is a fresh-cache prefill returning the
    last position's logits. Static activation scales are baked into the
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
                 generator=None, max_len: int | None = None, draft_params: Any = None,
                 spec_k: int = 0, spec_draft: str = "model"):
        """Generation through :func:`repro_torch.serve.engine.batch_generate`:
        greedy calls on the continuous-batching engine, sampled ones on the
        static loop."""
        from repro_torch.serve.engine import batch_generate

        return batch_generate(self.cfg, params, self._batch(batch), max_new_tokens,
                              max_len=max_len, greedy=greedy, generator=generator,
                              draft_params=draft_params, spec_k=spec_k, spec_draft=spec_draft)

    def serve(self, params, requests, *, n_slots: int = 4, max_len: int | None = None,
              mesh="auto", flash_decode: bool = False, draft_params: Any = None,
              spec_k: int = 0, spec_draft: str = "model", metrics: Any = None,
              trace: Any = None) -> list:
        """Continuous-batching serving through :class:`repro_torch.serve.engine.ServeEngine`.

        ``spec_k`` turns on speculative decoding: ``params`` is then the
        verify tier (it defines the output), drafted against by
        ``draft_params`` (``spec_draft="model"``) or the engine's token
        history (``"ngram"``). ``mesh`` and ``flash_decode`` go to the engine.
        """
        import numpy as np

        from repro_torch.serve.engine import ServeEngine

        reqs = [(np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t, np.int32).reshape(-1),
                 int(n)) for t, n in requests]
        if not reqs:
            return []
        if max_len is None:
            max_len = max(t.size + n for t, n in reqs)
        eng = ServeEngine(self.cfg, params, n_slots=min(n_slots, len(reqs)), max_len=max_len,
                          mesh=mesh, flash_decode=flash_decode, draft_params=draft_params,
                          spec_k=spec_k, spec_draft=spec_draft, metrics=metrics, trace=trace)
        return eng.serve(reqs)

    def model_json(self) -> dict:
        doc = dataclasses.asdict(self.cfg)
        doc["period"] = list(doc["period"])
        return doc

    @staticmethod
    def model_from_json(doc: Mapping[str, Any]) -> ArchConfig:
        unknown = set(doc) - {f.name for f in dataclasses.fields(ArchConfig)}
        if unknown:
            raise ValueError(f"unknown ArchConfig fields {sorted(unknown)}")
        kw = dict(doc)
        kw["period"] = tuple(kw.get("period", ()))
        return ArchConfig(**kw)


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

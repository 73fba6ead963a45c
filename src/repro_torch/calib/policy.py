"""Scale selection and correlation-gated bias folding (the paper's correlation half).

Observer summaries become a :class:`CalibrationTable` of static per-site
quantizers. Quantizing an activation ``x`` to ``Q(x) = x + eps`` shifts the
next layer's pre-activation by ``W @ E[eps]``; :func:`fold_cnn_bias`
subtracts that shift from the consumer's bias at convert time. The fold is
gated per site on the measured adjacent-activation correlation ``rho``:
a correlated error field keeps its mean through pooling, an independent
one does not.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from repro_torch.calib.observers import ObserverSummary

CLIP_MODES = ("max", "percentile")


@dataclasses.dataclass(frozen=True)
class SiteCalibration:
    """Static quantizer and compensation data for one tap site."""

    amax: float  # clipping range (static scale = amax / qmax)
    bits: int
    rho: float
    mean: float
    std: float
    err_mean: tuple[float, ...] | None = None  # per-channel E[Q(x) - x]
    compensate: bool = False  # the rho gate's decision


@dataclasses.dataclass(frozen=True)
class CalibrationTable:
    """Per-site static activation quantizers, addressed by site name."""

    sites: tuple[tuple[str, SiteCalibration], ...]
    clip: str = "max"
    pct: float = 100.0
    rho_threshold: float = 0.25

    def names(self) -> tuple[str, ...]:
        return tuple(n for n, _ in self.sites)

    def site(self, name: str) -> SiteCalibration:
        for n, s in self.sites:
            if n == name:
                return s
        raise KeyError(f"no calibration for site {name!r}; have {self.names()}")

    def lookup(self, name: str, default: str | None = None) -> SiteCalibration | None:
        """Site ``name``, else site ``default`` when given and present, else None."""
        names = self.names()
        if name in names:
            return self.site(name)
        if default is not None and default in names:
            return self.site(default)
        return None


def build_table(
    summaries: Mapping[str, ObserverSummary],
    *,
    bits: int = 8,
    clip: str = "percentile",
    pct: float = 99.9,
    rho_threshold: float = 0.25,
) -> CalibrationTable:
    """Each site's static clipping range: the observed max, or a percentile."""
    if clip not in CLIP_MODES:
        raise ValueError(f"clip must be one of {CLIP_MODES}, got {clip!r}")
    sites = []
    for name, s in summaries.items():
        amax = s.amax if clip == "max" else s.percentile_amax(pct)
        sites.append((
            name,
            SiteCalibration(
                amax=float(max(amax, 1e-12)), bits=int(bits), rho=s.rho, mean=s.mean,
                std=s.std, compensate=abs(s.rho) >= rho_threshold,
            ),
        ))
    return CalibrationTable(sites=tuple(sites), clip=clip, pct=pct, rho_threshold=rho_threshold)


def attach_errors(
    table: CalibrationTable, summaries: Mapping[str, ObserverSummary]
) -> CalibrationTable:
    """Record the second pass's per-channel mean errors into the table."""
    sites = []
    for name, s in table.sites:
        em = summaries[name].err_mean if name in summaries else None
        err = tuple(float(e) for e in em) if em is not None else None
        sites.append((name, dataclasses.replace(s, err_mean=err)))
    return dataclasses.replace(table, sites=tuple(sites))


def fold_cnn_bias(params: dict, spec, table: CalibrationTable) -> dict:
    """Fold ``W @ E[eps]`` of each quantized input site into its consumer's bias.

    Walks the spec as ``cnn.forward`` does, tracking which tap site feeds
    each conv or fc layer; sites whose gate is off or that carry no
    measured error are left alone.
    """
    from repro_torch.models.cnn import Conv, Fc, Pool

    out = dict(params)
    site = "input"
    site_ch = spec.input_ch
    idx = 0
    flat_ch: int | None = None  # channels at flatten time (first Fc)
    for l in spec.layers:
        if isinstance(l, Pool):
            continue  # pooling keeps the channel count (and a correlated error mean)
        sc = table.lookup(site)
        fold = sc is not None and sc.compensate and sc.err_mean is not None
        if isinstance(l, Conv):
            if fold:
                w = params[f"conv{idx}_w"].to(torch.float32)  # [kh, kw, cin, cout]
                err = torch.tensor(sc.err_mean, dtype=torch.float32, device=w.device)
                delta = torch.einsum("hwio,i->o", w, err)
                b = params[f"conv{idx}_b"]
                out[f"conv{idx}_b"] = b - delta.to(b.dtype)
            site, site_ch = f"conv{idx}", l.ch
            idx += 1
        elif isinstance(l, Fc):
            if fold:
                w = params[f"fc{idx}_w"].to(torch.float32)  # [fan_in, out]
                err = torch.tensor(sc.err_mean, dtype=torch.float32, device=w.device)
                if flat_ch is None:
                    # the first fc eats the flattened [h, w, c] map (c fastest):
                    # the per-channel error tiles over the spatial positions
                    delta = torch.einsum("pio,i->o", w.reshape(-1, site_ch, w.shape[-1]), err)
                else:
                    delta = torch.einsum("io,i->o", w, err)
                b = params[f"fc{idx}_b"]
                out[f"fc{idx}_b"] = b - delta.to(b.dtype)
            if flat_ch is None:
                flat_ch = site_ch
            site, site_ch = f"fc{idx}", l.out
            idx += 1
    return out

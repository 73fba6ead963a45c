"""Streaming per-site activation statistics on torch tensors.

One :class:`ObserverState` per activation-tap site accumulates, over the
calibration batches: the running ``max |x|``, first and second moments, a
1/8-octave histogram of ``log2 |x|`` for percentile clipping, the
adjacent-activation Pearson correlation ``rho`` (the paper's observation
that neighbouring activations are correlated), the per-channel running
max, and, on the second pass once scales are fixed, the per-channel mean
quantization error ``E[Q(x) - x]`` that the policy folds into biases.

Sums stay on the tensors' device; element counts follow from shapes and
are Python ints. The histogram is a ``bincount`` where the JAX package
scatters with ``hist.at[bins].add(1)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.quantize import fake_quant_uniform

# Bin b covers |x| in [2^((b - OFFSET) / SCALE), 2^((b + 1 - OFFSET) / SCALE)),
# about 6e-8 .. 2.4e2; outliers clamp into the edge bins.
HIST_BINS = 256
HIST_SCALE = 8
HIST_OFFSET = 192


@dataclasses.dataclass
class ObserverState:
    """Streaming sufficient statistics for one tap site."""

    count: int
    amax: torch.Tensor
    asum: torch.Tensor
    asq: torch.Tensor
    hist: torch.Tensor  # [HIST_BINS] int64 magnitude counts
    pair_n: int
    pair_xy: torch.Tensor
    pair_x: torch.Tensor
    pair_y: torch.Tensor
    pair_x2: torch.Tensor
    pair_y2: torch.Tensor
    ch_err: torch.Tensor  # [C] sum of (Q(x) - x) per trailing channel
    ch_n: int
    ch_amax: torch.Tensor  # [C] running max |x| per trailing channel


def init_observer(channels: int, device) -> ObserverState:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return ObserverState(
        count=0, amax=z, asum=z, asq=z,
        hist=torch.zeros(HIST_BINS, dtype=torch.int64, device=device),
        pair_n=0, pair_xy=z, pair_x=z, pair_y=z, pair_x2=z, pair_y2=z,
        ch_err=torch.zeros(channels, dtype=torch.float32, device=device),
        ch_n=0,
        ch_amax=torch.zeros(channels, dtype=torch.float32, device=device),
    )


def _adjacent_pairs(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Neighbouring values along the spatial/sequence axis (second to last)
    when there is one, else along the feature axis."""
    axis = x.ndim - 2 if x.ndim >= 3 else x.ndim - 1
    n = x.shape[axis]
    return x.narrow(axis, 0, n - 1), x.narrow(axis, 1, n - 1)


def update(
    state: ObserverState, x: torch.Tensor, *, quant: tuple[int, float] | None = None
) -> ObserverState:
    """Fold one tapped activation into the statistics.

    ``quant=(bits, amax)`` also accumulates the per-channel mean
    quantization error under that fixed quantizer (the second pass).
    """
    xf = x.to(torch.float32)
    ax = torch.abs(xf)
    c = x.shape[-1]
    bins = torch.clamp(
        torch.floor(HIST_SCALE * torch.log2(torch.clamp(ax, min=1e-30))) + HIST_OFFSET,
        0, HIST_BINS - 1,
    ).to(torch.int64)
    a, b = _adjacent_pairs(xf)
    ch_err, ch_n = state.ch_err, state.ch_n
    if quant is not None:
        bits, amax = quant
        err = fake_quant_uniform(xf, bits, float(amax)) - xf
        ch_err = ch_err + torch.sum(err.reshape(-1, c), dim=0)
        ch_n = ch_n + x.numel() // c
    return ObserverState(
        count=state.count + x.numel(),
        amax=torch.maximum(state.amax, torch.max(ax)),
        asum=state.asum + torch.sum(xf),
        asq=state.asq + torch.sum(torch.square(xf)),
        hist=state.hist + torch.bincount(bins.reshape(-1), minlength=HIST_BINS),
        pair_n=state.pair_n + a.numel(),
        pair_xy=state.pair_xy + torch.sum(a * b),
        pair_x=state.pair_x + torch.sum(a),
        pair_y=state.pair_y + torch.sum(b),
        pair_x2=state.pair_x2 + torch.sum(torch.square(a)),
        pair_y2=state.pair_y2 + torch.sum(torch.square(b)),
        ch_err=ch_err,
        ch_n=ch_n,
        ch_amax=torch.maximum(state.ch_amax, torch.amax(ax.reshape(-1, c), dim=0)),
    )


@dataclasses.dataclass(frozen=True)
class ObserverSummary:
    """Host-side digest of one site's statistics."""

    count: float
    amax: float
    mean: float
    std: float
    rho: float  # adjacent-activation Pearson correlation
    hist: np.ndarray
    err_mean: np.ndarray | None  # [C] per-channel E[Q(x) - x], second pass only
    ch_amax: np.ndarray | None = None

    def percentile_amax(self, pct: float) -> float:
        """Smallest magnitude covering ``pct`` % of the observed values: the
        upper edge of the first histogram bin where the cumulative count
        reaches the target (the running max at ``pct >= 100``)."""
        if pct >= 100.0 or self.count == 0:
            return self.amax
        cum = np.cumsum(self.hist)
        target = self.count * pct / 100.0
        b = int(np.searchsorted(cum, target))
        if b >= HIST_BINS - 1:
            return self.amax
        edge = 2.0 ** ((b + 1 - HIST_OFFSET) / HIST_SCALE)
        return float(min(edge, self.amax)) if self.amax > 0 else float(edge)


def summarize(state: ObserverState) -> ObserverSummary:
    """Fetch a state to host floats."""
    n = float(state.count)
    mean = float(state.asum) / max(n, 1.0)
    var = max(float(state.asq) / max(n, 1.0) - mean * mean, 0.0)
    pn = max(float(state.pair_n), 1.0)
    px, py = float(state.pair_x) / pn, float(state.pair_y) / pn
    cov = float(state.pair_xy) / pn - px * py
    vx = float(state.pair_x2) / pn - px**2
    vy = float(state.pair_y2) / pn - py**2
    denom = np.sqrt(max(vx, 0.0) * max(vy, 0.0))
    rho = cov / denom if denom > 1e-12 else 0.0
    err_mean = state.ch_err.cpu().numpy() / state.ch_n if state.ch_n > 0 else None
    return ObserverSummary(
        count=n,
        amax=float(state.amax),
        mean=mean,
        std=float(np.sqrt(var)),
        rho=float(np.clip(rho, -1.0, 1.0)),
        hist=state.hist.cpu().numpy(),
        err_mean=err_mean,
        ch_amax=state.ch_amax.cpu().numpy(),
    )

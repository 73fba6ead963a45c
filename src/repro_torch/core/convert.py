"""The conversion engine: SF -> TQL -> nearest level -> Algorithm 1 -> codes.

Layout agnostic, as in the JAX package's ``core/convert.py``: matmul
weights ``[..., K, N]`` and conv weights ``[H, W, Cin, Cout]`` alike.

* ``granularity`` says which axes share one scale factor:
  ``per_tensor`` (paper Sec. V), ``per_slice`` (one SF per trailing
  ``[K, N]`` slice of a stack) or ``per_channel`` (one SF per output
  channel, the last axis).
* ``group_axes`` are the axes Algorithm 1 averages the error over: the
  contracting dim ``(-2,)`` for matmuls, the spatial dims ``(0, 1)`` for
  convs. Groups must lie inside one scale cell.

``nibble_pack`` emits 4-bit codes two per byte along K.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.compensate import _from_groups, _to_groups, compensate_groups
from repro_torch.core.elp_bsd import ElpBsdFormat, resolve_format
from repro_torch.core.quantize import nn_quantize_idx

GRANULARITIES = ("per_tensor", "per_slice", "per_channel")


def sf_reduce_axes(granularity: str, ndim: int) -> tuple[int, ...]:
    """Axes shared by one scale factor for a given layout."""
    if granularity == "per_tensor":
        return tuple(range(ndim))
    if granularity == "per_slice":
        return tuple(range(ndim)) if ndim < 2 else (ndim - 2, ndim - 1)
    if granularity == "per_channel":
        return tuple(range(ndim)) if ndim < 2 else tuple(range(ndim - 1))
    raise ValueError(f"unknown granularity {granularity!r}; pick from {GRANULARITIES}")


def default_group_axes(ndim: int) -> tuple[int, ...]:
    """Algorithm 1 grouping per layout: spatial dims for a conv, else the contracting dim."""
    if ndim == 4:
        return (0, 1)
    if ndim >= 2:
        return (ndim - 2,)
    return (0,)


@dataclasses.dataclass
class ConvertedTensor:
    """Level indices (source shape) plus keepdims-broadcastable scale factors."""

    level_idx: torch.Tensor  # int32, shape == source shape
    sf: torch.Tensor  # float32, keepdims-broadcastable against level_idx
    fmt_name: str

    @property
    def fmt(self) -> ElpBsdFormat:
        return resolve_format(self.fmt_name)

    @property
    def values(self) -> torch.Tensor:
        """Dequantized float32 values."""
        lv = torch.as_tensor(self.fmt.levels().astype(np.float32), device=self.sf.device)
        return lv[self.level_idx.long()] * self.sf

    def codes(self) -> torch.Tensor:
        """Raw bit codes, one uint8 per weight (source shape)."""
        lc = torch.as_tensor(self.fmt.level_codes(), device=self.level_idx.device)
        return lc[self.level_idx.long()].to(torch.uint8)


def convert_tensor(
    w: torch.Tensor,
    fmt: "ElpBsdFormat | str",
    *,
    granularity: str = "per_tensor",
    compensate: bool = True,
    group_axes: Sequence[int] | None = None,
) -> ConvertedTensor:
    """SF -> TQL -> nearest-neighbour -> (Algorithm 1) on one weight tensor."""
    fmt = resolve_format(fmt)
    wf = w.to(torch.float32)
    ndim = wf.ndim

    reduce_axes = sf_reduce_axes(granularity, ndim)
    mx = torch.amax(torch.abs(wf), dim=reduce_axes, keepdim=True)
    # A tiny clamp instead of a zero check keeps all-zero cells
    # dequantizing to ~0 even for formats without a zero level.
    sf = torch.clamp(mx / (2.0**fmt.max_shift), min=1e-20)
    wn = wf / sf

    levels = fmt.levels()
    idx = nn_quantize_idx(wn, levels)

    if compensate:
        if group_axes is None:
            group_axes = default_group_axes(ndim)
        group_axes = tuple(a % ndim for a in group_axes)
        if not set(group_axes) <= set(reduce_axes):
            raise ValueError(
                f"Algorithm 1 groups {group_axes} cross scale cells of "
                f"granularity {granularity!r} (sf spans axes {reduce_axes}); "
                "the mean error is only well-defined within one scale cell"
            )
        # Grouping runs on the normalized weights against the unscaled
        # level table: exact, because sf is constant within each group.
        wg, perm, t_shape = _to_groups(wn, group_axes)
        ig, _, _ = _to_groups(idx, group_axes)
        idx = _from_groups(compensate_groups(wg, ig, levels), perm, t_shape)

    return ConvertedTensor(
        level_idx=idx.to(torch.int32).contiguous(), sf=sf.to(torch.float32), fmt_name=fmt.name
    )


def nibble_pack(codes: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Pack 4-bit codes two per byte along ``axis``, low nibble first.

    An odd length is padded with code 0, which may decode to a NONZERO
    value (FORMAT_A's code 0 is +1): consumers slice the logical length
    off after decode or feed the pad row zero activations.
    """
    axis = axis % codes.ndim
    c = codes.to(torch.uint8).movedim(axis, 0)
    if c.shape[0] % 2:
        c = torch.cat([c, torch.zeros_like(c[:1])])
    return (c[0::2] | (c[1::2] << 4)).movedim(0, axis).contiguous()

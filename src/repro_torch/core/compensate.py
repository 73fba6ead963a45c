"""Algorithm 1: convert-time error compensation, vectorised over groups.

Every candidate flip moves a group's mean quantization error toward
zero, so the prefix of cost-sorted flips the paper's greedy loop accepts
is the prefix minimising ``|mean error|``: sort, cumulative sum and
argmin per group, over all groups at once. Errors use ``e = q - w``.

Matches the JAX package's ``core/compensate.py``: the cost sort is
stable (``jnp.argsort`` is) and the argmin takes the first minimum.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.elp_bsd import ElpBsdFormat
from repro_torch.core.quantize import (
    QuantizedTensor,
    _levels_tensor,
    quantize_tensor,
    second_neighbor_idx,
)


def compensate_groups(
    w: torch.Tensor, nn_idx: torch.Tensor, levels: "np.ndarray | torch.Tensor"
) -> torch.Tensor:
    """Algorithm 1 over ``w[G, N]`` groups. Returns level indices ``[G, N]``."""
    lv = _levels_tensor(levels, w.device)
    g, n = w.shape
    wf = w.to(torch.float32)
    q = lv[nn_idx.long()]
    mean_err = torch.mean(q - wf, dim=1, keepdim=True)

    # Flip target: the neighbouring level on the other side of w (edge
    # elements get flip_idx == nn_idx, which zeroes their delta below).
    flip_idx = second_neighbor_idx(wf, levels, nn_idx)
    delta = lv[flip_idx.long()] - q

    # Candidates: real flips that move the mean toward zero.
    candidate = (torch.sign(delta) == -torch.sign(mean_err)) & (delta != 0.0)

    # Cost (paper: |S - SO|): distance from the raw value to the flip level.
    cost = torch.where(candidate, torch.abs(wf - lv[flip_idx.long()]), torch.inf)
    order = torch.argsort(cost, dim=1, stable=True)

    delta_sorted = torch.where(
        torch.gather(candidate, 1, order), torch.gather(delta, 1, order), 0.0
    )
    prefix_mean = mean_err + torch.cumsum(delta_sorted, dim=1) / n
    traj = torch.abs(torch.cat([mean_err, prefix_mean], dim=1))
    k_star = torch.argmin(traj, dim=1, keepdim=True)  # first minimum = flips accepted

    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(n, device=w.device).expand(g, n))
    accept = candidate & (rank < k_star)
    return torch.where(accept, flip_idx, nn_idx.to(torch.int32))


def _to_groups(
    w: torch.Tensor, group_axes: Sequence[int]
) -> tuple[torch.Tensor, tuple[int, ...], tuple[int, ...]]:
    """Reshape ``w`` to ``[G, N]`` where N spans ``group_axes`` (the mean dims)."""
    nd = w.ndim
    group_axes = tuple(a % nd for a in group_axes)
    keep_axes = tuple(a for a in range(nd) if a not in group_axes)
    perm = keep_axes + group_axes
    wt = w.permute(perm)
    g = int(np.prod([w.shape[a] for a in keep_axes])) if keep_axes else 1
    n = int(np.prod([w.shape[a] for a in group_axes])) if group_axes else 1
    return wt.reshape(g, n), perm, tuple(wt.shape)


def _from_groups(x: torch.Tensor, perm: tuple[int, ...], t_shape: tuple[int, ...]) -> torch.Tensor:
    inv = tuple(int(i) for i in np.argsort(perm))
    return x.reshape(t_shape).permute(inv)


def compensate_tensor(
    w: torch.Tensor, qt: QuantizedTensor, group_axes: Sequence[int]
) -> QuantizedTensor:
    """Algorithm 1 on a quantized tensor: a new :class:`QuantizedTensor` with flipped levels.

    ``w`` is the raw weight, ``qt`` its nearest-neighbour quantization, and
    ``group_axes`` the axes the mean error is compensated over: ``(0, 1)``
    for a conv ``[H, W, Cin, Cout]`` (the paper's intra-channel case),
    ``(0,)`` for a matmul ``[din, dout]``.
    """
    wg, perm, t_shape = _to_groups(w, group_axes)
    ig, _, _ = _to_groups(qt.level_idx, group_axes)
    new_idx = _from_groups(compensate_groups(wg, ig, qt.levels), perm, t_shape)
    lv = _levels_tensor(qt.levels, w.device)
    return QuantizedTensor(
        values=lv[new_idx.long()].to(qt.values.dtype),
        level_idx=new_idx.to(torch.int32).contiguous(),
        sf=qt.sf,
        levels=qt.levels,
        fmt=qt.fmt,
    )


def compensated_quantize(
    w: torch.Tensor, fmt: ElpBsdFormat, group_axes: Sequence[int]
) -> QuantizedTensor:
    """Sec. V steps 2-4 in one call: SF -> TQL -> nearest level -> Algorithm 1."""
    return compensate_tensor(w, quantize_tensor(w, fmt), group_axes)


def mean_error_report(
    w: torch.Tensor,
    qt_before: QuantizedTensor,
    qt_after: QuantizedTensor,
    group_axes: Sequence[int],
) -> dict[str, float]:
    """Mean |group-mean error| before and after compensation, and the reduction."""
    out = {}
    for tag, qt in (("before", qt_before), ("after", qt_after)):
        eg, _, _ = _to_groups(qt.values - w, group_axes)
        out[tag] = float(torch.mean(torch.abs(torch.mean(eg, dim=1))))
    out["reduction"] = 1.0 - out["after"] / max(out["before"], 1e-30)
    return out

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

from repro_torch.core.quantize import second_neighbor_idx


def compensate_groups(w: torch.Tensor, nn_idx: torch.Tensor, levels: np.ndarray) -> torch.Tensor:
    """Algorithm 1 over ``w[G, N]`` groups. Returns level indices ``[G, N]``."""
    lv = torch.as_tensor(np.asarray(levels, np.float32), device=w.device)
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

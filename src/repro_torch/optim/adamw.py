"""AdamW with float32 master weights, global-norm clipping and a warmup-cosine schedule.

The JAX package's ``repro/optim/adamw.py`` on parameter trees (nested dicts
of tensors). The model parameters stay in the model dtype (bf16 at scale);
the state holds float32 first and second moments and float32 master
weights, 12 bytes a parameter. :func:`update` writes the state's tensors in
place (where the JAX package donates its buffers) and returns new model
parameters cast from the masters.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.kernels.ops import tree_leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_state(params: Any) -> dict[str, Any]:
    """Zero float32 moments, float32 master copies (never aliasing the parameters)
    and an int32 step counter, on the parameters' device."""
    leaf = tree_leaves(params)[0]
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params),
        "master": tree_map(lambda p: p.detach().to(F32, copy=True), params),
        "step": torch.zeros((), dtype=torch.int32, device=leaf.device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    """``sqrt(sum g^2)`` over every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(F32))) for g in tree_leaves(tree)))


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """Float32 gradients scaled by ``min(1, max_norm / norm)``, and the norm."""
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return tree_map(lambda g: g.to(F32) * scale, grads), gnorm


def update(grads: Any, state: dict[str, Any], cfg: AdamWConfig, lr: torch.Tensor,
           param_dtype: torch.dtype) -> tuple[Any, dict[str, Any]]:
    """One AdamW step on the clipped gradients: the state's moments, masters and step
    updated in place; returns (new model parameters in ``param_dtype``, the state)."""
    grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    with torch.no_grad():
        state["step"] += 1
        s = state["step"].to(F32)
        b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=F32, device=s.device), s)
        b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=F32, device=s.device), s)

        def upd(g, m, v, w):
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
            step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * w
            w.sub_(lr * step)

        tree_map(upd, grads, state["m"], state["v"], state["master"])
        new_params = tree_map(lambda w: w.to(param_dtype, copy=True), state["master"])
    return new_params, state


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------
def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.1) -> Callable:
    """``sched(step) -> lr``: linear warmup to ``peak`` over ``warmup`` steps, then a
    cosine to ``floor * peak`` at ``total``; float32, from an integer step tensor."""

    def sched(step: torch.Tensor) -> torch.Tensor:
        s = torch.as_tensor(step).to(F32)
        warm = peak * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup, warm, cos)

    return sched

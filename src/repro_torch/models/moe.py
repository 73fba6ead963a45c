"""Mixture-of-Experts FFN: top-k routing over a stack of experts, the dense form.

The port of the JAX package's ``repro/models/moe.py`` on one card. Its
``moe_dense`` runs every expert on every token and weighs each output by
the token's gate (zero outside its top-k), so its products cost
``n_experts / topk`` times those of a routed MoE; the JAX package takes
it whenever there is no device mesh, as on one card, and this module
keeps that design. Expert weights may arrive packed (an ``[E, K', N]``
layer view of an ``[L, E, K', N]`` expert stack): they are dequantized
whole at every call, as the reference's ``_dq`` does, and the products
are plain batched matmuls, which the JAX package leaves to XLA (no TPU
kernel of the reference runs here). A packed expert stack's static
activation scale is not applied, as in the reference.

Products keep the reference's rounding: operands in the activation
dtype, float32 results (``preferred_element_type=F32``) — on the card
``torch.bmm(..., out_dtype=torch.float32)`` for bfloat16 operands, on the
host a float32 product of the same values — and the SwiGLU/GELU output
rounded to the activation dtype before the down projection.

Not ported: the expert-parallel form (``moe_ep``: ``shard_map`` and
``all_to_all`` over a device mesh) and ``load_balance_loss`` (it serves
training); both wait for ROADMAP.md queue 1 item 6.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import full_f32
from repro_torch.kernels.ops import PackedWeight, dequantize

F32 = torch.float32


def router_gates(x2d: torch.Tensor, router: torch.Tensor, topk: int):
    """Top-k routing of ``x2d[T, D]``: (gate weights ``[T, k]`` float32, expert ids ``[T, k]``).

    ``jax.lax.top_k`` returns the lower index first among equal logits;
    ``torch.topk`` promises no order among them, so the ids come from a
    stable descending sort.
    """
    with full_f32():
        logits = torch.matmul(x2d.to(F32), router.to(F32))
    topv, topi = torch.sort(logits, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :topk], topi[:, :topk]
    return torch.softmax(topv, dim=-1), topi


def _dq(w, dtype) -> torch.Tensor:
    """Expert weights in ``dtype``; a packed stack is decoded whole (its act scale unused)."""
    if isinstance(w, PackedWeight):
        return dequantize(w).to(dtype)
    return w.to(dtype)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a[E, C, K] @ b[E, K, N]`` with a float32 result of ``a.dtype`` operands."""
    if a.dtype == F32:
        with full_f32():
            return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=F32)
    # the host has no float32-result product of bfloat16 operands: the same
    # products of the same (exactly widened) values, summed in float32
    return torch.bmm(a.to(F32), b.to(F32))


def _expert_ffn(h: torch.Tensor, w1, w3, w2, kind: str) -> torch.Tensor:
    """Batched expert FFN: ``h[E, C, D]`` with weights ``[E, D, ff]`` / ``[E, ff, D]``."""
    a = _bmm_f32(h, _dq(w1, h.dtype))
    if kind == "swiglu":
        b = _bmm_f32(h, _dq(w3, h.dtype))
        z = (F.silu(a) * b).to(h.dtype)
    else:
        z = F.gelu(a, approximate="tanh").to(h.dtype)
    del a
    return _bmm_f32(z, _dq(w2, h.dtype)).to(h.dtype)


def moe_dense(p: dict, x2d: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Every expert on every token ``x2d[T, D]``, combined by the top-k gates."""
    gates, topi = router_gates(x2d, p["router"], cfg.topk)
    t, d = x2d.shape
    e = cfg.n_experts
    # [T, E] combine matrix: one add per (token, chosen expert) onto zero, so
    # the accumulation is exact, as the reference's .at[].add
    combine = torch.zeros((t, e), dtype=F32, device=x2d.device)
    rows = torch.arange(t, device=x2d.device)[:, None].expand(t, topi.shape[1])
    combine.index_put_((rows, topi), gates, accumulate=True)
    h = x2d[None].expand(e, t, d)
    y = _expert_ffn(h, p["we1"], p.get("we3"), p["we2"], cfg.mlp_kind)  # [E, T, D]
    with full_f32():
        return torch.einsum("etd,te->td", y.to(F32), combine).to(x2d.dtype)


def moe_apply(p: dict, x2d: torch.Tensor, cfg: ArchConfig, pctx=None) -> torch.Tensor:
    """The MoE FFN of one layer on ``x2d[T, D]``: :func:`moe_dense` on one card.

    A ``pctx`` (a device mesh, where the reference may route through
    ``moe_ep``) raises ``NotImplementedError``.
    """
    if pctx is not None:
        raise NotImplementedError(
            "MoE over a device mesh (pctx; the reference's expert-parallel moe_ep) is not "
            "ported to repro_torch yet; see ROADMAP.md (queue 1 item 6)"
        )
    return moe_dense(p, x2d, cfg)

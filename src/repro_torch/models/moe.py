"""Mixture-of-Experts FFN: top-k routing with two interchangeable forms.

The port of the JAX package's ``repro/models/moe.py``:

* ``moe_dense`` runs every expert on every token and weighs each output
  by the token's gate (zero outside its top-k), so its products cost
  ``n_experts / topk`` times those of a routed MoE; the JAX package takes
  it without a device mesh, and it is the oracle of the routed form.
* ``moe_ep`` is expert parallelism over the mesh's model axis: tokens are
  bucketed by destination rank and local expert into a fixed-capacity send
  buffer (capacity ``max(8, ceil(t * k / E * moe_capacity_factor))``;
  slots past it are dropped), exchanged with ``all_to_all`` over the model
  group, run through the rank's local experts as one batched product, sent
  back the same way and combined by their gates. The JAX package writes it
  under ``shard_map``; here each rank calls it on its local tokens and
  its own slice of the experts (:mod:`repro_torch.runtime.collectives`).

Expert weights may arrive packed (an ``[E, K', N]`` layer view of an
``[L, E, K', N]`` expert stack): they are dequantized whole at every call,
as the reference's ``_dq`` does, and the products are plain batched
matmuls, which the JAX package leaves to XLA (no TPU kernel of the
reference runs here). A packed expert stack's static activation scale is
not applied, as in the reference.

Products keep the reference's rounding: operands in the activation
dtype, float32 results (``preferred_element_type=F32``) — on the card
``torch.bmm(..., out_dtype=torch.float32)`` for bfloat16 operands, on the
host (and wherever an operand takes a gradient) a float32 product of the
same values — and the SwiGLU/GELU output rounded to the activation dtype
before the down projection. :func:`load_balance_loss` is the reference's
auxiliary loss (defined there, and not on its loss path).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import full_f32
from repro_torch.kernels.ops import PackedWeight, dequantize
from repro_torch.models.layers import tp_full, tp_matmul, tp_take
from repro_torch.runtime import collectives

F32 = torch.float32


def router_logits(x2d: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """The float32 expert logits ``[T, E]`` of ``x2d[T, D]``."""
    with full_f32():
        return torch.matmul(x2d.to(F32), router.to(F32))


def router_gates(x2d: torch.Tensor, router: torch.Tensor, topk: int, logits=None):
    """Top-k routing of ``x2d[T, D]``: (gate weights ``[T, k]`` float32, expert ids ``[T, k]``).

    ``jax.lax.top_k`` returns the lower index first among equal logits;
    ``torch.topk`` promises no order among them, so the ids come from a
    stable descending sort. ``logits`` (``[T, E]``), where given, are the
    router's on ``x2d``.
    """
    if logits is None:
        logits = router_logits(x2d, router)
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
    grad = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    if a.is_cuda and not grad:
        return torch.bmm(a, b, out_dtype=F32)
    # the host has no float32-result product of bfloat16 operands, and the
    # training forward does not rely on that product's backward: the same
    # products of the same (exactly widened) values, summed in float32
    with full_f32():
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


def _combine(gates: torch.Tensor, topi: torch.Tensor, e: int) -> torch.Tensor:
    """The ``[T, E]`` combine matrix of the top-k gates: one add per (token, chosen
    expert) onto zero, so the accumulation is exact, as the reference's .at[].add."""
    t = gates.shape[0]
    combine = torch.zeros((t, e), dtype=F32, device=gates.device)
    rows = torch.arange(t, device=gates.device)[:, None].expand(t, topi.shape[1])
    return combine.index_put((rows, topi), gates, accumulate=True)


def moe_dense(p: dict, x2d: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Every expert on every token ``x2d[T, D]``, combined by the top-k gates."""
    return _dense(p, x2d, cfg, *router_gates(x2d, p["router"], cfg.topk))


def _dense(p: dict, x2d: torch.Tensor, cfg: ArchConfig, gates: torch.Tensor,
           topi: torch.Tensor) -> torch.Tensor:
    t, d = x2d.shape
    e = cfg.n_experts
    combine = _combine(gates, topi, e)
    h = x2d[None].expand(e, t, d)
    y = _expert_ffn(h, p["we1"], p.get("we3"), p["we2"], cfg.mlp_kind)  # [E, T, D]
    with full_f32():
        return torch.einsum("etd,te->td", y.to(F32), combine).to(x2d.dtype)


def _ep_slots(e_flat: torch.Tensor) -> torch.Tensor:
    """Each choice's rank among the choices of the same expert, in token order:
    a stable argsort and ``searchsorted``, as the reference computes it."""
    n = e_flat.shape[0]
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    start = torch.searchsorted(e_sorted, e_flat, side="left")
    rank_sorted = torch.arange(n, device=e_flat.device) - start[order]
    slot = torch.zeros(n, dtype=torch.int64, device=e_flat.device)
    slot[order] = rank_sorted
    return slot


def ep_dispatch(x_loc: torch.Tensor, router: torch.Tensor, cfg: ArchConfig,
                n_shards: int, logits: torch.Tensor | None = None) -> dict:
    """The routing of ``x_loc[t, D]`` for the expert exchange over ``n_shards``
    ranks, per (token, choice) in token-major order ``[t * k]``: the gate, the
    token, the destination rank, the local expert there and the slot in its
    bucket; the capacity; and the drop mask (slots at or past the capacity).
    ``logits``, where given, are the router's on ``x_loc``."""
    t = x_loc.shape[0]
    k, e = cfg.topk, cfg.n_experts
    e_loc = e // n_shards
    cap = max(8, int(math.ceil(t * k / e * cfg.moe_capacity_factor)))
    gates, topi = router_gates(x_loc, router, k, logits)
    e_flat = topi.reshape(-1)
    slot = _ep_slots(e_flat)
    return {"gates": gates.reshape(-1),
            "token": torch.arange(t, device=x_loc.device).repeat_interleave(k),
            "dst": e_flat // e_loc, "local": e_flat % e_loc, "slot": slot, "cap": cap,
            "dropped": slot >= cap}


def _moe_ep_local(x_loc: torch.Tensor, router, we1, we3, we2, *, cfg: ArchConfig, group,
                  n_shards: int, logits: torch.Tensor | None = None) -> torch.Tensor:
    """The exchange on one rank: ``x_loc[t, D]`` routed, sent to the ranks holding
    the chosen experts, run through this rank's experts ``we*[E_loc, ...]`` and
    combined back. Returns ``[t, D]`` in ``x_loc``'s dtype."""
    d = x_loc.shape[1]
    e_loc = cfg.n_experts // n_shards
    r = ep_dispatch(x_loc, router, cfg, n_shards, logits)
    cap, keep = r["cap"], ~r["dropped"]
    # every choice writes a row of the flat send buffer: a kept one its (dst, local,
    # slot), a dropped one the trash row past the end, which is cut off. No shape
    # depends on the routing, so nothing waits for the device.
    trash = n_shards * e_loc * cap
    flat = torch.where(keep, (r["dst"] * e_loc + r["local"]) * cap + r["slot"], trash)
    send = torch.zeros((trash + 1, d), dtype=x_loc.dtype, device=x_loc.device)
    send = send.index_put((flat,), x_loc[r["token"]])[:trash].view(n_shards, e_loc, cap, d)
    recv = collectives.all_to_all(send, group)  # [source rank, E_loc, cap, D]
    h = recv.transpose(0, 1).reshape(e_loc, n_shards * cap, d)
    y = _expert_ffn(h, we1, we3, we2, cfg.mlp_kind)
    y = y.reshape(e_loc, n_shards, cap, d).transpose(0, 1)
    back = collectives.all_to_all(y, group)  # each choice's output at (dst, local, slot)
    contrib = back[r["dst"], r["local"], torch.clamp(r["slot"], max=cap - 1)]
    contrib = contrib * r["gates"][:, None].to(x_loc.dtype)
    contrib = torch.where(keep[:, None], contrib, torch.zeros_like(contrib))
    return torch.zeros_like(x_loc).index_add(0, r["token"], contrib)


def _leading(w) -> int:
    return (w.codes if isinstance(w, PackedWeight) else w).shape[0]


def moe_ep(p: dict, x2d: torch.Tensor, cfg: ArchConfig, pctx) -> torch.Tensor:
    """Expert-parallel MoE of this rank's tokens ``x2d[T, D]`` (the same on every
    rank of the model axis) with this rank's expert shard ``p["we*"][E / m, ...]``
    (``m`` the model axis's size; a packed stack sharded on the expert dim).

    The tokens are split over the model axis when they divide (each rank routes
    ``T / m`` of them; the outputs are gathered back), else every rank routes
    all of them, as the reference's divisibility choice does. The reference
    makes that choice on the global token count over the batch and model axes;
    the port's tokens are already the rank's batch slice (or all of them where
    the batch does not divide), so the choice left is the model axis's.
    """
    m = pctx.model_size
    if cfg.n_experts % m:
        raise ValueError(f"{cfg.n_experts} experts do not divide over a model axis of {m}")
    if p.get("we3") is None:
        raise ValueError("the expert-parallel MoE assumes gated (swiglu) experts")
    for name in ("we1", "we3", "we2"):
        if _leading(p[name]) * m != cfg.n_experts:
            raise ValueError(f"{name} holds {_leading(p[name])} experts; this rank's shard "
                             f"of {cfg.n_experts} over {m} is {cfg.n_experts // m}")
    group = pctx.model_group
    t = x2d.shape[0]
    split = m > 1 and t % m == 0 and t >= m
    x_loc = x2d.chunk(m, dim=0)[pctx.model_rank] if split else x2d
    out = _moe_ep_local(x_loc, p["router"], p["we1"], p["we3"], p["we2"], cfg=cfg, group=group,
                        n_shards=m)
    return collectives.all_gather(out, 0, group) if split else out


def moe_tp(p: dict, inp, cfg: ArchConfig, pctx) -> tuple[torch.Tensor, str]:
    """The MoE FFN of one layer under tensor parallelism (a model axis of more than
    one rank) on the rows of ``inp`` (a :class:`~repro_torch.models.layers.TPInput`):
    ``(y [B, S, D], form)`` as :func:`~repro_torch.models.layers.tp_matmul`'s.

    The router is column-parallel (its expert logits gathered whole before the
    top-k). ``moe_impl="ep"``: :func:`moe_ep`'s exchange over the expert-sharded
    stacks, each rank routing its share of the tokens; ``"dense"``: each rank
    runs its own experts on every token, weighed by their gates, and the
    ranks' float32 sums are summed (every expert on every rank where the
    experts do not divide)."""
    x = inp.entry()
    b, s, d = x.shape
    e = cfg.n_experts
    m, mr, group = pctx.model_size, pctx.model_rank, pctx.model_group
    y, form = tp_matmul(inp, p["router"], d, e, pctx, f32=True)
    logits = tp_full(y, form, pctx, F32).reshape(b * s, e)
    e_loc = _leading(p["we1"])
    if pctx.moe_impl == "ep":
        if e_loc * m != e or p.get("we3") is None:
            raise ValueError(f"the expert-parallel MoE takes gated experts sharded over the "
                             f"model axis; this rank holds {e_loc} of {e}")
        x2d, t = x.reshape(b * s, d), b * s
        split = t % m == 0 and t >= m
        if not split and torch.is_grad_enabled():
            raise ValueError(f"{t} tokens do not split over a model axis of {m} ranks: a "
                             "training step through moe_ep would run each token on every rank")
        rows = (mr * t // m, (mr + 1) * t // m) if split else (0, t)
        out = _moe_ep_local(x2d[rows[0]:rows[1]], p["router"], p["we1"], p["we3"], p["we2"],
                            cfg=cfg, group=group, n_shards=m,
                            logits=tp_take(logits, 0, rows[0], rows[1], pctx))
        if split:
            out = collectives.gather_from_model(out, 0, group)
        return out.reshape(b, s, d), "full"
    if e_loc == e:  # the experts replicate: every rank computes the whole FFN
        xf = inp.full().reshape(b * s, d)
        gates, topi = router_gates(xf, p["router"], cfg.topk, logits)
        return _dense(p, xf, cfg, gates, topi).reshape(b, s, d), "full"
    gates, topi = router_gates(x.reshape(b * s, d), p["router"], cfg.topk, logits)
    combine = _combine(gates, topi, e)
    lo = mr * e_loc
    local = tp_take(combine, 1, lo, lo + e_loc, pctx)
    x2d = x.reshape(b * s, d)
    h = x2d[None].expand(e_loc, b * s, d)
    ye = _expert_ffn(h, p["we1"], p.get("we3"), p["we2"], cfg.mlp_kind)  # [E_loc, T, D]
    with full_f32():
        return torch.einsum("etd,te->td", ye.to(F32), local).reshape(b, s, d), "partial"


def moe_apply(p: dict, x2d: torch.Tensor, cfg: ArchConfig, pctx=None) -> torch.Tensor:
    """The MoE FFN of one layer on ``x2d[T, D]``: :func:`moe_ep` under a context
    whose ``moe_impl`` is ``"ep"``, else :func:`moe_dense`."""
    if pctx is not None and pctx.moe_impl == "ep":
        return moe_ep(p, x2d, cfg, pctx)
    return moe_dense(p, x2d, cfg)


def load_balance_loss(x2d: torch.Tensor, router: torch.Tensor, topk: int,
                      n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary load-balancing loss: ``n_experts * sum(f * P) / topk``,
    ``f`` the fraction of top-k choices per expert, ``P`` the mean router probability."""
    with full_f32():
        logits = torch.matmul(x2d.to(F32), router.to(F32))
    probs = torch.softmax(logits, dim=-1)
    topi = torch.sort(logits, dim=-1, descending=True, stable=True)[1][:, :topk]
    f = torch.mean(F.one_hot(topi, n_experts).to(F32).sum(1), dim=0)
    return n_experts * torch.sum(f * torch.mean(probs, dim=0)) / topk

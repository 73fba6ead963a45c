"""LM serving: the continuous-batching ``ServeEngine`` and lockstep ``static_generate``.

The port of the JAX package's ``repro/serve/engine.py``. Requests are
admitted into SLOTS of one persistent KV cache; each slot tracks its own
position, and one decode step advances every live slot at once. A
finished request's slot is reusable at once: no re-prefill of live slots,
no padding of short prompts to the batch maximum.

The cache comes in two layouts. ``kv_cache="dense"`` is the
``[L, n_slots, max_len, KV, hd]`` stripe-per-slot tensor.
``kv_cache="paged"`` is a pool of fixed-size pages addressed through a
host-authoritative per-slot page table
(:class:`repro_torch.serve.paging.PageTable`): K/V optionally stored as
int8 codes against static per-(layer, head) scales
(:func:`repro_torch.calib.runner.calibrate_kv_cache`), and admissions
whose prompt prefix matches an indexed page chain reference those pages
copy-on-write style, so a shared system prompt is prefilled once and only
each request's suffix after it.

Correctness invariants (held by ``tests/test_torch_serve_engine.py`` and
``tests/test_torch_paging.py`` against the JAX package):

  * **slot isolation** — decode-step cache writes are per row
    (``transformer._cache_set`` with a ``[B]`` position, or
    ``_cache_set_paged`` through each row's page-table row);
  * **mask-past-pos** — attention reads ``kpos <= pos[slot]``, so a reused
    slot's stale entries are never attended: every position ``<= pos``
    has been written by the current request;
  * **token parity** — greedy continuous output is token-identical to
    per-request static generation, and the quantized paged engine to the
    dense static-int8 ``static_generate(kv_scales=...)``.

The port runs eagerly: each step builder returns a plain function on
tensors where the JAX package returns a jit, and the KV cache is written
in place. The step loop keeps the greedy tokens on the device (the argmax
runs there; requests hold lazy ``(tensor, index)`` entries resolved when
the tokens are fetched) and sends positions and page tables through
pinned non-blocking copies, so a plain decode step does not wait for the
card. A speculative round fetches its ``[B]`` acceptance vector once, as
the JAX package's does. Packed weights are consumed as codes: on the card
the block matmuls run the decode-step kernel at M <= 256 rows and the
tiled kernel above, a dense admission's attention the flash kernel.

Each decode step's wall clock feeds a
:class:`repro_torch.runtime.straggler.StragglerMonitor`. Observability:
``metrics=Registry(enabled=True)`` records TTFT/ITL histograms, queue and
slot gauges, speculative round distributions and modeled Table II energy
per emitted token (:mod:`repro_torch.core.energy`); ``trace=TraceLog(...)``
logs per-request span events; ``profile=ProfileHook(dir, n)`` captures a
``torch.profiler`` trace around the first ``n`` decode dispatches. All
three default to off.

The engine serves the ``dense``, ``moe`` and ``vlm`` families (an MoE
model through the dense MoE form, :func:`repro_torch.models.moe.moe_dense`,
as the JAX package serves it without a mesh); frontend (``vlm``) prompts
and the recurrent and enc-dec families (``ssm``, ``hybrid``, ``encdec``,
``audio``: their state is not a KV cache of slot rows) take
:func:`static_generate`, as in the JAX package.

Meshes: ``mesh="auto"`` lays an elastic mesh
(:func:`repro_torch.runtime.elastic.make_mesh`, the model axis' target 16
halved until it divides the rank count) over a process group of more than
one rank, as the JAX package does over more than one device, and serves
without one otherwise; a ``DeviceMesh`` is taken as given. Under a mesh
every model call runs with the setup's
:class:`~repro_torch.models.context.ParallelCtx`: an MoE model through the
expert-parallel exchange (``moe_impl`` defaults to ``"ep"``), every family's
products split over the model axis (each family's state laid out by its
``ModelApi.tp_cache``: the KV heads, mamba2's conv channels and SSD heads, the
hybrid's recurrence channels and ring heads), and with ``flash_decode=True`` each
decode step's attention through
:func:`~repro_torch.models.flash_decode.flash_decode_attention` over the
cache's sequence (on a model axis that splits the heads, a dense cache holds
every KV head for the rank's block of the positions:
:func:`repro_torch.models.transformer.tp_cache`). :func:`static_generate`
runs over a mesh of any number of ranks, SPMD, one process a rank: each rank
takes its block of the batch over the data axes and its blocks of the
parameters under the sharding rules, the logits are whole on every model
rank, so every rank picks the same tokens, and the ranks' tokens are
gathered whole at the end. Without a mesh ``flash_decode`` has nothing to
shard and changes nothing, as in the JAX package.

The engine over a mesh is SPMD too, where the JAX engine is one controller
over every device. Every rank receives the same ``submit`` calls in the same
order (a sampled request's ``torch.Generator`` seeded alike on each), and
its scheduler and page table decide alone: host-side and deterministic, they
take the same decisions on every rank. :func:`~repro_torch.runtime.
collectives.agree` checks that once a step, before any model call: each
rank's digest of its schedule (the step counter, the queue, the admitted
(request, slot) pairs, positions, page rows and free lists) must be equal
on every rank, or the step raises :class:`ScheduleDisagreement`. Each rank
holds its slots' rows of the cache (:meth:`ServeSetup.rows`) and its blocks
of both weight tiers. A dense admission prefills on the data group that
holds the slot's row, on every model rank of it; a paged pool is whole on
every data group (the reference's paged rule shards no page dim, and a
shared prefix page may serve a slot of any group), so a paged admission
prefills on every rank and has its logits there. A dense admission's logits
are summed over the row axes from the group that holds the row, so every
rank selects the same first token. Decode steps, drafts and verify rounds run on every rank over its
rows, and the tokens (a verify round's also its acceptance) are gathered
over the row axes before anything reads them: the requests' outputs,
sampled selection, the ngram table and pending tokens, speculative widths,
:meth:`ServeEngine.result`. A greedy step still waits for the card only in
the agreement.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.core.energy import lm_token_energy
from repro_torch.device import host_to_device
from repro_torch.models import get_model
from repro_torch.models.context import ParallelCtx, axes_group, axes_index, axes_size
from repro_torch.models.layers import tp_active
from repro_torch.obs.metrics import NULL_REGISTRY, Registry
from repro_torch.obs.trace import ProfileHook, TraceLog
from repro_torch.runtime import collectives
from repro_torch.runtime import sharding as shr
from repro_torch.runtime.elastic import reshard
from repro_torch.runtime.sharding import spec_axes
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.serve.scheduler import Request, SlotScheduler

# Families the slot engine drives: the transformer cache contract and
# token-only prompts (frontend requests and the recurrent and enc-dec
# families take static_generate).
ENGINE_FAMILIES = ("dense", "moe", "vlm")


class ScheduleDisagreement(RuntimeError):
    """The ranks of an engine's mesh took different scheduling decisions (their
    schedule digests differ): they did not all receive the same ``submit`` calls
    in the same order."""


def _resolve_mesh(mesh, device=None, target_model: int = 16):
    """``"auto"``: an elastic mesh over the default process group when it has more
    than one rank (:func:`repro_torch.runtime.elastic.make_mesh` on ``device``'s
    type), else None, as the JAX package does over its devices; a mesh or None
    as given."""
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f'mesh is "auto", a DeviceMesh or None, got {mesh!r}')
        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() < 2:
            return None
        from repro_torch.runtime.elastic import make_mesh

        return make_mesh(target_model=target_model, device=device)
    return mesh


@dataclasses.dataclass(frozen=True)
class ServeSetup:
    """Static serving configuration: the mesh, the cache geometry and its storage.

    ``page_size=0`` keeps the dense ``[L, B, max_len, KV, hd]`` layout;
    ``kv_bits=8`` stores int8 codes against static per-(layer, head)
    scales. ``mesh`` (a ``DeviceMesh`` or None) carries the model calls'
    :meth:`pctx`; ``moe_impl`` (``"ep"`` or ``"dense"``) and
    ``flash_decode`` take effect only over a mesh, as in the JAX package.
    ``batch`` is the whole batch; each rank serves its :meth:`rows`.
    """

    cfg: ArchConfig
    mesh: object | None
    max_len: int
    batch: int
    moe_impl: str = "ep"
    flash_decode: bool = False
    page_size: int = 0
    kv_bits: int = 0

    def __post_init__(self) -> None:
        if self.moe_impl not in ("ep", "dense"):
            raise ValueError(f'moe_impl is "ep" or "dense", got {self.moe_impl!r}')
        if self.kv_bits not in (0, 8):
            raise ValueError(f"kv_bits is 0 (model dtype) or 8 (static int8), got {self.kv_bits}")

    def pctx(self) -> ParallelCtx | None:
        """The model calls' parallel context: None without a mesh."""
        if self.mesh is None:
            return None
        return ParallelCtx(mesh=self.mesh, batch_axes=shr.batch_axes(self.mesh),
                           model_axis="model", moe_impl=self.moe_impl,
                           flash_decode=self.flash_decode)

    def row_axes(self) -> tuple[str, ...]:
        """The mesh axes that split the batch into :meth:`rows` (the rule of
        ``sharding.input_spec``): none without a mesh or where they hold one rank."""
        if self.mesh is None:
            return ()
        axes = spec_axes(shr.input_spec((self.batch,), self.mesh)[0])
        return axes if axes_size(self.mesh, axes) > 1 else ()

    def rows(self) -> tuple[int, int]:
        """``[start, stop)``: this rank's rows of the batch, its block over the batch
        axes where the batch divides them (the rule of ``sharding.input_spec``)."""
        axes = self.row_axes()
        if not axes:
            return 0, self.batch
        n, i = axes_size(self.mesh, axes), axes_index(self.mesh, axes)
        return i * self.batch // n, (i + 1) * self.batch // n

    def gather_rows(self, out: torch.Tensor) -> torch.Tensor:
        """The whole batch's ``out`` from each rank's rows (:meth:`rows`)."""
        axes = self.row_axes()
        if not axes:
            return out
        return collectives.all_gather(out, 0, axes_group(self.mesh, axes))

    def from_owner(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of one row on every rank: the ranks that hold the row (:meth:`rows`)
        give it, every other rank zeros of its shape, summed over :meth:`row_axes`
        (so exactly the holders' values)."""
        axes = self.row_axes()
        if not axes:
            return t
        return collectives.all_reduce(t.clone(), axes_group(self.mesh, axes))

    def layout(self, params, cache):
        """``(params, cache)`` laid out on the mesh: the parameters resharded by the
        sharding rules, the cache (made for this rank's rows) in its family's
        layout on a model axis of more than one rank (``ModelApi.tp_cache``: this
        rank's KV heads, or its blocks of a recurrent state); as given without a
        mesh."""
        if self.mesh is None:
            return params, cache
        params = reshard(params, self.mesh, shr.param_specs(params, self.mesh))
        pctx = self.pctx()
        if tp_active(pctx):
            cache = get_model(self.cfg).tp_cache(cache, self.cfg, pctx)
        return params, cache


# ---------------------------------------------------------------------------
# Step builders: plain functions on tensors (the JAX package jits these)
# ---------------------------------------------------------------------------
def build_serve_fns(setup: ServeSetup, api=None):
    """The (prefill, decode) pair of a whole-batch serving step.

    ``prefill(params, batch, cache)`` fills the cache with the prompt;
    ``decode(params, token, cache, pos)`` advances one token, ``pos`` a
    scalar (static lockstep batch) or a ``[batch]`` vector of per-slot
    positions (continuous batching).
    """
    api = api or get_model(setup.cfg)
    cfg, pctx = setup.cfg, setup.pctx()

    def prefill_fn(params, batch, cache):
        return api.prefill(params, cfg, batch, cache, pctx=pctx)

    def decode_fn(params, token, cache, pos):
        return api.decode_step(params, cfg, token, cache, pos, pctx=pctx)

    return prefill_fn, decode_fn


def build_slot_prefill(setup: ServeSetup, api=None):
    """Admission step of the dense cache: prefill ONE request into ONE slot.

    ``prefill_slot(params, tokens[1, S], cache, slot)`` runs the prompt
    pass on a batch-1 view of the slot's cache row (written in place, so
    the other slots are untouched) and returns the prompt's last-position
    logits ``[1, V]`` and the cache.
    """
    api = api or get_model(setup.cfg)
    cfg, pctx = setup.cfg, setup.pctx()

    def prefill_slot(params, tokens, cache, slot):
        slot = int(slot)
        row = {k: v[:, slot:slot + 1] for k, v in cache.items()}
        logits, _ = api.prefill(params, cfg, {"tokens": tokens}, row, pctx=pctx)
        return logits[:, -1], cache

    return prefill_slot


def build_paged_prefill(setup: ServeSetup, api=None):
    """Admission step of the PAGED cache.

    ``prefill_slot(params, tokens[1, s], cache, pos0[1]) -> (logits[1, V],
    cache)`` runs the prompt *suffix* (the tokens past the shared prefix
    the page table matched) as one causal run through ``decode_step`` at
    position ``pos0``, writing K/V through the batch-1 ``pages`` row the
    engine puts in ``cache`` for the admitted slot.
    """
    api = api or get_model(setup.cfg)
    cfg, pctx = setup.cfg, setup.pctx()

    def prefill_slot(params, tokens, cache, pos0):
        logits, cache = api.decode_step(params, cfg, tokens, cache, pos0, pctx=pctx)
        return logits[:, -1], cache

    return prefill_slot


def _argmax_tokens(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def build_greedy_decode(setup: ServeSetup, api=None):
    """A decode step fused with greedy selection.

    ``decode_greedy(params, token, cache, pos) -> (next_token[B, 1], cache)``:
    the argmax runs on the device, so the engine's greedy loop never fetches
    a logits tensor and steps chain without a host sync.
    """
    api = api or get_model(setup.cfg)
    cfg, pctx = setup.cfg, setup.pctx()

    def decode_greedy(params, token, cache, pos):
        logits, cache = api.decode_step(params, cfg, token, cache, pos, pctx=pctx)
        return _argmax_tokens(logits[:, -1])[:, None], cache

    return decode_greedy


def build_draft_run(setup: ServeSetup, api=None):
    """The W-step speculative draft loop.

    ``draft(params, token[B, 1], cache, pos[B], width) -> (run, cache)``
    chains ``width`` greedy single-token decode steps of the DRAFT tier (a
    Python loop where the JAX package scans). ``run[B, width]`` is the
    token fed at each step, ``[pending, d1 .. d_{width-1}]``, the verify
    step's input; the last step's output is discarded (that step writes
    the draft K/V at ``pos + width - 1``, so a fully accepted round leaves
    no hole in the draft cache).
    """
    api = api or get_model(setup.cfg)
    cfg, pctx = setup.cfg, setup.pctx()

    def draft(params, token, cache, pos, width):
        fed, tok = [], token
        for j in range(int(width)):
            fed.append(tok)
            logits, cache = api.decode_step(params, cfg, tok, cache, pos + j, pctx=pctx)
            tok = _argmax_tokens(logits[:, -1])[:, None]
        return torch.cat(fed, dim=1), cache

    return draft


def build_verify_step(setup: ServeSetup, api=None):
    """The speculative verify step.

    ``verify(params, tokens[B, W], cache, pos[B]) -> (vtok, acc, ptok,
    cache)`` runs ONE forward over a W-token run per row (row ``b``'s
    tokens at ``pos[b] .. pos[b] + W - 1``, causal within the run):

      * ``vtok[B, W]``: the verify tier's greedy token after each input
        position;
      * ``acc[B]``: ``1 +`` the length of the matched drafted prefix
        (``tokens[:, 1:]`` against ``vtok[:, :-1]``), in ``1..W``;
      * ``ptok[B, 1]``: ``vtok[b, acc[b] - 1]``, the next round's pending
        input.

    All three stay on the device.
    """
    api = api or get_model(setup.cfg)
    cfg, pctx = setup.cfg, setup.pctx()

    def verify(params, tokens, cache, pos):
        logits, cache = api.decode_step(params, cfg, tokens, cache, pos, pctx=pctx)
        vtok = _argmax_tokens(logits)  # [B, W]
        match = (tokens[:, 1:] == vtok[:, :-1]).to(torch.int32)
        acc = (1 + torch.cumprod(match, dim=-1).sum(dim=-1)).to(torch.int32)
        ptok = torch.gather(vtok, 1, (acc[:, None] - 1).long())
        return vtok, acc, ptok, cache

    return verify


# ---------------------------------------------------------------------------
# Static lockstep path
# ---------------------------------------------------------------------------
def static_generate(
    setup: ServeSetup,
    params,
    batch: dict,
    max_new_tokens: int,
    *,
    greedy: bool = True,
    generator: torch.Generator | None = None,
    kv_scales=None,
) -> torch.Tensor:
    """Greedy or sampled generation for a static (lockstep) batch of prompts.

    One whole-batch prefill of ``batch["tokens"] [B, S]``, then
    ``max_new_tokens - 1`` lockstep decode steps; returns the new tokens
    ``[B, max_new_tokens]`` (int32). Kept as the per-request reference the
    engine's token-parity tests compare against and as the path for
    sampled whole-batch generation. ``kv_scales`` (calibrated
    ``([L, KV], [L, KV])``) or ``setup.kv_bits=8`` switches the cache to
    the dense static-int8 layout, the quantized reference of the paged
    engine. A ``vlm`` batch may carry ``"frontend"`` patch embeddings
    ``[B, F, D]``: they fill the cache's first ``F`` positions, and decoding
    starts after them. An ``encdec``/``audio`` batch carries ``"frontend"``
    frame embeddings ``[B, S_enc, D]`` for the encoder: the state is
    ``(cache, enc_out)`` and decoding starts after the prompt's tokens. The
    recurrent families carry their own state (mamba2's conv window and SSD
    state; rglru's recurrent state and ring) from the prefill through
    every step. Sampling (``greedy=False`` with a ``generator``)
    draws from the ``torch.Generator``, whose bits are not ``jax.random``'s.
    Under ``setup.mesh`` (every rank of it calls this, on the whole batch and
    the whole parameters) each rank takes its rows (:meth:`ServeSetup.rows`)
    and its blocks of the parameters (:meth:`ServeSetup.layout`), every model
    call runs with the setup's parallel context, and the ranks' tokens come
    back whole. Sampling under a model axis of more than one rank needs the
    same ``generator`` state on each of its ranks.
    """
    cfg = setup.cfg
    api = get_model(cfg)
    device = params["embed"].device
    if setup.kv_bits and kv_scales is None:
        raise ValueError("kv_bits=8 stores int8 codes against calibrated scales: pass kv_scales")
    lo, hi = setup.rows()
    batch = {k: torch.as_tensor(v)[lo:hi] if k in ("tokens", "frontend") else v
             for k, v in batch.items()}
    if kv_scales is not None:
        cache = api.init_cache(cfg, hi - lo, setup.max_len, kv_scales=kv_scales, device=device)
    else:
        cache = api.init_cache(cfg, hi - lo, setup.max_len, device=device)
    tokens = batch["tokens"].to(device)
    params, cache = setup.layout(params, cache)
    prefill_fn, decode_fn = build_serve_fns(setup, api)
    logits, cache = prefill_fn(params, {**batch, "tokens": tokens}, cache)
    pos = tokens.shape[1] + (
        batch["frontend"].shape[1] if cfg.family == "vlm" and "frontend" in batch else 0)
    out = [_pick(logits, greedy, generator)]
    for i in range(max_new_tokens - 1):
        logits, cache = decode_fn(params, out[-1], cache, pos + i)
        out.append(_pick(logits, greedy, generator))
    return setup.gather_rows(torch.cat(out, dim=1))


def _pick(logits: torch.Tensor, greedy: bool, generator: torch.Generator | None) -> torch.Tensor:
    """The next token ``[B, 1]`` (int32): argmax, or a draw from the softmax with ``generator``."""
    if greedy or generator is None:
        return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    probs = torch.softmax(logits[:, -1].to(torch.float32), dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


def batch_generate(
    cfg: ArchConfig,
    params,
    batch: dict,
    max_new_tokens: int,
    *,
    mesh=None,
    max_len: int | None = None,
    greedy: bool = True,
    generator: torch.Generator | None = None,
    flash_decode: bool = False,
    draft_params: Any = None,
    spec_k: int = 0,
    spec_draft: str = "model",
) -> torch.Tensor:
    """Generate for a batch of same-length prompts: the one routing point
    between the engine and the static loop.

    Greedy, generator-free, token-only calls for an engine family go
    through :class:`ServeEngine` (one slot per row); sampled generation
    (the whole-batch stream) and frontend batches take
    :func:`static_generate`. ``spec_k`` (speculative decoding) needs the
    engine. ``mesh`` and ``flash_decode`` go to either. Returns
    ``[B, max_new_tokens]`` int32 on the params' device.
    """
    tokens = batch["tokens"]
    b, s = tokens.shape
    if max_len is None:
        max_len = s + max_new_tokens + (cfg.frontend_tokens or 0)
    engine_ok = (greedy and generator is None and cfg.family in ENGINE_FAMILIES
                 and not cfg.frontend_tokens and "frontend" not in batch)
    if (draft_params is not None or spec_k) and not engine_ok:
        raise ValueError(
            "speculative decoding runs on the slot engine, which takes greedy "
            "generator-free token-only requests for transformer families; this call "
            f"(greedy={greedy}, generator={'set' if generator is not None else None}, "
            f"family={cfg.family!r}) falls back to the static loop, which has no "
            "draft/verify path"
        )
    device = params["embed"].device
    if engine_ok:
        eng = ServeEngine(cfg, params, n_slots=b, max_len=max_len, mesh=mesh,
                          flash_decode=flash_decode, draft_params=draft_params, spec_k=spec_k,
                          spec_draft=spec_draft)
        host = torch.as_tensor(tokens).cpu().numpy()
        outs = eng.serve([(host[i], max_new_tokens) for i in range(b)])
        return torch.from_numpy(np.stack(outs)).to(device)
    setup = ServeSetup(cfg=cfg, mesh=_resolve_mesh(mesh), max_len=max_len, batch=b,
                       flash_decode=flash_decode)
    return static_generate(setup, params, batch, max_new_tokens, greedy=greedy,
                           generator=generator)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
def _agreement_group(mesh):
    """The process group over every rank of ``mesh`` that checks the engine's
    schedule: the default group when the mesh spans it (its timeout is the
    caller's), else one over the mesh's axes."""
    ranks = sorted(int(r) for r in mesh.mesh.reshape(-1).tolist())
    if ranks == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return axes_group(mesh, tuple(mesh.mesh_dim_names))


class ServeEngine:
    """Slot-based continuous-batching server for decoder LMs.

    Args:
      cfg: the architecture (the ``dense``, ``moe`` or ``vlm`` family; token-only
        requests).
      params: float or packed parameter tree, on the device it serves on.
        Packed trees are consumed as they are: the block matmuls read
        uint8 ELP_BSD codes.
      n_slots: concurrent requests = batch rows of the persistent cache.
      max_len: per-slot cache capacity (prompt + generated); a request
        reaching it is finished early and flagged ``truncated``.
      mesh: ``"auto"`` (an elastic mesh over a process group of more than one
        rank, else none), a ``DeviceMesh``, or None. Over a mesh of more than
        one rank every rank makes the engine and receives the same calls.
      target_model: the model axis' target size of the ``"auto"`` mesh.
      flash_decode: under a mesh, decode attention over the sequence-sharded
        cache (:func:`~repro_torch.models.flash_decode.flash_decode_attention`).
      moe_impl: under a mesh, ``"ep"`` (the expert exchange, default) or
        ``"dense"``.
      kv_cache: ``"dense"`` (default) or ``"paged"``, the page pool with
        copy-on-write prefix sharing.
      page_size: tokens per page for ``kv_cache="paged"`` (default 16).
      kv_bits: 8 to store the paged pool as int8 codes against static
        calibrated scales (0 = model dtype). Needs ``kv_cache="paged"`` and
        ``kv_scales``; inferred as 8 when ``kv_scales`` is passed alone.
      kv_scales: the calibrated ``(k_scale, v_scale)`` pair, each
        ``[L, KV]`` float32
        (:func:`repro_torch.calib.runner.calibrate_kv_cache`).
      monitor: a :class:`StragglerMonitor` (one is created by default);
        every decode step's wall clock is recorded.
      draft_params: a second (low-bit) tier of the same checkpoint. With
        ``spec_k`` and ``spec_draft="model"`` the engine decodes
        speculatively: the draft tier drafts ``W - 1`` tokens a round,
        then ``params`` (the VERIFY tier, which defines the output) checks
        the whole run in one ``W``-wide forward. Output is token-identical
        to serving ``params`` alone.
      spec_k: speculative verify width ``W >= 2``; 0 disables.
      spec_draft: ``"model"`` (drafts from ``draft_params``) or ``"ngram"``
        (drafts by replaying which verified token last followed each token
        in any stream this engine produced; a round is then one verify
        forward).
      metrics: a :class:`repro_torch.obs.metrics.Registry`; ``None`` uses
        the shared disabled registry.
      trace: a :class:`repro_torch.obs.trace.TraceLog`, or ``None``.
      profile: a :class:`repro_torch.obs.trace.ProfileHook`, or ``None``.
    """

    def __init__(
        self,
        cfg: ArchConfig,
        params: Any,
        *,
        n_slots: int = 4,
        max_len: int = 512,
        mesh="auto",
        target_model: int = 16,
        flash_decode: bool = False,
        kv_cache: str = "dense",
        page_size: int = 16,
        kv_bits: int = 0,
        kv_scales: Any = None,
        moe_impl: str = "ep",
        monitor: StragglerMonitor | None = None,
        draft_params: Any = None,
        spec_k: int = 0,
        spec_draft: str = "model",
        metrics: Registry | None = None,
        trace: TraceLog | None = None,
        profile: ProfileHook | None = None,
    ):
        if cfg.family not in ENGINE_FAMILIES:
            raise ValueError(
                f"ServeEngine drives the transformer cache contract (families "
                f"{ENGINE_FAMILIES}); {cfg.family!r} archs serve through static_generate"
            )
        if cfg.frontend_tokens:
            raise ValueError("ServeEngine requests are token-only; frontend prompts serve "
                             "through static_generate")
        if kv_cache not in ("dense", "paged"):
            raise ValueError(f'kv_cache must be "dense" or "paged", got {kv_cache!r}')
        self._paged = kv_cache == "paged"
        if kv_scales is not None and not kv_bits:
            kv_bits = 8
        if kv_bits and not self._paged:
            raise ValueError(
                "quantized KV cache requires kv_cache='paged'; the dense engine cache keeps "
                "the model dtype (the dense static-int8 reference runs through "
                "static_generate(kv_scales=...))"
            )
        if kv_bits and kv_bits != 8:
            raise ValueError(f"kv_bits={kv_bits}: the cache stores int8 codes, so the serving "
                             "bit-width is 8")
        if kv_bits and kv_scales is None:
            raise ValueError(
                "kv_bits without kv_scales: static cache quantization needs calibrated "
                "per-(layer, head) scales; run calibrate_kv_cache(params, cfg, token_batches) "
                "and pass the (k_scale, v_scale) pair"
            )
        self.spec_k = int(spec_k)
        self.spec_draft = str(spec_draft)
        if self.spec_draft not in ("model", "ngram"):
            raise ValueError(f'spec_draft must be "model" or "ngram", got {self.spec_draft!r}')
        if self.spec_k == 0:
            if draft_params is not None:
                raise ValueError("draft_params without spec_k: speculative serving takes the "
                                 "draft tier AND the verify width (spec_k >= 2), or neither")
        elif self.spec_k < 2:
            raise ValueError(f"spec_k is the verify width: need >= 2 (got {self.spec_k})")
        elif self.spec_draft == "model" and draft_params is None:
            raise ValueError('spec_draft="model" drafts with a second weight tier: pass '
                             'draft_params, or draft from the token history with '
                             'spec_draft="ngram"')
        elif self.spec_draft == "ngram" and draft_params is not None:
            raise ValueError('spec_draft="ngram" drafts from the verified token history, not '
                             'a weight tier: drop draft_params or use spec_draft="model"')
        self.cfg = cfg
        self.device = params["embed"].device
        dev = self.device
        self.mesh = _resolve_mesh(mesh, dev, target_model)
        self.setup = ServeSetup(
            cfg=cfg, mesh=self.mesh, max_len=max_len, batch=n_slots,
            moe_impl=moe_impl, flash_decode=flash_decode,
            page_size=int(page_size) if self._paged else 0, kv_bits=int(kv_bits),
        )
        # This rank's rows of the slots (all of them without a mesh): the dense
        # caches and the device token vector hold these rows; a paged pool is
        # whole on every rank, addressed through the rows of the page table.
        self._lo, self._hi = self.setup.rows()
        n_rows = self._hi - self._lo
        self._agree_group = None  # made at the first step (_agree)
        self._api = get_model(cfg)
        if self._paged:
            self._prefill = build_paged_prefill(self.setup, self._api)
        else:
            self._prefill = build_slot_prefill(self.setup, self._api)
        _, self._decode = build_serve_fns(self.setup, self._api)
        self._decode_greedy = build_greedy_decode(self.setup, self._api)
        scales = None
        if self._paged:
            from repro_torch.models import transformer
            from repro_torch.serve.paging import PageTable

            if kv_bits:
                scales = (torch.as_tensor(np.asarray(kv_scales[0], np.float32)),
                          torch.as_tensor(np.asarray(kv_scales[1], np.float32)))
            cache = transformer.init_paged_cache(cfg, n_slots, max_len,
                                                 page_size=self.setup.page_size,
                                                 kv_scales=scales, device=dev)
            self._pager = PageTable(n_slots, max_len, self.setup.page_size,
                                    n_pages=cache["k"].shape[1], device=dev)
        else:
            cache = self._api.init_cache(cfg, n_rows, max_len, device=dev)
            self._pager = None
        self.params, self._cache = self.setup.layout(params, cache)
        # Speculative state: the verify step runs on the target params. A
        # "model" drafter gets its own prefill/draft pair and its OWN cache
        # (a paged one maps through the same page table); an "ngram" drafter
        # gets a vocab-sized transition table and the host copy of each
        # slot's pending token.
        self.draft_params = draft_params
        if self.spec_k:
            self._verify = build_verify_step(self.setup, self._api)
            self._spec_width = self.spec_k
            if self.spec_draft == "model":
                if self._paged:
                    self._draft_prefill = build_paged_prefill(self.setup, self._api)
                    dcache = transformer.init_paged_cache(
                        cfg, n_slots, max_len, page_size=self.setup.page_size,
                        kv_scales=scales, device=dev)
                else:
                    self._draft_prefill = build_slot_prefill(self.setup, self._api)
                    dcache = self._api.init_cache(cfg, n_rows, max_len, device=dev)
                self.draft_params, self._draft_cache = self.setup.layout(draft_params, dcache)
                self._draft_run = build_draft_run(self.setup, self._api)
            else:
                self._ngram = np.full(cfg.vocab, -1, np.int32)
                self._pending = np.zeros(n_slots, np.int32)
        self.monitor = monitor or StragglerMonitor()
        # Observability: instrument handles are resolved once; a disabled
        # registry hands out shared no-op instruments. Table II energy per
        # emitted token is modeled once from the tree that serves.
        self.metrics = metrics or NULL_REGISTRY
        self.trace = trace
        self.profile = profile
        m = self.metrics
        self._m_ttft = m.histogram("serve.ttft_s")
        self._m_itl = m.histogram("serve.itl_s")
        self._m_prefill = m.histogram("serve.prefill_s")
        self._m_request = m.histogram("serve.request_s")
        self._m_queue = m.gauge("serve.queue_depth")
        self._m_live = m.gauge("serve.slots_live")
        self._m_tokens = m.counter("serve.tokens_total")
        self._m_finished = m.counter("serve.requests_finished_total")
        self._m_energy = m.counter("serve.energy_nj_total")
        self._m_pages_used = m.gauge("serve.cache.pages_used")
        self._m_pages_shared = m.gauge("serve.cache.pages_shared")
        self._m_prefix_hits = m.counter("serve.cache.prefix_hits_total")
        self.energy = lm_token_energy(cfg, params)
        self._draft_energy = (lm_token_energy(cfg, draft_params)
                              if self.spec_k and self.spec_draft == "model" else None)
        if self.spec_k:
            self._m_width = m.histogram("serve.spec.round_width", lo=1.0, growth=2.0 ** 0.25,
                                        n_buckets=24)
            self._m_acc = m.histogram("serve.spec.accepted_per_round", lo=1.0,
                                      growth=2.0 ** 0.25, n_buckets=24)
        self._sched = SlotScheduler(n_slots)
        self._requests: dict[int, Request] = {}
        self._next_rid = 0
        # Per-slot state: the next cache write position (host, every slot: the
        # scheduler needs it at once) and the last generated token of this rank's
        # rows (on the device: the greedy loop chains it from step to step
        # without fetching it).
        self._pos = np.zeros(n_slots, np.int32)
        self._tok_dev = torch.zeros((n_rows, 1), dtype=torch.int32, device=dev)
        self.steps = 0
        self._decode_steps = 0
        self._prefills = 0
        self._tokens_generated = 0
        self._completed = 0
        self._truncated = 0
        self._spec_rounds = 0
        self._tokens_drafted = 0
        self._tokens_accepted = 0

    # -- request lifecycle ---------------------------------------------------
    def submit(self, tokens, max_new_tokens: int, *, key: torch.Generator | None = None) -> int:
        """Queue one request; returns its id (results via :meth:`result`).

        Admission happens inside :meth:`step` when a slot frees up: on the
        dense cache one prompt-length prefill into the slot's row; on the
        paged cache the allocator first matches the prompt's full pages
        against the shared-prefix index, allocates private pages for the
        rest, and prefills only the unmatched suffix. ``key`` (a CPU
        ``torch.Generator``) makes the request sampled. Over a mesh every rank
        submits the same requests in the same order, a sampled one's generator
        seeded alike on each: every rank draws its tokens from the same logits.
        """
        if isinstance(tokens, torch.Tensor):
            tokens = tokens.cpu().numpy()
        prompt = np.array(tokens, np.int32).reshape(-1)
        prompt.setflags(write=False)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prompt.size + max_new_tokens > self.setup.max_len:
            raise ValueError(
                f"request needs {prompt.size} prompt + {max_new_tokens} new tokens = "
                f"{prompt.size + int(max_new_tokens)} cache positions, but the engine's "
                f"per-slot capacity is max_len={self.setup.max_len}: raise max_len or lower "
                "max_new_tokens"
            )
        if key is not None and self.spec_k:
            raise ValueError("speculative serving is greedy-only (acceptance compares argmax "
                             "streams); submit sampled requests to a non-speculative engine")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt, max_new_tokens=int(max_new_tokens), key=key)
        req.t_submit = time.perf_counter()
        self._requests[rid] = req
        self._sched.submit(req)
        if self.trace is not None:
            self.trace.event("submit", rid, prompt_len=int(prompt.size),
                             max_new=int(max_new_tokens))
        return rid

    def evict(self, rid: int) -> np.ndarray:
        """Cancel a live or queued request, freeing its slot at once; returns
        the tokens generated so far."""
        req = self._requests[rid]
        if req.done:
            return req.tokens()
        if req.slot is not None:
            slot = req.slot
            self._sched.finish(slot)
            self._pos[slot] = 0
            if self._paged:
                self._pager.release(slot)
        else:
            self._sched.cancel(req)
        req.truncated = True
        self._truncated += 1
        return req.tokens()

    def result(self, rid: int) -> np.ndarray:
        return self._requests[rid].tokens()

    def release(self, rid: int) -> np.ndarray:
        """Fetch a request's tokens AND retire its bookkeeping (:meth:`serve`
        releases every request it created)."""
        return self._requests.pop(rid).tokens()

    # -- stepping ------------------------------------------------------------
    def _tokens_in(self, prompt: np.ndarray) -> torch.Tensor:
        return host_to_device(prompt[None].astype(np.int64), self.device)

    def _set_token(self, slot: int, tok) -> None:
        """Put slot ``slot``'s pending token into a NEW device vector of this rank's
        rows (a slot of another rank's rows is not here): earlier vectors stay
        referenced by requests' lazy outputs."""
        if not self._lo <= slot < self._hi:
            return
        t = self._tok_dev.clone()
        t[slot - self._lo, 0] = tok
        self._tok_dev = t

    def _agree(self) -> None:
        """Check that every rank of the mesh holds the same schedule (the step
        counter, the scheduler's and the page table's digests, every slot's
        position): one :func:`~repro_torch.runtime.collectives.agree` a step, before
        the step's first model call. Nothing to check without a mesh of more than
        one rank."""
        if self.mesh is None or self.mesh.size() < 2:
            return
        if self._agree_group is None:
            self._agree_group = _agreement_group(self.mesh)
        from repro_torch.serve.scheduler import fingerprint

        parts = [np.asarray([self.steps], np.int64), self._sched.digest(),
                 np.asarray([fingerprint(self._pos)], np.int64)]
        if self._paged:
            parts.append(self._pager.digest(list(self._sched.live)))
        vec = torch.from_numpy(np.concatenate(parts))
        if dist.get_backend(self._agree_group) != "gloo":  # NCCL takes the card's tensors
            vec = vec.to(self.device)
        if not collectives.agree(vec, self._agree_group):
            raise ScheduleDisagreement(
                f"step {self.steps}: the ranks of the mesh {shr.mesh_shape(self.mesh)} hold "
                "different schedules (queue, admitted requests, positions or page tables); "
                "every rank must receive the same submit calls in the same order")

    def _admit(self, slot: int, req: Request) -> torch.Tensor:
        """Prefill an admitted request into its slot (both tiers under a model
        drafter); returns the prompt's last logits ``[1, V]``, the same on every
        rank. A dense admission runs where the slot's row is (:meth:`ServeSetup.rows`)
        and its holders give the logits to the other ranks; a paged one runs on
        every rank (the pool is whole on every rank), so each has its logits."""
        owned = self._lo <= slot < self._hi
        if self._paged:
            # Acquire the matched shared-prefix pages, allocate the rest, and
            # prefill only the unmatched SUFFIX as one causal run past the shared
            # tokens, through the slot's own page row.
            n_shared = self._pager.admit(slot, req.prompt)
            self._m_prefix_hits.inc(n_shared // self.setup.page_size)
            row = self._pager.to_device(slot)
            pos0 = host_to_device(np.array([n_shared], np.int64), self.device)
            suffix = self._tokens_in(req.prompt[n_shared:])
            logits, _ = self._prefill(self.params, suffix, {**self._cache, "pages": row}, pos0)
            if self.spec_k and self.spec_draft == "model":
                # the draft tier keeps its own cache in step: same prompt, same
                # slot; its logits are discarded (every emitted token comes from
                # the verify tier)
                self._draft_prefill(self.draft_params, suffix,
                                    {**self._draft_cache, "pages": row}, pos0)
            self._pager.register(slot, req.prompt)
            return logits
        if owned:
            prompt = self._tokens_in(req.prompt)
            local = slot - self._lo
            logits, self._cache = self._prefill(self.params, prompt, self._cache, local)
            if self.spec_k and self.spec_draft == "model":
                self._draft_prefill(self.draft_params, prompt, self._draft_cache, local)
        else:  # the row's holders give the logits
            logits = torch.zeros((1, self.cfg.vocab), dtype=torch.float32, device=self.device)
        return self.setup.from_owner(logits)

    def step(self) -> bool:
        """Admit queued requests into free slots, then run one decode step
        (or speculative round) for every live slot. Returns whether any work
        happened.

        Greedy steps stay on the device: selection runs there, requests log
        lazy ``(token_vector, slot)`` entries, and nothing waits for the
        card (but the agreement of a mesh's ranks). A step with any sampled
        request fetches the logits.
        """
        self._agree()
        progressed = False
        for slot, req in self._sched.ready():
            req.t_admit = time.perf_counter()
            logits = self._admit(slot, req)
            self._prefills += 1
            if req.key is None and self.spec_k and self.spec_draft == "ngram":
                # the lookup drafter chains from the pending token's VALUE
                first = int(torch.argmax(logits, dim=-1)[0])
                req.out.append(first)
                self._pending[slot] = first
            elif req.key is None:
                first = _argmax_tokens(logits)  # [1], on the device
                req.out.append((first, 0))
                self._set_token(slot, first[0])
            else:
                tok = self._select(req, logits[0].float().cpu())
                req.out.append(tok)
                self._set_token(slot, tok)
            self._tokens_generated += 1
            self._pos[slot] = req.prompt.size
            # the admission emits the request's FIRST token: this
            # dispatch-clocked timestamp is its TTFT sample
            req.t_first = time.perf_counter()
            self._m_ttft.record(req.t_first - req.t_submit)
            self._m_prefill.record(req.t_first - req.t_admit)
            self._m_tokens.inc()
            self._m_energy.inc(self.energy["total_nj"])
            if self.trace is not None:
                self.trace.event("admit", req.rid, slot=slot, prompt_len=int(req.prompt.size),
                                 prefill_s=req.t_first - req.t_admit,
                                 ttft_s=req.t_first - req.t_submit)
            self._maybe_finish(slot, req)
            progressed = True

        self._m_queue.set(self._sched.queued)
        self._m_live.set(len(self._sched.live))
        if self._paged:
            self._m_pages_used.set(self._pager.pages_used)
            self._m_pages_shared.set(self._pager.pages_shared)
        live = self._sched.live
        if live and self.spec_k:
            self._spec_round(live)
            self.steps += 1
            return True
        if live:
            pos = self._pos_in()
            n_live = len(live)  # snapshot: _maybe_finish pops from live
            cache_in = self._dispatch_cache()
            t0 = time.perf_counter()
            if all(r.key is None for r in live.values()):
                nxt, _ = self._decode_greedy(self.params, self._tok_dev, cache_in, pos)
                self._tok_dev = nxt
                every = self.setup.gather_rows(nxt)  # [n_slots, 1]: every rank's rows
                # dispatch-clocked: a host-bound step's issue time is its time
                dt = time.perf_counter() - t0
                self.monitor.record(dt)
                for slot, req in list(live.items()):
                    req.out.append((every, slot))
                    self._tokens_generated += 1
                    self._m_itl.record(dt)
                    self._pos[slot] += 1
                    self._maybe_finish(slot, req)
            else:
                logits, _ = self._decode(self.params, self._tok_dev, cache_in, pos)
                logits = self.setup.gather_rows(logits[:, -1].float()).cpu()
                dt = time.perf_counter() - t0
                self.monitor.record(dt)
                toks = np.zeros(self._sched.n_slots, np.int32)
                for slot, req in list(live.items()):
                    tok = self._select(req, logits[slot])
                    req.out.append(tok)
                    toks[slot] = tok
                    self._tokens_generated += 1
                    self._m_itl.record(dt)
                    self._pos[slot] += 1
                    self._maybe_finish(slot, req)
                self._tok_dev = host_to_device(toks[self._lo:self._hi, None], self.device)
            self._m_tokens.inc(n_live)
            self._m_energy.inc(self.energy["total_nj"] * n_live)
            if self.profile is not None:
                self.profile.step()
            if self.trace is not None:
                self.trace.event("decode", None, live=n_live, dt_s=dt)
            self._decode_steps += 1
            progressed = True
        self.steps += 1
        return progressed

    def run(self) -> None:
        """Drive :meth:`step` until queue and slots are empty."""
        while self._sched.busy:
            self.step()

    def serve(self, requests: Sequence[tuple], *,
              arrivals: Sequence[int] | None = None) -> list[np.ndarray]:
        """Serve ``[(prompt_tokens, max_new_tokens), ...]`` to completion.

        ``arrivals`` (optional, non-decreasing) holds per-request arrival
        times in engine steps relative to this call; an idle engine
        fast-forwards to the next arrival. Returns the generated tokens
        (int32 numpy) in request order.
        """
        reqs = list(requests)
        if arrivals is None:
            rids = [self.submit(t, n) for t, n in reqs]
            self.run()
            if self.profile is not None:
                self.profile.stop()
            return [self.release(r) for r in rids]
        arrivals = list(arrivals)
        if len(arrivals) != len(reqs):
            raise ValueError(f"arrivals has {len(arrivals)} entries for {len(reqs)} requests")
        if arrivals != sorted(arrivals):
            raise ValueError("arrivals must be non-decreasing (FIFO trace)")
        rids: list[int | None] = [None] * len(reqs)
        start = self.steps
        i = 0
        while i < len(reqs) or self._sched.busy:
            while i < len(reqs) and (self.steps - start >= arrivals[i] or not self._sched.busy):
                rids[i] = self.submit(*reqs[i])
                i += 1
            self.step()
        if self.profile is not None:
            self.profile.stop()
        return [self.release(r) for r in rids]

    # -- introspection -------------------------------------------------------
    def cache_stats(self) -> dict:
        """KV-cache layout, occupancy and byte costs, with the same keys for
        either layout: ``layout``, ``kv_bits``, ``page_size``, ``pages_total``,
        ``pages_used``, ``pages_shared``, ``prefix_hits`` (shared pages
        acquired by admissions), ``bytes_per_token`` (cache bytes read per
        decoded token at full context) and ``slot_bytes`` (cache bytes one
        slot holds: the dense stripe, or the average private pages per
        admission)."""
        cfg, setup = self.cfg, self.setup
        n_layers = cfg.n_dec_layers or cfg.n_layers
        elem = self._cache["k"].element_size()
        token_bytes = 2 * n_layers * cfg.n_kv_heads * cfg.hd * elem
        scale_bytes = 2 * n_layers * cfg.n_kv_heads * 4 if setup.kv_bits else 0
        if self._paged:
            pg = self._pager
            page_bytes = token_bytes * setup.page_size
            private = pg.pages_allocated / pg.admissions if pg.admissions else pg.pmax
            return {
                "layout": "paged",
                "kv_bits": setup.kv_bits,
                "page_size": setup.page_size,
                "pages_total": pg.pages_total,
                "pages_used": pg.pages_used,
                "pages_shared": pg.pages_shared,
                "prefix_hits": pg.prefix_hits,
                "bytes_per_token": token_bytes * setup.max_len + scale_bytes,
                "slot_bytes": private * page_bytes,
            }
        return {
            "layout": "dense",
            "kv_bits": 0,
            "page_size": 0,
            "pages_total": 0,
            "pages_used": 0,
            "pages_shared": 0,
            "prefix_hits": 0,
            "bytes_per_token": token_bytes * setup.max_len,
            "slot_bytes": token_bytes * setup.max_len,
        }

    def stats(self) -> dict:
        """Serving counters, the cache's :meth:`cache_stats`, the kernel routes
        and the straggler monitor's slow-step report; with metrics on, TTFT,
        ITL and request-latency percentiles; under speculative serving a
        ``"speculative"`` sub-dict (drafted/accepted counts, acceptance
        rate), also folded into the ``"straggler"`` report."""
        st = {
            "cache": self.cache_stats(),
            "steps": self.steps,
            "decode_steps": self._decode_steps,
            "prefills": self._prefills,
            "tokens_generated": self._tokens_generated,
            "requests_completed": self._completed,
            "requests_truncated": self._truncated,
            "live_slots": len(self._sched.live),
            "n_slots": self._sched.n_slots,
            "mesh": shr.mesh_shape(self.mesh) if self.mesh is not None else None,
            "energy_nj_per_token": self.energy["total_nj"],
            "kernel_dispatch": self.kernel_dispatch(),
            "straggler": self.monitor.report(),
        }
        if self.metrics.enabled:
            st["latency"] = {
                "ttft_p50_s": self._m_ttft.percentile(50),
                "ttft_p99_s": self._m_ttft.percentile(99),
                "itl_p50_s": self._m_itl.percentile(50),
                "itl_p99_s": self._m_itl.percentile(99),
                "request_p50_s": self._m_request.percentile(50),
                "request_p99_s": self._m_request.percentile(99),
            }
        if self.spec_k:
            rate = self._tokens_accepted / self._tokens_drafted if self._tokens_drafted else 1.0
            st["speculative"] = {
                "spec_k": self.spec_k,
                "drafter": self.spec_draft,
                "rounds": self._spec_rounds,
                "tokens_drafted": self._tokens_drafted,
                "tokens_accepted": self._tokens_accepted,
                "acceptance_rate": rate,
            }
            st["straggler"] = {**st["straggler"], "tokens_drafted": self._tokens_drafted,
                               "tokens_accepted": self._tokens_accepted,
                               "acceptance_rate": rate}
        return st

    def kernel_dispatch(self) -> dict:
        """Which kernel route each packed decode-step GEMM takes, and how it was chosen.

        Walks the packed leaves and resolves every distinct ``[K, N]`` GEMM
        (this rank's block of it) at ``M`` = this rank's slot rows the way
        ``models.layers.matmul`` does (:func:`repro_torch.kernels.ops.resolve_impl`):
        the autotune cache's measured winner, else the decode-step kernel at
        M <= 256 rows and the tiled one above, on the route
        :func:`repro_torch.kernels.elp_bsd_matmul.route` picks for the model's
        activation dtype on the card (``"plain"`` on the CPU). Keyed
        ``MxKxN|fmt|layout``, each value the kernel and route, how it was
        chosen and how many weights share the shape. An MoE expert stack is
        dequantized whole and multiplied by ``bmm`` (``"moe_dense/dequantize"``),
        on no kernel.

        ``source`` is the reference's report, rule for rule
        (``src/repro/serve/engine.py``): ``"structural"`` for a stacked leaf
        or a mesh of more than one rank, else ``"autotuned"`` on a cache hit
        and ``"heuristic"`` on a miss. The reference's scan slices a stacked
        leaf per layer and consults the cache there, as the port's per-layer
        call does, so ``impl`` follows the cache where ``source`` still reads
        ``"structural"`` (ROADMAP.md, reference-side caveats).
        """
        from repro_torch.kernels.elp_bsd_matmul import route
        from repro_torch.kernels.ops import PackedWeight, resolve_impl, tree_leaves

        m = self._hi - self._lo
        probe = torch.empty(0, dtype=self.cfg.dtype)
        multi = self.mesh is not None and self.mesh.size() > 1
        out: dict[str, dict] = {}
        for leaf in tree_leaves(self.params):
            if not isinstance(leaf, PackedWeight):
                continue
            k, n = leaf.shape
            key = f"{m}x{k}x{n}|{leaf.fmt_name}|{'nib' if leaf.nibble else 'u8'}"
            if key in out:
                out[key]["count"] += 1
                continue
            if leaf.codes.ndim == 4:
                impl, source = "moe_dense/dequantize", "structural"
            else:
                kind, source = resolve_impl(m, leaf, self.device.type)
                kernel = "fused_decode_matmul" if kind == "fused" else "elp_bsd_matmul"
                rt = route(probe, leaf.fmt) if self.device.type == "cuda" else "plain"
                impl = f"{kernel}/{rt}"
                if leaf.codes.ndim != 2 or multi:
                    source = "structural"
            out[key] = {"impl": impl, "source": source, "count": 1}
        return out

    def decode_cost(self) -> dict:
        """Cost of one greedy decode step over every slot, on this rank: the engine's
        real greedy decode step run once on ``meta`` copies of this rank's parameters
        and cache, at the current slots and positions, under
        :func:`repro_torch.launch.hlo_stats.step_cost`. ``flops`` and
        ``bytes_accessed`` are this rank's, ``collective_bytes`` the bytes the step
        puts on this rank's wire and ``by_op`` those by collective kind (0 and empty
        without a mesh). Nothing is computed: the live cache is not written and no
        collective is issued. The JAX package reads the same keys from XLA's cost
        analysis of its compiled step."""
        from repro_torch.launch.hlo_stats import step_cost

        c = step_cost(self._decode_greedy, self.params, self._tok_dev, self._dispatch_cache(),
                      self._pos_in())
        return {k: c[k] for k in ("flops", "bytes_accessed", "collective_bytes", "by_op")}

    # -- internals -----------------------------------------------------------
    def _dispatch_cache(self, cache: Any = None) -> Any:
        """The cache dict a dispatch consumes: for the paged layout with a
        fresh device copy of this rank's rows of the page table (admission and
        release change the host table between dispatches)."""
        cache = self._cache if cache is None else cache
        if not self._paged:
            return cache
        return {**cache, "pages": self._pager.to_device(rows=(self._lo, self._hi))}

    def _pos_in(self) -> torch.Tensor:
        """A device copy of this rank's rows' positions."""
        return host_to_device(self._pos[self._lo:self._hi].astype(np.int64), self.device)

    def _spec_round(self, live: dict[int, Request]) -> None:
        """One speculative draft/verify round.

        Round width ``W`` is the adaptive target clamped so no live slot's
        writes run past its cache capacity, and to the largest remaining
        budget. A "model" round is the W-step draft loop then the W-wide
        verify forward; an "ngram" round builds the run on the host (a walk
        of the verified-transition table) and is one verify forward. The
        loop fetches the ``[B]`` acceptance vector once a round (an ngram
        round also the ``[B, W]`` verified tokens, which feed the table).

        Width adapts: a fully accepted round widens the next target by one
        (up to ``spec_k``), a round accepting under half its width drops it
        to just past what was accepted. Width never changes what is
        emitted. Rollback is free: a slot that accepted ``take < W`` tokens
        advances ``pos`` by ``take``, and the rejected positions are
        overwritten before anything reads them (mask-past-pos).
        """
        width = max(1, min(self._spec_width,
                           min(int(self.setup.max_len - self._pos[s]) for s in live),
                           max(r.remaining for r in live.values())))
        pos = self._pos_in()
        t0 = time.perf_counter()
        if self.spec_draft == "model":
            run, _ = self._draft_run(self.draft_params, self._tok_dev,
                                     self._dispatch_cache(self._draft_cache), pos, width)
        else:
            run = host_to_device(self._ngram_run(live, width)[self._lo:self._hi], self.device)
        vtok, acc, ptok, _ = self._verify(self.params, run, self._dispatch_cache(), pos)
        if self.spec_draft == "model":
            self._tok_dev = ptok
        # every rank's rows: the widths and the table depend on every slot's tokens
        vtok, acc = self.setup.gather_rows(vtok), self.setup.gather_rows(acc)
        dt = time.perf_counter() - t0
        self.monitor.record(dt)
        acc_np = acc.cpu().numpy()  # the round's one fetch
        vtok_np = vtok.cpu().numpy() if self.spec_draft == "ngram" else None
        acc_sum = 0
        n_live = len(live)  # snapshot: _maybe_finish pops from live
        for slot, req in list(live.items()):
            a = int(acc_np[slot])
            acc_sum += a
            if vtok_np is None:
                take = req.advance(vtok, slot, width, a)
            else:
                take = min(a, req.remaining)
                req.out.extend(int(t) for t in vtok_np[slot, :take])
                # every transition inside the accepted run is a VERIFIED greedy
                # step of the target tier: teach the table all of them
                chain = np.concatenate(([self._pending[slot]], vtok_np[slot, :a])).astype(np.int64)
                self._ngram[chain[:-1]] = chain[1:]
                self._pending[slot] = int(vtok_np[slot, a - 1])
            req.drafted += width - 1
            req.accepted += a - 1
            self._tokens_drafted += width - 1
            self._tokens_accepted += a - 1
            self._tokens_generated += take
            self._m_acc.record(a)
            if take:
                itl = dt / take
                for _ in range(take):
                    self._m_itl.record(itl)
                self._m_tokens.inc(take)
                self._m_energy.inc(self.energy["total_nj"] * take)
            self._pos[slot] += take
            self._maybe_finish(slot, req)
        self._m_width.record(width)
        if self._draft_energy is not None:
            # a model-draft round also streams the draft tier once per drafted position
            self._m_energy.inc(self._draft_energy["total_nj"] * width)
        if self.profile is not None:
            self.profile.step()
        if self.trace is not None:
            self.trace.event("round", None, live=n_live, width=width, accepted=acc_sum - n_live,
                             dt_s=dt)
        mean_a = acc_sum / n_live
        if mean_a >= width:
            self._spec_width = min(self.spec_k, max(self._spec_width, width + 1))
        elif mean_a < width / 2:
            self._spec_width = max(2, int(mean_a) + 1)
        self._spec_rounds += 1
        # W draft steps + 1 verify forward, or just the verify forward
        self._decode_steps += (width + 1) if self.spec_draft == "model" else 1

    def _ngram_run(self, live: dict[int, Request], width: int) -> np.ndarray:
        """Token-recycling draft run: row ``slot`` is ``[pending, t1 .. t_{W-1}]``,
        each ``t_j`` what last followed ``t_{j-1}`` in any verified stream of
        this engine (an unseen token repeats). Rows of free slots stay zero."""
        run = np.zeros((self._sched.n_slots, width), np.int64)
        for slot in live:
            t = int(self._pending[slot])
            run[slot, 0] = t
            for j in range(1, width):
                nxt = int(self._ngram[t])
                if nxt >= 0:
                    t = nxt
                run[slot, j] = t
        return run

    def _select(self, req: Request, logits_row: torch.Tensor) -> int:
        """The next token from host logits: argmax, or a draw with the request's generator."""
        if req.key is None:
            return int(torch.argmax(logits_row))
        probs = torch.softmax(logits_row.float(), dim=-1)
        return int(torch.multinomial(probs, 1, generator=req.key))

    def _maybe_finish(self, slot: int, req: Request) -> None:
        full = self._pos[slot] >= self.setup.max_len
        if req.remaining <= 0 or full:
            if full and req.remaining > 0:
                req.truncated = True
                self._truncated += 1
            self._sched.finish(slot)
            self._completed += 1
            self._pos[slot] = 0
            if self._paged:
                self._pager.release(slot)
            req.t_finish = time.perf_counter()
            self._m_request.record(req.t_finish - req.t_submit)
            self._m_finished.inc()
            if self.trace is not None:
                self.trace.event("finish", req.rid, slot=slot, tokens=len(req.out),
                                 truncated=req.truncated, total_s=req.t_finish - req.t_submit)

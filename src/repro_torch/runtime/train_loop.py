"""LM training: the train step and the host loop, on one device or data-parallel over a mesh.

The JAX package's ``repro/runtime/train_loop.py``. The step is the loss
and its gradient (each family's ``loss_fn``, attention in the
reference's torch ops, each block recomputed in the backward pass with
``remat``), optional error-feedback gradient compression, the
warmup-cosine learning rate at the optimizer's step, and AdamW with
float32 masters. The host loop adds auto-resume from the newest readable
checkpoint, checkpoints every ``ckpt_every`` steps through the manager's
writer thread, the straggler monitor, and the obs metrics
``train.step_s``, ``train.loss``, ``train.lr`` and ``train.steps_total``.

Over a mesh (``TrainSetup.mesh``, one process a rank) the step is data
parallel over the batch axes and tensor parallel over the model axis,
where the JAX package lets GSPMD shard the global batch and the
parameters: each rank takes its slice of the batch
(:func:`~repro_torch.data.pipeline.shard_batch`) and holds its blocks of
the parameters under the sharding rules (:func:`local_params`; whole on a
model axis of one rank), computes the loss and the gradients of its blocks
(the products split over the model axis, with ``seq_parallel`` the
residual split along the sequence: ``models.transformer``), after
compression when ``compress`` is set, and the gradients and the loss are
averaged over the batch group (``all_reduce``). The gradients' global norm
counts each block sharded over the model axis once (its squares summed
over the model group) and each replicated leaf once. The optimizer state
is ZeRO-1 sharded by :func:`~repro_torch.runtime.sharding.zero1_specs_tree`
on top of the tensor-parallel specs: each rank keeps and updates its blocks
of the moments and float32 masters, then the new parameter blocks are
gathered over the batch axes (``all_gather``). Checkpoints hold the
gathered, whole state and are written by rank 0; a restore reshards it
onto whatever mesh the run has, or none. Every family trains tensor
parallel (mamba2 and the hybrid on their own blocks; ``seq_parallel`` acts in
the transformer stacks, the enc-dec model's included).

Gradient compression quantizes each rank's gradient blocks with error
feedback before the mean. The reference quantizes the global gradient in
256-element blocks of its flattening: the same on one rank, but over a
mesh a rank's block has other 256-element blocks, and so other scales,
than the global gradient.

    setup = TrainSetup(cfg=cfg, mesh=None, lr_peak=6e-4, warmup=50, total_steps=300)
    out = train(setup, steps=300, batch_size=8, seq_len=256, ckpt_dir="ckpt")
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import LmDataset, shard_batch
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import tree_leaves, tree_map
from repro_torch.models import ModelApi, get_model
from repro_torch.models.context import ParallelCtx
from repro_torch.obs.metrics import NULL_REGISTRY, Registry
from repro_torch.optim import adamw
from repro_torch.optim.compress import init_error_state, tree_quantize_with_feedback
from repro_torch.runtime import collectives
from repro_torch.runtime import sharding as shr
from repro_torch.runtime.elastic import gather, reshard
from repro_torch.runtime.straggler import StragglerMonitor


@dataclasses.dataclass(frozen=True)
class TrainSetup:
    """Everything one train step needs. ``compress`` is None, ``"int8"`` or ``"elp4"``;
    ``mesh`` a ``DeviceMesh`` (data parallel over its batch axes, tensor parallel
    over its model axis) or None; ``moe_impl`` the MoE's under a mesh;
    ``seq_parallel`` the sequence-parallel residual on the model axis."""

    cfg: ArchConfig
    mesh: Any = None
    adamw_cfg: adamw.AdamWConfig = adamw.AdamWConfig()
    lr_peak: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    remat: bool = True
    compress: str | None = None
    moe_impl: str = "ep"
    seq_parallel: bool = False

    def pctx(self) -> ParallelCtx | None:
        if self.mesh is None:
            return None
        return ParallelCtx(mesh=self.mesh, batch_axes=shr.batch_axes(self.mesh),
                           model_axis="model", moe_impl=self.moe_impl,
                           seq_parallel=self.seq_parallel)


def state_specs(setup: TrainSetup, params) -> tuple[Any, dict]:
    """(parameter specs, optimizer-state specs: ZeRO-1 for the moments and masters)."""
    pspecs = shr.param_specs(params, setup.mesh)
    zspecs = shr.zero1_specs_tree(pspecs, params, setup.mesh)
    return pspecs, {"m": zspecs, "v": zspecs, "master": zspecs, "step": ()}


def init_opt_state(setup: TrainSetup, params) -> dict[str, Any]:
    """AdamW state of the whole ``params``: whole without a mesh, this rank's ZeRO-1
    blocks under one."""
    if setup.mesh is None:
        return adamw.init_state(params)
    zspecs = state_specs(setup, params)[1]["m"]
    return adamw.init_state(reshard(params, setup.mesh, zspecs))


def local_params(setup: TrainSetup, params):
    """This rank's blocks of the whole ``params`` under the sharding rules (the
    parameters a step takes under a mesh; as given without one)."""
    if setup.mesh is None:
        return params
    return reshard(params, setup.mesh, shr.param_specs(params, setup.mesh))


def _batch_only(spec) -> tuple:
    """A spec with its model-axis entries dropped: the blocks of a model-axis block."""
    return tuple(None if "model" in shr.spec_axes(e) else e for e in spec)


def _sharded(spec) -> bool:
    return any("model" in shr.spec_axes(e) for e in spec)


def tp_global_norm(grads, pspecs, pctx) -> torch.Tensor:
    """``sqrt(sum g^2)`` of the whole gradient from this rank's blocks: the squares of
    the leaves sharded over the model axis summed over it, each replicated leaf
    counted once (float32)."""
    leaves, specs = tree_leaves(grads), tree_leaves(pspecs)
    sq = [torch.sum(torch.square(g.to(torch.float32))) for g in leaves]
    zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    rep = sum((q for q, sp in zip(sq, specs) if not _sharded(sp)), zero)
    sh = sum((q for q, sp in zip(sq, specs) if _sharded(sp)), zero)
    if pctx.model_size > 1:
        sh = collectives.all_reduce(sh.clone(), pctx.model_group)
    return torch.sqrt(rep + sh)


def make_train_step(setup: TrainSetup, api: ModelApi | None = None) -> Callable:
    """``step(params, opt_state, err_state, batch) -> (params, opt_state, err_state,
    metrics)``: one step on the device the parameters live on. ``metrics`` holds the
    loss, the learning rate and the gradients' global norm (after compression) as
    0-dim tensors. Under ``setup.mesh`` ``batch`` is this rank's slice, ``params``
    this rank's blocks (:func:`local_params`; whole on a model axis of one rank),
    ``opt_state`` its ZeRO-1 blocks (:func:`init_opt_state`), ``err_state`` shaped
    as ``params``, and the loss and gradients are the batch group's means."""
    api = api or get_model(setup.cfg)
    sched = adamw.warmup_cosine(setup.lr_peak, setup.warmup, setup.total_steps)
    cfg, pctx = setup.cfg, setup.pctx()
    specs = None  # (parameter specs, ZeRO-1 blocks of the parameter blocks), from the first step

    def mean(t):
        total = collectives.all_reduce(t.detach().to(torch.float32), pctx.batch_group)
        return total / pctx.batch_size

    def step_fn(params, opt_state, err_state, batch):
        nonlocal specs
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = api.loss_fn(params, cfg, batch, pctx=pctx, remat=setup.remat)
        leaves = iter(torch.autograd.grad(loss, tree_leaves(params)))
        grads = tree_map(lambda _: next(leaves), params)
        if setup.compress:
            grads, err_state = tree_quantize_with_feedback(grads, err_state, setup.compress)
        lr = sched(opt_state["step"])
        if pctx is None:
            params, opt_state = adamw.update(grads, opt_state, setup.adamw_cfg, lr, cfg.dtype)
            gnorm = adamw.global_norm(grads)
        else:
            if specs is None:
                pspecs, ospecs = state_specs(setup, whole_shapes(cfg))
                specs = pspecs, tree_map(_batch_only, ospecs["m"])
            pspecs, zblocks = specs
            grads, loss = tree_map(mean, grads), mean(loss)
            gnorm = tp_global_norm(grads, pspecs, pctx)
            clipped, _ = adamw.clip_by_global_norm(grads, setup.adamw_cfg.grad_clip, gnorm)
            blocks, opt_state = adamw.apply_clipped(reshard(clipped, setup.mesh, zblocks),
                                                    opt_state, setup.adamw_cfg, lr, cfg.dtype)
            params = gather(blocks, setup.mesh, zblocks)
        metrics = {"loss": loss.detach(), "lr": lr, "gnorm": gnorm}
        return params, opt_state, err_state, metrics

    return step_fn


def whole_shapes(cfg: ArchConfig):
    """Shape-only (``meta``) whole parameters of ``cfg``: the sharding rules' input
    for a tree whose leaves are this rank's blocks."""
    return get_model(cfg).init_params(cfg, 0, device="meta")


def train(
    setup: TrainSetup,
    *,
    steps: int,
    batch_size: int,
    seq_len: int,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    log_every: int = 10,
    seed: int = 0,
    log_fn: Callable[[str], None] = print,
    metrics: Registry | None = None,
    device=None,
) -> dict[str, Any]:
    """Host training loop on ``device`` (default: the card): data, step, checkpoint.

    Parameters come from ``init_params(cfg, seed)``, batches from
    ``LmDataset(cfg, seq_len, batch_size, seed)`` at the step's index. With
    ``ckpt_dir`` the newest readable checkpoint there is restored first
    (params and optimizer state; the run goes on from its step), a
    checkpoint is written every ``ckpt_every`` steps and at the end, and the
    writer is joined before returning. Returns the params, the optimizer
    state, this run's losses and the straggler report.

    Under ``setup.mesh`` every rank of the mesh runs this (SPMD): the batch
    is sliced by ``input_spec``, each rank steps its blocks of the parameters
    (returned whole) and its ZeRO-1 blocks of the optimizer state (returned
    so), a checkpoint holds the gathered, whole state and only rank 0 writes
    it and logs; a restored state is resharded onto the mesh.
    """
    cfg = setup.cfg
    mesh = setup.mesh
    device = resolve_device(device)
    api = get_model(cfg)
    ds = LmDataset(cfg, seq_len=seq_len, batch=batch_size, seed=seed)
    params = api.init_params(cfg, seed, device=device)
    opt_state = init_opt_state(setup, params)
    pspecs, ospecs = state_specs(setup, params) if mesh is not None else (None, None)
    lead = mesh is None or torch.distributed.get_rank() == 0
    if not lead:
        log_fn = lambda _: None  # noqa: E731

    def whole(tree):
        return {"params": tree["params"] if mesh is None else gather(tree["params"], mesh, pspecs),
                "opt": tree["opt"] if mesh is None else gather(tree["opt"], mesh, ospecs)}

    start = 0
    mgr = CheckpointManager(ckpt_dir, async_save=True) if ckpt_dir else None
    if mgr is not None:
        restored = mgr.restore_latest({"params": params, "opt": opt_state}, device=device)
        if restored is not None:
            start, tree = restored
            params, opt_state = tree["params"], tree["opt"]
            if mesh is not None:
                opt_state = reshard(opt_state, mesh, ospecs)
            log_fn(f"[resume] restored step {start}")
    params = local_params(setup, params)
    err_state = init_error_state(params) if setup.compress else None

    step = make_train_step(setup, api)
    monitor = StragglerMonitor()
    reg = metrics or NULL_REGISTRY
    m_step = reg.histogram("train.step_s")
    m_loss = reg.gauge("train.loss")
    m_lr = reg.gauge("train.lr")
    m_steps = reg.counter("train.steps_total")
    losses = []
    for i in range(start, steps):
        batch = shard_batch(ds.np_batch(i), mesh, device=device)
        t0 = time.perf_counter()
        params, opt_state, err_state, step_metrics = step(params, opt_state, err_state, batch)
        loss = float(step_metrics["loss"])
        dt = time.perf_counter() - t0
        lr = float(step_metrics["lr"])
        monitor.record(dt)
        m_step.record(dt)
        m_loss.set(loss)
        m_lr.set(lr)
        m_steps.inc()
        losses.append(loss)
        if i % log_every == 0:
            log_fn(f"step {i:5d} loss {loss:.4f} lr {lr:.2e}")
        if mgr is not None and (i + 1) % ckpt_every == 0:
            tree = whole({"params": params, "opt": opt_state})
            if lead:
                mgr.save(i + 1, tree)
    if mgr is not None:
        tree = whole({"params": params, "opt": opt_state})
        if lead:
            mgr.save(steps, tree)
            mgr.wait()
    return {
        "params": params if mesh is None else gather(params, mesh, pspecs),
        "opt_state": opt_state,
        "losses": losses,
        "straggler_report": monitor.report(),
    }

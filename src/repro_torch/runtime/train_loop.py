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
parallel over the batch axes, where the JAX package lets GSPMD shard the
global batch: each rank takes its slice of the batch
(:func:`~repro_torch.data.pipeline.shard_batch`), computes the loss and
the gradients on it (after compression, when ``compress`` is set), and
the gradients and the loss are averaged over the batch group
(``all_reduce``). The optimizer state is ZeRO-1 sharded by
:func:`~repro_torch.runtime.sharding.zero1_specs_tree`: each rank keeps
and updates its blocks of the moments and float32 masters, then the new
parameters are gathered whole (``all_gather``). Checkpoints hold the
gathered state and are written by rank 0; a restore reshards it onto
whatever mesh the run has, or none. A model axis wider than one rank
(tensor-parallel projections) raises ``NotImplementedError`` (ROADMAP.md,
queue 1 item 4b).

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
from repro_torch.models.context import ParallelCtx, check_seq_parallel
from repro_torch.models.transformer import check_model_axis
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
    ``mesh`` a ``DeviceMesh`` (data parallel over its batch axes) or None;
    ``moe_impl`` the MoE's under a mesh. ``seq_parallel=True`` raises
    (ROADMAP.md, queue 1 item 4b)."""

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

    def __post_init__(self):
        check_seq_parallel(self.seq_parallel)
        check_model_axis(self.pctx())

    def pctx(self) -> ParallelCtx | None:
        if self.mesh is None:
            return None
        return ParallelCtx(mesh=self.mesh, batch_axes=shr.batch_axes(self.mesh),
                           model_axis="model", moe_impl=self.moe_impl)


def state_specs(setup: TrainSetup, params) -> tuple[Any, dict]:
    """(parameter specs, optimizer-state specs: ZeRO-1 for the moments and masters)."""
    pspecs = shr.param_specs(params, setup.mesh)
    zspecs = shr.zero1_specs_tree(pspecs, params, setup.mesh)
    return pspecs, {"m": zspecs, "v": zspecs, "master": zspecs, "step": ()}


def init_opt_state(setup: TrainSetup, params) -> dict[str, Any]:
    """AdamW state of ``params``: whole without a mesh, this rank's ZeRO-1 blocks
    under one."""
    if setup.mesh is None:
        return adamw.init_state(params)
    zspecs = state_specs(setup, params)[1]["m"]
    return adamw.init_state(reshard(params, setup.mesh, zspecs))


def make_train_step(setup: TrainSetup, api: ModelApi | None = None) -> Callable:
    """``step(params, opt_state, err_state, batch) -> (params, opt_state, err_state,
    metrics)``: one step on the device the parameters live on. ``metrics`` holds the
    loss, the learning rate and the gradients' global norm (after compression) as
    0-dim tensors. Under ``setup.mesh`` ``batch`` is this rank's slice, ``opt_state``
    its ZeRO-1 blocks (:func:`init_opt_state`), the parameters whole on every rank,
    and the loss and gradients are the batch group's means."""
    api = api or get_model(setup.cfg)
    sched = adamw.warmup_cosine(setup.lr_peak, setup.warmup, setup.total_steps)
    cfg, pctx = setup.cfg, setup.pctx()

    def mean(t):
        total = collectives.all_reduce(t.detach().to(torch.float32), pctx.batch_group)
        return total / pctx.batch_size

    def step_fn(params, opt_state, err_state, batch):
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = api.loss_fn(params, cfg, batch, pctx=pctx, remat=setup.remat)
        leaves = iter(torch.autograd.grad(loss, tree_leaves(params)))
        grads = tree_map(lambda _: next(leaves), params)
        if setup.compress:
            grads, err_state = tree_quantize_with_feedback(grads, err_state, setup.compress)
        lr = sched(opt_state["step"])
        if pctx is None:
            params, opt_state = adamw.update(grads, opt_state, setup.adamw_cfg, lr, cfg.dtype)
        else:
            grads, loss = tree_map(mean, grads), mean(loss)
            zspecs = state_specs(setup, params)[1]["m"]
            clipped, _ = adamw.clip_by_global_norm(grads, setup.adamw_cfg.grad_clip)
            blocks, opt_state = adamw.apply_clipped(reshard(clipped, setup.mesh, zspecs),
                                                    opt_state, setup.adamw_cfg, lr, cfg.dtype)
            params = gather(blocks, setup.mesh, zspecs)
        metrics = {"loss": loss.detach(), "lr": lr, "gnorm": adamw.global_norm(grads)}
        return params, opt_state, err_state, metrics

    return step_fn


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
    is sliced by ``input_spec``, the optimizer state is the rank's ZeRO-1
    blocks (returned so), a checkpoint holds the gathered state and only
    rank 0 writes it and logs; a restored state is resharded onto the mesh.
    """
    cfg = setup.cfg
    mesh = setup.mesh
    device = resolve_device(device)
    api = get_model(cfg)
    ds = LmDataset(cfg, seq_len=seq_len, batch=batch_size, seed=seed)
    params = api.init_params(cfg, seed, device=device)
    opt_state = init_opt_state(setup, params)
    ospecs = state_specs(setup, params)[1] if mesh is not None else None
    err_state = init_error_state(params) if setup.compress else None
    lead = mesh is None or torch.distributed.get_rank() == 0
    if not lead:
        log_fn = lambda _: None  # noqa: E731

    def whole(opt):
        return opt if mesh is None else gather(opt, mesh, ospecs)

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
            tree = {"params": params, "opt": whole(opt_state)}
            if lead:
                mgr.save(i + 1, tree)
    if mgr is not None:
        tree = {"params": params, "opt": whole(opt_state)}
        if lead:
            mgr.save(steps, tree)
            mgr.wait()
    return {
        "params": params,
        "opt_state": opt_state,
        "losses": losses,
        "straggler_report": monitor.report(),
    }

"""LM training on one device: the train step and the host loop.

The JAX package's ``repro/runtime/train_loop.py`` without a mesh. The step
is the reference's single-device step: the loss and its gradient (each
family's ``loss_fn``, attention in the reference's torch ops, each block
recomputed in the backward pass with ``remat``), optional error-feedback
gradient compression, the warmup-cosine learning rate at the optimizer's
step, and AdamW with float32 masters. The host loop adds auto-resume from
the newest readable checkpoint, checkpoints every ``ckpt_every`` steps
through the manager's writer thread, the straggler monitor, and the obs
metrics ``train.step_s``, ``train.loss``, ``train.lr`` and
``train.steps_total``.

Not ported: the device mesh (tensor-parallel parameters, ZeRO-1 optimizer
state, batch sharding; ROADMAP.md, queue 1 item 4). ``TrainSetup.mesh``
must be None.

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
from repro_torch.obs.metrics import NULL_REGISTRY, Registry
from repro_torch.optim import adamw
from repro_torch.optim.compress import init_error_state, tree_quantize_with_feedback
from repro_torch.runtime.straggler import StragglerMonitor


@dataclasses.dataclass(frozen=True)
class TrainSetup:
    """Everything one train step needs. ``compress`` is None, ``"int8"`` or ``"elp4"``."""

    cfg: ArchConfig
    mesh: Any = None
    adamw_cfg: adamw.AdamWConfig = adamw.AdamWConfig()
    lr_peak: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    remat: bool = True
    compress: str | None = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "training over a device mesh is not ported to repro_torch yet; see ROADMAP.md "
                "(queue 1 item 4)")


def make_train_step(setup: TrainSetup, api: ModelApi | None = None) -> Callable:
    """``step(params, opt_state, err_state, batch) -> (params, opt_state, err_state,
    metrics)``: one step on the device the parameters live on. ``metrics`` holds the
    loss, the learning rate and the gradients' global norm (after compression) as
    0-dim tensors."""
    api = api or get_model(setup.cfg)
    sched = adamw.warmup_cosine(setup.lr_peak, setup.warmup, setup.total_steps)
    cfg = setup.cfg

    def step_fn(params, opt_state, err_state, batch):
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = api.loss_fn(params, cfg, batch, remat=setup.remat)
        leaves = iter(torch.autograd.grad(loss, tree_leaves(params)))
        grads = tree_map(lambda _: next(leaves), params)
        if setup.compress:
            grads, err_state = tree_quantize_with_feedback(grads, err_state, setup.compress)
        lr = sched(opt_state["step"])
        params, opt_state = adamw.update(grads, opt_state, setup.adamw_cfg, lr, cfg.dtype)
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
    """
    cfg = setup.cfg
    device = resolve_device(device)
    api = get_model(cfg)
    ds = LmDataset(cfg, seq_len=seq_len, batch=batch_size, seed=seed)
    params = api.init_params(cfg, seed, device=device)
    opt_state = adamw.init_state(params)
    err_state = init_error_state(params) if setup.compress else None

    start = 0
    mgr = CheckpointManager(ckpt_dir, async_save=True) if ckpt_dir else None
    if mgr is not None:
        restored = mgr.restore_latest({"params": params, "opt": opt_state}, device=device)
        if restored is not None:
            start, tree = restored
            params, opt_state = tree["params"], tree["opt"]
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
        batch = shard_batch(ds.np_batch(i), device=device)
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
            mgr.save(i + 1, {"params": params, "opt": opt_state})
    if mgr is not None:
        mgr.save(steps, {"params": params, "opt": opt_state})
        mgr.wait()
    return {
        "params": params,
        "opt_state": opt_state,
        "losses": losses,
        "straggler_report": monitor.report(),
    }

"""Shared experiment plumbing: the trained mini CNN, eval functions, CSV rows.

The paper's experiments quantize a trained network. ImageNet is not
available offline, so, as in the JAX package's ``benchmarks/common.py``,
the mini variants of the paper's families train on the deterministic
synthetic task (:class:`~repro_torch.data.pipeline.CnnDataset`) with
momentum SGD, at the same learning rate, step count, batch and seed, and
the weights are cached under ``build/experiments/`` so every figure
quantizes the same baseline model.
"""
from __future__ import annotations

import os
import statistics
import time

import numpy as np
import torch

from repro_torch.calib.policy import CalibrationTable
from repro_torch.data.pipeline import CnnDataset
from repro_torch.device import resolve_device
from repro_torch.models import cnn

__all__ = ["BATCH", "CnnDataset", "EVAL_BATCHES", "N_CLASSES", "RESULTS", "calib_images",
           "emit", "make_eval_fn", "timed", "train_mini_cnn"]

RESULTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))),
    "build", "experiments",
)
N_CLASSES = 10
EVAL_BATCHES = 8
BATCH = 128


def _ckpt_path(spec_name: str) -> str:
    return os.path.join(RESULTS, f"{spec_name}_trained.npz")


def train_mini_cnn(
    spec: cnn.CnnSpec,
    steps: int = 1200,
    lr: float = 2e-2,
    seed: int = 0,
    *,
    params: dict | None = None,
    device=None,
    cache: bool = True,
) -> dict:
    """Train a mini CNN on the synthetic task with momentum SGD (``m = 0.9 m + g``,
    ``w -= lr * m``, batch ``BATCH``, batches ``0 .. steps - 1``).

    Starts from ``cnn.init_params(spec, seed)`` or from ``params`` (a dict
    of tensors or numpy arrays, e.g. the JAX package's initial weights).
    Without ``params`` and with ``cache``, the result is cached under
    ``RESULTS`` by spec name (and step count, if not the default) and a
    cached result is loaded instead of training. Returns float32 tensors
    on ``device`` (default: the card).
    """
    device = resolve_device(device)
    path = _ckpt_path(spec.name if steps == 1200 else f"{spec.name}_s{steps}")
    use_cache = cache and params is None
    if use_cache and os.path.exists(path):
        with np.load(path) as arrs:
            return {k: torch.from_numpy(arrs[k]).to(device) for k in arrs.files}

    ds = CnnDataset(spec.input_hw, spec.input_ch, N_CLASSES, BATCH, seed=seed)
    if params is None:
        params = cnn.init_params(spec, seed=seed, device=device)
    p = {k: (v if torch.is_tensor(v) else torch.from_numpy(np.array(v)))
         .to(device=device, dtype=torch.float32).detach().clone().requires_grad_(True)
         for k, v in params.items()}
    mom = {k: torch.zeros_like(v) for k, v in p.items()}
    for i in range(steps):
        x, y = ds.np_batch(i)
        loss = cnn.loss_fn(p, spec, torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            for (k, w), g in zip(p.items(), grads):
                mom[k].mul_(0.9).add_(g)
                w.sub_(lr * mom[k])
    out = {k: v.detach() for k, v in p.items()}
    if use_cache:
        os.makedirs(RESULTS, exist_ok=True)
        np.savez(path, **{k: v.cpu().numpy() for k, v in out.items()})
    return out


def make_eval_fn(spec: cnn.CnnSpec, seed: int = 0, amp: float | None = None, device=None):
    """``eval_fn(params, act_quant) -> accuracy`` on ``EVAL_BATCHES`` held-out batches.

    ``act_quant`` is None (float activations), an int bit-width (dynamic
    per-tensor range, the paper's FP implementation) or a CalibrationTable
    (static calibrated scales). ``params`` may hold float tensors or
    PackedWeights (then the forward runs on the kernels). Same seed as
    training (the class templates define the task); held-out batches by
    disjoint batch indices (10000 on). ``amp`` below the training
    amplitude gives a harder eval. The batches sit on ``device`` (default:
    the card).
    """
    device = resolve_device(device)
    ds = CnnDataset(spec.input_hw, spec.input_ch, N_CLASSES, BATCH, seed=seed)
    if amp is not None:
        ds.amp = amp
    batches = [ds.np_batch(10_000 + i) for i in range(EVAL_BATCHES)]
    batches = [(torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
               for x, y in batches]

    def eval_fn(params, act_quant=None) -> float:
        accs = []
        with torch.no_grad():
            for x, y in batches:
                if isinstance(act_quant, CalibrationTable):
                    logits = cnn.forward(params, spec, x, calib=act_quant)
                else:
                    logits = cnn.forward(params, spec, x, act_bits=act_quant)
                accs.append(torch.mean((torch.argmax(logits, -1) == y).to(torch.float32)))
        # each batch's float32 mean, then their mean, as the JAX package takes it
        return float(np.mean(torch.stack(accs).cpu().numpy()))

    return eval_fn


def calib_images(
    spec: cnn.CnnSpec, n_batches: int = 8, seed: int = 0, batch: int = BATCH, device=None
) -> torch.Tensor:
    """Stacked calibration batches ``[n, B, H, W, C]`` from the training
    distribution (batch indices 20000 on: disjoint from training and eval)."""
    ds = CnnDataset(spec.input_hw, spec.input_ch, N_CLASSES, batch, seed=seed)
    images = np.stack([ds.np_batch(20_000 + i)[0] for i in range(n_batches)])
    return torch.from_numpy(images).to(resolve_device(device))


def timed(fn, *args, device=None, warmup: int = 1, iters: int = 5) -> float:
    """Median microseconds per call of ``fn(*args)`` after ``warmup`` calls: CUDA
    events around each call on the card, the host clock on the CPU."""
    device = resolve_device(device)
    for _ in range(warmup):
        fn(*args)
    ts = []
    for _ in range(iters):
        if device.type == "cuda":
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn(*args)
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b) * 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            ts.append((time.perf_counter() - t0) * 1e6)
    return float(statistics.median(ts))


def emit(name: str, us: float, derived: str) -> None:
    print(f"{name},{us:.1f},{derived}")

"""Deterministic synthetic data: the LM token stream and the CNN task.

The port's own copies of the JAX package's ``data/pipeline.py::LmDataset``
and ``CnnDataset`` (numpy only), so both packages draw the same batches
bit for bit. No dataset ships offline; both tasks have learnable
structure, so a falling loss and the accuracy of a quantized network mean
something:

  * LM stream: an affine token chain ``t_{i+1} = (31 t_i + 17) mod V`` with
    seeded noise (and, for the frontend families, seeded frontend
    embeddings);
  * CNN task: class templates plus Gaussian noise.

:func:`shard_batch` moves a host batch to one device, or under a mesh
this rank's block of it (its batch slice, by ``input_spec``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class LmDataset:
    """Next-token batches of the affine chain: ``np_batch(step)`` gives ``tokens`` and
    ``labels`` ``[batch, seq_len]`` (int32), plus ``frontend`` float32 embeddings
    (``[batch, seq_len, d_model]`` frames for ``encdec``/``audio``; ``[batch, F,
    d_model]`` patches for a config with ``frontend_tokens`` F, its tokens and
    labels then cut to ``seq_len - F``)."""

    cfg: Any
    seq_len: int
    batch: int
    seed: int = 0
    noise: float = 0.05

    def np_batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        v = self.cfg.vocab
        a, b = 31, 17  # fixed affine chain
        t0 = rng.integers(0, v, size=(self.batch, 1))
        toks = [t0]
        for _ in range(self.seq_len):
            nxt = (toks[-1] * a + b) % v
            flip = rng.random((self.batch, 1)) < self.noise
            rnd = rng.integers(0, v, size=(self.batch, 1))
            toks.append(np.where(flip, rnd, nxt))
        seq = np.concatenate(toks, axis=1).astype(np.int32)
        out = {"tokens": seq[:, : self.seq_len], "labels": seq[:, 1 : self.seq_len + 1]}
        if self.cfg.family in ("encdec", "audio"):
            out["frontend"] = rng.standard_normal(
                (self.batch, self.seq_len, self.cfg.d_model), dtype=np.float32
            )
        elif self.cfg.frontend_tokens:
            f = self.cfg.frontend_tokens
            out["frontend"] = rng.standard_normal(
                (self.batch, f, self.cfg.d_model), dtype=np.float32
            )
            out["tokens"] = out["tokens"][:, : self.seq_len - f]
            out["labels"] = out["labels"][:, : self.seq_len - f]
        return out


@dataclasses.dataclass
class CnnDataset:
    """Synthetic image classification: class template + noise.

    Each class has a fixed random spatial template; an example is
    ``noise + amp * template[y]``. A conv net solves this by matched
    filtering, so accuracy separates a broken quantization (near chance)
    from a healthy one.
    """

    hw: int
    channels: int
    n_classes: int
    batch: int
    seed: int = 0
    amp: float = 1.2

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        t = rng.standard_normal((self.n_classes, self.hw, self.hw, self.channels))
        # low-pass the templates so pooling does not destroy them
        for _ in range(2):
            t = (t + np.roll(t, 1, 1) + np.roll(t, -1, 1) + np.roll(t, 1, 2) + np.roll(t, -1, 2)) / 5
        self.templates = t.astype(np.float32)

    def np_batch(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng((self.seed, step, 1))
        y = rng.integers(0, self.n_classes, size=self.batch).astype(np.int32)
        x = rng.standard_normal((self.batch, self.hw, self.hw, self.channels)).astype(
            np.float32
        )
        x += self.amp * self.templates[y]
        return x, y


def shard_batch(batch: dict[str, np.ndarray], mesh=None, specs=None, *,
                device=None) -> dict[str, torch.Tensor]:
    """A host batch as tensors on ``device`` (default: the card). Under ``mesh``
    each leaf is this rank's block by its spec in ``specs`` (default:
    :func:`~repro_torch.runtime.sharding.input_spec` of its shape), cut on the host."""
    device = resolve_device(device)
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    if mesh is not None:
        from repro_torch.runtime.elastic import local_block
        from repro_torch.runtime.sharding import input_spec

        out = {k: local_block(v, mesh, specs[k] if specs is not None
                              else input_spec(tuple(v.shape), mesh)) for k, v in out.items()}
    return {k: v.to(device) for k, v in out.items()}

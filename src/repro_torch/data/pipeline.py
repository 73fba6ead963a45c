"""Deterministic synthetic data for the mini-CNN experiments.

The port's own copy of the JAX package's ``data/pipeline.py::CnnDataset``
(numpy only), so both packages draw the same batches bit for bit. No
dataset ships offline; the task has learnable structure, so accuracy is a
meaningful quantization-quality signal. The LM stream and the sharded
device put wait for training (ROADMAP.md, queue 1 item 6).
"""
from __future__ import annotations

import dataclasses

import numpy as np


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

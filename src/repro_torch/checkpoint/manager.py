"""Atomic, rotating checkpoints of parameter trees, in the JAX package's layout.

A step lives in ``<dir>/step_XXXXXXXXXX/`` as ``arrays.npz`` (one array
per leaf, keyed by its path with ``/`` written ``__``) and
``manifest.json`` (the step, each leaf's dtype, the key order). A save
writes ``<dir>/tmp.<step>`` and renames it into place, so a crash never
leaves a half-written step under a step name; ``restore_latest`` walks
the steps newest first and skips any it cannot read. bfloat16 leaves are
stored as float32 (exact) with their dtype recorded, since numpy has no
bfloat16. Either package reads the other's checkpoints.

Trees are nested dicts, lists and tuples whose leaves are tensors, numpy
arrays, Python scalars or :class:`~repro_torch.kernels.ops.PackedWeight`
(two leaves, ``.codes`` and ``.sf``); ``None`` holds no leaf. Leaf keys
are the strings the JAX package derives from ``jax.tree_util`` paths:
dict keys in sorted order, list and tuple indices, and ``.codes`` /
``.sf`` for a packed weight, joined by ``/``.

With ``async_save`` (the training loop's choice; the JAX package's default,
not this one's, so other callers find a step on disk when save returns) a
save takes host copies of every leaf on the calling thread, then hands
them to one writer thread and returns, so the training loop keeps
stepping while the step is written; the next save, and
:meth:`CheckpointManager.wait`, first join the writer and raise what it
raised. The copies are the writer's own, so an optimizer step that updates
the tensors in place cannot race the write.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.ops import PackedWeight


def _flatten(tree: Any, prefix: tuple = ()) -> dict[str, Any]:
    """``{key: leaf}`` in the JAX package's leaf order, keyed as its ``_flatten`` keys them."""
    out: dict[str, Any] = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (str(i),)))
    elif isinstance(tree, PackedWeight):
        out["/".join(prefix + (".codes",))] = tree.codes
        out["/".join(prefix + (".sf",))] = tree.sf
    else:
        out["/".join(prefix)] = tree
    return out


def _unflatten(example: Any, flat: dict[str, Any], prefix: tuple = ()) -> Any:
    """``example``'s structure with each leaf taken from ``flat`` by its key."""
    if example is None:
        return None
    if isinstance(example, dict):
        return {k: _unflatten(v, flat, prefix + (str(k),)) for k, v in example.items()}
    if isinstance(example, (list, tuple)):
        items = [_unflatten(v, flat, prefix + (str(i),)) for i, v in enumerate(example)]
        return tuple(items) if isinstance(example, tuple) else items
    if isinstance(example, PackedWeight):
        return dataclasses.replace(example, codes=flat["/".join(prefix + (".codes",))],
                                   sf=flat["/".join(prefix + (".sf",))])
    return flat["/".join(prefix)]


def leaf_to_numpy(v) -> np.ndarray:
    """A leaf as a host numpy array; a bfloat16 tensor as its raw 2-byte values (int16)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.contiguous().view(torch.int16).numpy()
        return v.numpy()
    return np.asarray(v)


def _dtype_name(v) -> str:
    if isinstance(v, torch.Tensor):
        return str(v.dtype).removeprefix("torch.")
    return str(np.asarray(v).dtype)


class CheckpointManager:
    """Numbered checkpoints of one tree under ``directory``, the newest ``keep`` kept
    (``keep=0`` keeps all); written by a writer thread with ``async_save``."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any) -> None:
        flat = _flatten(tree)
        host = {}
        meta = {"step": step, "dtypes": {}, "keys": list(flat)}
        for k, v in flat.items():
            dt = _dtype_name(v)
            meta["dtypes"][k] = dt
            if dt == "bfloat16":
                arr = v.detach().cpu().to(torch.float32).numpy()
            else:
                arr = leaf_to_numpy(v)
                if self.async_save and not (isinstance(v, torch.Tensor) and v.is_cuda):
                    arr = np.array(arr)  # a host leaf's own memory: the writer's copy
            host[k.replace("/", "__")] = arr
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(target=self._write_reporting, args=(step, host, meta),
                                            name=f"checkpoint-{step}")
            self._thread.start()
        else:
            self._write(step, host, meta)

    def _write_reporting(self, step: int, host: dict, meta: dict) -> None:
        try:
            self._write(step, host, meta)
        except BaseException as e:  # handed to the caller by wait()
            self._error = e

    def wait(self) -> None:
        """Join the writer thread, if one runs, and raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host: dict, meta: dict) -> None:
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._prune()

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def restore_latest(self, example_tree: Any, device=None) -> tuple[int, Any] | None:
        """``(step, tree)`` of the newest readable checkpoint, laid out as
        ``example_tree`` with tensors on ``device`` (default: the CPU); a
        step that is unreadable, incomplete or does not fit the example is
        skipped. None when no step can be read."""
        for step in reversed(self.all_steps()):
            try:
                return step, self._load(step, example_tree, device)
            except (OSError, ValueError, KeyError, TypeError, EOFError, zipfile.BadZipFile):
                continue
        return None

    def _load(self, step: int, example_tree: Any, device) -> Any:
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            meta = json.load(f)
        out = {}
        with np.load(os.path.join(path, "arrays.npz")) as arrs:
            for k in _flatten(example_tree):
                arr = arrs[k.replace("/", "__")]
                dt = meta["dtypes"][k]
                if dt == "bfloat16":
                    t = torch.from_numpy(np.array(arr, np.float32)).to(torch.bfloat16)
                else:
                    t = torch.from_numpy(np.array(arr, dtype=np.dtype(dt)))
                out[k] = t.to(device) if device is not None else t
        return _unflatten(example_tree, out)

"""Carry weights across from the JAX package, given as numpy.

The JAX package and this port use the same layouts (NHWC activations,
HWIO conv weights, ``[in, out]`` matmul weights, ``[K, N]`` or nibble
``[ceil(K/2), N]`` codes, stacked ``[L, ...]`` LM block leaves and
``[L, E, ...]`` MoE expert stacks), so a
parameter tree or a packed weight moves across as its arrays. Nothing
here imports the JAX package: the caller hands over ``np.asarray`` of its
leaves, or packed-weight records whose ``codes``/``sf`` are arrays.
Each leaf keeps its dtype: a bfloat16 array (numpy's ``bfloat16``
extension type, as ``np.asarray`` gives a JAX bfloat16 leaf) becomes a
bfloat16 tensor bit for bit, and the float32 leaves of a bfloat16 model
(mamba2's ``A_log``, ``D``, ``dt_bias``; the RG-LRU's ``lam``, ``ba``,
``bx``) stay float32.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import PackedWeight


def _is_packed_record(leaf) -> bool:
    return all(hasattr(leaf, a) for a in ("codes", "sf", "fmt_name", "nibble", "shape"))


def params_from_numpy(tree: Mapping, device=None) -> dict:
    """A JAX parameter tree -> the port's tree of tensors on ``device``.

    ``tree`` is a dict, nested as the JAX package nests it (an LM's
    ``embed``, ``blocks.*`` stacked ``[L, ...]``, ``final_norm``,
    ``lm_head``). Each leaf is an array (anything ``np.asarray`` takes) or
    a packed-weight record with ``codes`` (``[K', N]``, stacked
    ``[L, K', N]`` or an expert stack ``[L, E, K', N]``), ``sf``,
    ``fmt_name``, ``nibble``, ``shape`` and the
    optional ``source_shape``/``act_scale``/``act_bits``, which becomes a
    :class:`PackedWeight` (:func:`packed_from_numpy`). The recurrent and
    enc-dec trees (mamba2's ``blocks``, rglru's ``rec`` and ``attn``,
    enc-dec's ``encoder`` and ``decoder``) move the same way.
    """
    device = resolve_device(device)

    def leaf(v):
        if isinstance(v, Mapping):
            return {k: leaf(x) for k, x in v.items()}
        if _is_packed_record(v):
            return packed_from_numpy(
                np.asarray(v.codes), np.asarray(v.sf), v.fmt_name, v.nibble, v.shape,
                getattr(v, "source_shape", None), getattr(v, "act_scale", None),
                getattr(v, "act_bits", None), device=device,
            )
        return array_to_tensor(v).to(device)

    return leaf(tree)


def array_to_tensor(v) -> torch.Tensor:
    """A host copy of ``v`` as a tensor of its dtype; numpy's ``bfloat16`` extension
    type goes across through its 2-byte pattern."""
    a = np.array(v)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def packed_from_numpy(
    codes: np.ndarray,
    sf: np.ndarray,
    fmt_name: str,
    nibble: bool,
    shape: tuple[int, int],
    source_shape: tuple[int, ...] | None = None,
    act_scale: float | None = None,
    act_bits: int | None = None,
    *,
    device=None,
) -> PackedWeight:
    """A :class:`PackedWeight` from the JAX package's numpy codes and scale factors.

    ``codes`` is ``[K', N]``, a stacked ``[L, K', N]`` (``sf`` then
    ``[L, 1, 1]``) or an expert stack ``[L, E, K', N]`` (``sf``
    ``[L, E, 1, 1]``); ``shape`` is the logical ``(K, N)`` of one slice.
    """
    device = resolve_device(device)
    codes = np.asarray(codes)
    if codes.dtype != np.uint8:
        raise TypeError(f"codes must be uint8, got {codes.dtype}")
    return PackedWeight(
        codes=torch.from_numpy(np.array(codes)).to(device),
        sf=torch.from_numpy(np.array(sf, dtype=np.float32)).to(device),
        fmt_name=fmt_name,
        nibble=bool(nibble),
        shape=(int(shape[0]), int(shape[1])),
        source_shape=tuple(int(s) for s in source_shape) if source_shape is not None else None,
        act_scale=float(act_scale) if act_scale is not None else None,
        act_bits=int(act_bits) if act_bits is not None else None,
    )

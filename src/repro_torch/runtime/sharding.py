"""Divisibility-aware sharding rules.

The JAX package's ``repro/runtime/sharding.py`` as pure functions of a
mesh's axis sizes. A logical dimension is mapped to a mesh axis only if
its size divides the axis size; otherwise the rule falls through to the
next candidate dimension (or replication), which absorbs the awkward
configs (yi-34b's 56 heads, seamless' 256206 vocab, olmoe's expert
widths) without per-arch cases. Baseline layout:

  * column-parallel (out-feature) sharding for up-projections and QKV,
  * row-parallel (in-feature) sharding for down-projections,
  * expert sharding for MoE,
  * vocab-parallel embedding and LM head when the vocab divides,
  * batch over ``("pod", "data")``; KV cache heads over model (falling
    back to head_dim, then seq), or seq first under flash-decoding,
  * ZeRO-1: optimizer state also sharded over the data axes.

A spec is a tuple with one entry per leading tensor dim: ``None``, an
axis name, or a tuple of axis names (a ``PartitionSpec`` read as a
tuple; ``()`` replicates). ``mesh`` is anything with named axis sizes: a
``DeviceMesh`` with ``mesh_dim_names``, an object whose ``.shape`` maps
names to sizes, or such a mapping itself (:func:`mesh_shape`).

Trees are the port's parameter and cache trees: nested dicts of tensors
(or tuples of them), with :class:`~repro_torch.kernels.ops.PackedWeight`
leaves whose ``codes`` take the weight's rule and whose ``sf`` follows
:func:`_scale_spec`. Spec trees have the tree's structure, a packed leaf
holding its two specs in ``codes`` and ``sf``. The rules read only
shapes, so a shape-only tree on the ``meta`` device
(``init_params(cfg, device="meta")``, packed by ``pack_lm_params``) gives
a full-size config's specs without its memory.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

from repro_torch.kernels.ops import PackedWeight

# Weight name -> candidate sharded dim, counted from the END of the shape
# (robust to the [L, ...] stacking axis).
_COL = {"wq", "wk", "wv", "w1", "w3", "xq", "xk", "xv", "in_proj", "w_gate",
        "w_rec", "wa", "wx", "frontend_proj", "router"}
_ROW = {"wo", "w2", "out_proj", "w_out", "xo"}
_EXPERT = {"we1", "we2", "we3"}
_VOCAB = {"embed", "lm_head"}
_REPL = {"ln", "ln1", "ln2", "ln_x", "final_norm", "enc_norm", "gnorm", "conv_b",
         "A_log", "D", "dt_bias", "ba", "bx", "lam", "qnorm", "knorm"}
# A packed weight's scale leaves ride under the weight's name.
_SCALE_LEAVES = {"sf", "scale", "act_scale"}

Spec = tuple


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh, a duck-typed mesh or a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    shape = getattr(mesh, "shape", mesh)
    return dict(shape)


def map_with_path(fn: Callable, tree: Any, *rest: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf, *rest_leaves)`` over a tree; ``path`` is the tuple of dict
    keys and packed-weight fields (``"codes"``, ``"sf"``) leading to the leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest), path=path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, v, *(r[i] for r in rest), path=path)
                          for i, v in enumerate(tree))
    if isinstance(tree, PackedWeight):
        return dataclasses.replace(
            tree,
            codes=fn(path + ("codes",), tree.codes, *(r.codes for r in rest)),
            sf=fn(path + ("sf",), tree.sf, *(r.sf for r in rest)))
    return fn(path, tree, *rest)


def _leaf_name(path) -> tuple[str, str | None]:
    """(leaf name, owning-weight name for a packed weight's scale leaves).

    ``codes`` takes the weight's own name (the codes mirror the weight's
    layout); a scale leaf keeps its own name plus its weight's.
    """
    names = [str(p) for p in path]
    if not names:
        return "", None
    if names[-1] == "codes" and len(names) >= 2:
        return names[-2], None
    if names[-1] in _SCALE_LEAVES:
        return names[-1], names[-2] if len(names) >= 2 else None
    return names[-1], None


def _try(shape: tuple[int, ...], dim: int, axis: str, size: int) -> Spec | None:
    """Spec sharding ``dim`` (negative ok) over ``axis`` if it divides."""
    d = dim % len(shape)
    if shape[d] % size == 0 and shape[d] > 0:
        spec = [None] * len(shape)
        spec[d] = axis
        return tuple(spec)
    return None


def _scale_spec(parent: str | None, shape: tuple[int, ...], mesh, model_axis: str) -> Spec:
    """Spec of a packed weight's scale leaf: per-channel scales ``[..., 1, N]`` of
    a column-parallel or vocab weight shard the out dim with the codes; an
    expert stack's scales shard the expert dim; everything else (per-slice
    ``[..., 1, 1]`` scales, row-parallel weights, whose shards each need every
    out-channel scale) replicates."""
    msize = mesh_shape(mesh)[model_axis]
    if parent in _EXPERT and len(shape) >= 3:
        s = _try(shape, len(shape) - 3, model_axis, msize)
        if s is not None:
            return s
    if parent in _COL or parent in _VOCAB:
        s = _try(shape, -1, model_axis, msize)
        if s is not None:
            return s
    return ()


def param_spec(path, shape: tuple[int, ...], mesh, model_axis: str = "model") -> Spec:
    """Baseline tensor-parallel spec of one parameter leaf."""
    shape = tuple(shape)
    name, scale_parent = _leaf_name(path)
    if len(shape) == 0 or min(shape) == 0:
        return ()
    if name in _SCALE_LEAVES:
        return _scale_spec(scale_parent, shape, mesh, model_axis)
    msize = mesh_shape(mesh)[model_axis]
    if name in _REPL:
        return ()
    if name in _VOCAB:
        # embed [V, D] / lm_head [D, V]: prefer the vocab dim
        vdim = 0 if name == "embed" else len(shape) - 1
        for d in (vdim, 1 - vdim if len(shape) == 2 else vdim):
            s = _try(shape, d, model_axis, msize)
            if s is not None:
                return s
        return ()
    if name in _EXPERT and len(shape) >= 3:
        # [L, E, a, b] (or [E, a, b]): the expert dim
        s = _try(shape, len(shape) - 3, model_axis, msize)
        if s is not None:
            return s
    if name in _COL:
        for d in (-1, -2):
            s = _try(shape, d, model_axis, msize)
            if s is not None:
                return s
        return ()
    if name in _ROW:
        for d in (-2, -1):
            s = _try(shape, d, model_axis, msize)
            if s is not None:
                return s
        return ()
    if name == "conv_w" and len(shape) >= 2:
        s = _try(shape, -1, model_axis, msize)
        if s is not None:
            return s
    return ()


def param_specs(params: Any, mesh, model_axis: str = "model") -> Any:
    """Specs of a whole parameter tree (shape-only trees welcome)."""
    return map_with_path(lambda path, leaf: param_spec(path, leaf.shape, mesh, model_axis),
                         params)


def batch_axes(mesh) -> tuple[str, ...]:
    """Axes carrying the global batch: ``("pod", "data")`` when pod exists."""
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def _axis_entry(axes: tuple[str, ...]):
    """A spec entry for a set of axes: the bare name when there is one."""
    return axes[0] if len(axes) == 1 else axes


def input_spec(shape: tuple[int, ...], mesh) -> Spec:
    """Batch-shard an input over the data axes when its batch divides."""
    shape = tuple(shape)
    ms = mesh_shape(mesh)
    ba = batch_axes(mesh)
    n = math.prod(ms[a] for a in ba)
    if len(shape) >= 1 and shape[0] % n == 0 and shape[0] > 0:
        return (_axis_entry(ba), *([None] * (len(shape) - 1)))
    # data only (pod replicated)
    if "data" in ms and shape[0] % ms["data"] == 0:
        return ("data", *([None] * (len(shape) - 1)))
    return tuple([None] * len(shape))


def input_specs_tree(inputs: Any, mesh) -> Any:
    return map_with_path(lambda _, leaf: input_spec(tuple(leaf.shape), mesh), inputs)


def cache_spec(path, shape: tuple[int, ...], mesh, model_axis: str = "model",
               prefer_seq: bool = False, paged: bool = False) -> Spec:
    """KV or recurrent-state cache layout.

    ``[L, B, S, KV, hd]`` tensors: batch over the data axes, then heads over
    model if they divide, else head_dim, else seq; with ``prefer_seq`` (the
    flash-decoding layout) the seq dim takes the model axis first. Recurrent
    states ``[L, B, ...]``: batch over data, the widest trailing dim over
    model. A paged cache's ``pages`` table and static ``k_scale``/``v_scale``
    replicate, and its pool ``[L, n_pages, page, KV, hd]`` shards only heads
    (else head_dim) over model: never the page dims, which every row's gather
    indexes freely.
    """
    shape = tuple(shape)
    name, _ = _leaf_name(path)
    if name in ("pages", "k_scale", "v_scale"):
        return tuple([None] * len(shape))
    ms = mesh_shape(mesh)
    msize = ms[model_axis]
    if paged:
        spec: list[Any] = [None] * len(shape)
        for d in (len(shape) - 2, len(shape) - 1):  # KV heads, then head_dim
            if d > 1 and shape[d] % msize == 0 and shape[d] >= msize:
                spec[d] = model_axis
                break
        return tuple(spec)
    ba = batch_axes(mesh)
    nb = math.prod(ms[a] for a in ba)
    spec = [None] * len(shape)
    if len(shape) >= 2:
        # the batch dim is dim 1 of a stacked cache, dim 0 of an unstacked one
        bdim = 1 if len(shape) >= 3 else 0
        if shape[bdim] % nb == 0:
            spec[bdim] = _axis_entry(ba)
        elif "data" in ms and shape[bdim] % ms["data"] == 0:
            spec[bdim] = "data"
    if prefer_seq and len(shape) >= 4:
        sdim = len(shape) - 3  # the seq dim of [.., B, S, KV, hd]
        if shape[sdim] % msize == 0:
            spec[sdim] = model_axis
            return tuple(spec)
    # the model axis: prefer later dims (heads, features), walking backwards
    for d in range(len(shape) - 1, 1, -1):
        if spec[d] is None and shape[d] % msize == 0 and shape[d] >= msize:
            spec[d] = model_axis
            break
    return tuple(spec)


def cache_specs_tree(cache: Any, mesh, model_axis: str = "model",
                     prefer_seq: bool = False) -> Any:
    names = []
    map_with_path(lambda path, leaf: names.append(_leaf_name(path)[0]), cache)
    paged = "pages" in names
    return map_with_path(
        lambda path, leaf: cache_spec(path, tuple(leaf.shape), mesh, model_axis, prefer_seq,
                                      paged),
        cache)


def zero1_spec(spec: Spec, shape: tuple[int, ...], mesh) -> Spec:
    """A parameter spec extended with data-axis sharding for optimizer state
    (ZeRO-1): the largest unsharded dim divisible by the data axes."""
    shape = tuple(shape)
    ms = mesh_shape(mesh)
    ba = batch_axes(mesh)
    n = math.prod(ms[a] for a in ba)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    cands = [d for d in range(len(shape))
             if entries[d] is None and shape[d] % n == 0 and shape[d] >= n]
    if not cands:
        return tuple(entries)
    d = max(cands, key=lambda i: shape[i])
    entries[d] = _axis_entry(ba)
    return tuple(entries)


def zero1_specs_tree(param_spec_tree: Any, params: Any, mesh) -> Any:
    return map_with_path(lambda _, leaf, spec: zero1_spec(spec, tuple(leaf.shape), mesh),
                         params, param_spec_tree)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e)) for e in x)


def named(mesh, spec_tree: Any) -> Any:
    """Each spec as DTensor placements, one per mesh dim: ``Shard(d)`` on the
    dims that shard tensor dim ``d``, ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    dims = list(mesh_shape(mesh))

    def place(spec):
        out = [Replicate()] * len(dims)
        for d, entry in enumerate(spec):
            for axis in spec_axes(entry):
                out[dims.index(axis)] = Shard(d)
        return tuple(out)

    def walk(t):
        if _is_spec(t):
            return place(t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, PackedWeight):
            return dataclasses.replace(t, codes=walk(t.codes), sf=walk(t.sf))
        return type(t)(walk(v) for v in t)

    return walk(spec_tree)


def spec_axes(entry) -> tuple[str, ...]:
    """The axes of one spec entry, in order (``()`` for ``None``)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)

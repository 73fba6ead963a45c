"""One front door: ``QuantScheme`` -> :func:`quantize` -> :class:`QuantizedModel`.

    from repro_torch import api
    from repro_torch.models import cnn

    params = cnn.init_params(cnn.ALEXNET, seed=0)            # on the card
    qm = api.quantize(cnn.ALEXNET, params,
                      api.QuantScheme(fmt="elp_bsd_a4", act="static"),
                      calib_data=images)                    # [n, B, H, W, C]
    logits = qm.forward(batch)   # convs on the tiled kernel, fc on the decode-step kernel
    qm.save("artifacts/alexnet4b")
    qm2 = api.load("artifacts/alexnet4b")                   # bit-identical forward

    # the paper's Sec. V search: CBW_A within scheme.ac of the float model
    qm = api.quantize(cnn.ALEXNET_MINI, trained,
                      api.QuantScheme(fmt="elp_bsd_a4", act="dynamic", ac=0.01),
                      eval_fn=eval_fn)                      # eval_fn(params, act_quant)

    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = get_config("qwen3_8b")
    params = transformer.init_params(cfg, seed=0)           # on the card
    qm = api.quantize(cfg, params, api.QuantScheme(fmt="elp4", act="static"),
                      calib_data=token_batches)             # [n, B, S]
    new_tokens = qm.generate(prompts, 16)                   # [B, S] -> [B, 16]
    outs = qm.serve([(prompt, 16) for prompt in prompts], n_slots=8)  # continuous batching

``quantize`` calibrates (observers, percentile clipping; for CNNs the
rho-gated fold of ``W @ E[eps]`` into biases), packs (SF -> TQL ->
nearest level -> Algorithm 1 -> ELP_BSD codes, nibble-packed for 4-bit;
an LM per stacked layer slice) and, given an ``eval_fn``, runs the Sec. V
accuracy-constraint search. A speculative scheme
(:meth:`QuantScheme.speculative`) also builds the verify tier that checks
the draft tier's tokens at serve time. :class:`QuantizedModel` saves to
and loads from an artifact directory in the JAX package's layout (either
package reads the other's, the speculative ``verify_params/`` tier
included), with a SHA-256 checksum per leaf; a corrupted or incomplete
artifact raises :class:`ArtifactError`. Entry points run on the card
unless the caller passes ``device="cpu"``; with no card and no explicit
CPU request they raise. ``QuantScheme(block_sizes="auto")`` runs the CNN's
packed convs and fc layers on the autotune cache's measured winners
(:mod:`repro_torch.bench.autotune`; the default dispatch on a miss) and
records the cache entries it matched in ``report.tuned_blocks``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.api_schemes import CnnAdapter, LmAdapter, QuantScheme, as_adapter
from repro_torch.bench import autotune
from repro_torch.calib.policy import CalibrationTable
from repro_torch.checkpoint.manager import (
    CheckpointManager,
    _dtype_name,
    _flatten,
    leaf_to_numpy,
)
from repro_torch.core.elp_bsd import resolve_format, storage_bytes
from repro_torch.core.energy import network_energy_nj
from repro_torch.core.methodology import find_critical_act_bits
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import (
    PackedWeight,
    dequantize_tree,
    packed_tree_bytes,
    tree_leaves,
    tree_map,
)

__all__ = [
    "ARTIFACT_VERSION",
    "ArtifactError",
    "ConversionReport",
    "QuantScheme",
    "QuantizedModel",
    "load",
    "quantize",
    "resolve_format",
]

ARTIFACT_VERSION = 1
_MANIFEST = "manifest.json"
_CALIB = "calib.json"
_PARAMS_DIR = "params"
_VERIFY_DIR = "verify_params"


class ArtifactError(ValueError):
    """A saved QuantizedModel is missing, malformed, or corrupted."""


@dataclasses.dataclass(frozen=True)
class ConversionReport:
    """What a conversion did, in numbers.

    ``packed_bytes`` counts runtime storage (one byte per u8 code, two
    nibble codes per byte, float32 scales); ``encoded_bytes`` is the
    paper's Table II accounting with codes bit-packed at
    ``bits_per_weight``; ``energy_nj`` is the Table II network energy.
    ``baseline_accuracy`` / ``accuracy`` are the Sec. V search's readings
    (with an ``eval_fn``). ``tuned_blocks`` records the autotune-cache
    entries that matched this artifact's weight shapes when
    ``block_sizes="auto"`` (:func:`_tuned_blocks_for`).
    """

    fmt: str
    act: str
    act_bits: int | None
    raw_bytes: int
    packed_bytes: int
    packed_weight_bytes: int
    encoded_bytes: int
    baseline_accuracy: float | None = None
    accuracy: float | None = None
    energy_nj: float | None = None
    tuned_blocks: tuple = ()

    @property
    def compression(self) -> float:
        return self.raw_bytes / max(self.packed_bytes, 1)

    @property
    def accuracy_loss(self) -> float | None:
        if self.accuracy is None or self.baseline_accuracy is None:
            return None
        return self.baseline_accuracy - self.accuracy

    def to_json(self) -> dict:
        doc = dataclasses.asdict(self)
        doc["tuned_blocks"] = [[k, list(b)] for k, b in self.tuned_blocks]
        return doc

    @classmethod
    def from_json(cls, doc: Mapping[str, Any]) -> "ConversionReport":
        kw = dict(doc)
        kw["tuned_blocks"] = tuple(
            (str(k), tuple(int(x) for x in b)) for k, b in kw.get("tuned_blocks", [])
        )
        return cls(**kw)


def _encoded_bytes(tree: dict) -> int:
    """Bit-packed (Table II) byte accounting for a (nested) packed params dict."""
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, PackedWeight):
            k, n = leaf.shape
            stack = math.prod(leaf.codes.shape[:-2])
            total += storage_bytes(stack * k * n, leaf.fmt) + leaf.sf.numel() * 4
        else:
            total += leaf.numel() * leaf.element_size()
    return total


def _to_device(x, device: torch.device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device)
    a = np.asarray(x)
    return torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)


def _batch_to_device(batch, device: torch.device):
    """Token ids, or a batch dict (``"tokens"``; a ``vlm`` model's ``"frontend"``), on
    ``device``."""
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    return _to_device(batch, device)


def _tree_to_device(tree, device: torch.device):
    return tree_map(lambda v: v.to(device) if isinstance(v, PackedWeight)
                    else _to_device(v, device), tree)


def _tuned_blocks_for(packed: dict, backend: str) -> tuple:
    """Autotune-cache entries that apply to this tree's ``(K, N, fmt, layout)``
    shapes on ``backend``: ``((key, blocks), ...)``, sorted.

    The reference's parse, kept as it is: a key splits into four fields
    (``backend|fmt|mode|MxKxN``, the schema-1 layout), so on a schema-2 cache,
    whose keys have five, it returns ``()``; both packages record the same.
    """
    shapes = {(leaf.shape, leaf.fmt_name, leaf.nibble) for leaf in tree_leaves(packed)
              if isinstance(leaf, PackedWeight)}
    out = []
    for key, ent in autotune.cache_entries().items():
        try:
            bk, fmt_name, mode, mkn = key.split("|")
            _m, kdim, ndim = (int(v) for v in mkn.split("x"))
        except ValueError:
            continue
        if bk != backend:
            continue
        for kn, fn, nib in shapes:
            if fn == fmt_name and mode == ("nib" if nib else "u8") and kn == (kdim, ndim):
                out.append((key, tuple(ent["blocks"])))
                break
    return tuple(sorted(out))


def quantize(
    model,
    params: dict,
    scheme: QuantScheme | None = None,
    *,
    calib_data: Any = None,
    eval_fn: Callable[[Any, Any], float] | None = None,
    device=None,
) -> "QuantizedModel":
    """Run the CoNLoCNN conversion on one model: calibrate, (fold,) pack, search.

    Args:
      model: a ``CnnSpec`` or a decoder-LM ``ArchConfig``.
      params: the trained float parameter dict (tensors or numpy arrays;
        nested for an LM).
      scheme: the :class:`QuantScheme` (default: 4-bit ELP_BSD weights,
        Algorithm 1 on, float activations).
      calib_data: stacked calibration batches, required when
        ``scheme.act == "static"``: images ``[n, B, H, W, C]`` for a CNN,
        token ids ``[n, B, S]`` for an LM.
      eval_fn: ``eval_fn(params, act_quant) -> accuracy``, with
        ``act_quant`` None, an int bit-width or a CalibrationTable (the
        contract of :func:`repro_torch.experiments.common.make_eval_fn`);
        ``params`` arrive on ``device``. It turns on the Sec. V search: the
        baseline is the float ``params``; the critical activation
        bit-width CBW_A is the lowest within ``scheme.ac`` of it (step 1,
        on the float params); step 5 re-checks it on the float twin of the
        packed codes (what the artifact serves, numerically) and walks
        CBW_A up while the constraint is violated. A static scheme's table
        is then re-stamped at CBW_A.
      device: where the conversion and the model run (default: the card).
    """
    adapter = as_adapter(model)
    scheme = scheme if scheme is not None else QuantScheme()
    device = resolve_device(device)
    params = _tree_to_device(params, device)
    raw_bytes = packed_tree_bytes(params)

    table: CalibrationTable | None = None
    work = params
    if scheme.act == "static":
        if calib_data is None:
            raise ValueError('scheme.act == "static" needs calib_data (stacked calibration batches)')
        table, work = adapter.calibrate(params, _to_device(calib_data, device), scheme)
    packed = adapter.pack(work, scheme, table)

    # A speculative scheme packs a SECOND tier of the same checkpoint: the
    # verify tier ("float": the float tree itself) that the serve engine uses
    # to check the low-bit draft's tokens. The report stays about the draft.
    verify_params = None
    if scheme.spec_k:
        if adapter.kind != "lm":
            raise ValueError("speculative schemes (spec_verify/spec_k) are an LM serving "
                             "feature; CNN models classify in one forward")
        if scheme.spec_verify == "float":
            verify_params = work
        else:
            vscheme = dataclasses.replace(scheme, fmt=scheme.spec_verify, spec_verify=None,
                                          spec_k=0)
            verify_params = adapter.pack(work, vscheme, table)

    baseline_acc: float | None = None
    accuracy: float | None = None
    act_bits = scheme.resolved_act_bits()
    if eval_fn is not None:
        # The baseline is the user's float model, not the bias-folded
        # calibration output (its fold only makes sense under quantization).
        baseline_acc = eval_fn(params, None)
        deq = dequantize_tree(packed)
        if scheme.act == "float":
            accuracy = eval_fn(deq, None)  # no activation quantization: no search
        else:
            cbw = find_critical_act_bits(eval_fn, params, baseline_acc, scheme.ac,
                                         scheme.bw_max, scheme.bw_min, calib=table)

            def act_quant(bits: int):
                return table.with_bits(bits) if table is not None else bits

            # Step 5 on the float twin of the codes: walk CBW_A back up
            # while the constraint is violated.
            accuracy = eval_fn(deq, act_quant(cbw))
            while baseline_acc - accuracy > scheme.ac and cbw < scheme.bw_max:
                cbw += 1
                accuracy = eval_fn(deq, act_quant(cbw))
            act_bits = cbw
            if table is not None:
                table = table.with_bits(act_bits)
                packed = adapter.stamp_act(packed, table)

    encoded_bytes = _encoded_bytes(packed)
    report = ConversionReport(
        fmt=scheme.format.name,
        act=scheme.act,
        act_bits=act_bits,
        raw_bytes=raw_bytes,
        packed_bytes=packed_tree_bytes(packed),
        packed_weight_bytes=packed_tree_bytes(packed, packed_only=True),
        encoded_bytes=encoded_bytes,
        baseline_accuracy=baseline_acc,
        accuracy=accuracy,
        energy_nj=network_energy_nj(
            adapter.spec.macs(), encoded_bytes, scheme.format.name, act_bits or 8
        )["total_nj"] if adapter.kind == "cnn" else None,
        tuned_blocks=(_tuned_blocks_for(packed, device.type)
                      if scheme.block_sizes == "auto" else ()),
    )
    return QuantizedModel(packed, adapter, scheme, table=table, report=report,
                          verify_params=verify_params)


class QuantizedModel:
    """The artifact of a conversion: packed params plus what serves them.

    ``verify_params`` (speculative schemes only) is the second tier of the
    same checkpoint, float or a wider ELP format: it checks the draft
    tier's tokens at serve time and defines the output.
    """

    def __init__(
        self,
        params: dict,
        adapter,
        scheme: QuantScheme,
        *,
        table: CalibrationTable | None = None,
        report: ConversionReport | None = None,
        verify_params: dict | None = None,
    ):
        self.params = params
        self.adapter = adapter
        self.scheme = scheme
        self.table = table
        self.report = report
        self.verify_params = verify_params

    @property
    def device(self) -> torch.device:
        leaf = tree_leaves(self.params)[0]
        return (leaf.codes if isinstance(leaf, PackedWeight) else leaf).device

    def to(self, device) -> "QuantizedModel":
        """The same artifact with its tensors on ``device``."""
        device = resolve_device(device)
        verify = (None if self.verify_params is None
                  else _tree_to_device(self.verify_params, device))
        return QuantizedModel(_tree_to_device(self.params, device), self.adapter, self.scheme,
                              table=self.table, report=self.report, verify_params=verify)

    def forward(self, x, *, impl: str | None = None, block_sizes=None) -> torch.Tensor:
        """Images ``[B, H, W, C]`` -> logits (CNN), tokens ``[B, S]`` -> last logits (LM;
        a ``vlm`` model takes a batch dict with ``"tokens"`` and ``"frontend"``).

        The scheme's activation policy applies: static schemes quantize
        against the calibration table, dynamic ones per tensor at
        ``act_bits``. On the card ``impl="auto"`` (the default) takes the
        tiled kernel for the convs and the decode-step kernel for fc
        layers at batch <= 256; ``"tiled"`` / ``"fused"`` force one. The LM
        path picks its kernels itself, so ``impl``/``block_sizes`` are an
        error there.
        """
        if self.adapter.kind == "lm":
            if impl is not None or block_sizes is not None:
                raise ValueError(
                    "impl/block_sizes are CNN execution overrides; the LM path picks its "
                    "matmul kernel from the row count (models/layers.matmul)"
                )
            return self.adapter.forward(self.params, _batch_to_device(x, self.device))
        calib = act_bits = None
        if self.scheme.act == "static":
            calib = self.table
        elif self.scheme.act == "dynamic":
            act_bits = (self.report.act_bits if self.report else None) or 8
        return self.adapter.forward(
            self.params,
            _to_device(x, self.device),
            calib=calib,
            act_bits=act_bits,
            impl=impl or "auto",
            block_sizes=self.scheme.block_sizes if block_sizes is None else block_sizes,
        )

    def generate(self, batch, max_new_tokens: int, *, greedy: bool = True, generator=None,
                 max_len: int | None = None) -> torch.Tensor:
        """LM generation on the packed weights: prompts ``[B, S]`` -> new tokens ``[B, n]``.

        Routes through :func:`repro_torch.serve.engine.batch_generate`, as the
        JAX package does: greedy calls run on the continuous-batching
        :class:`~repro_torch.serve.engine.ServeEngine` (one slot per row);
        sampled calls (``greedy=False`` with a ``generator``) keep the static
        lockstep loop. Either way the block matmuls consume the codes (on the
        card the decode-step kernel at <= 256 rows, the tiled kernel above;
        a dense prefill's attention on the flash kernel). Speculative
        artifacts decode speculatively: the draft tier proposes, the verify
        tier checks and defines the output. ``max_len`` is the cache length
        (default: prompt plus new tokens).
        """
        if self.adapter.kind != "lm":
            return self.adapter.generate(self.params, batch, max_new_tokens)  # raises
        batch = _batch_to_device(batch, self.device)
        if self.scheme.spec_k:
            return self.adapter.generate(
                self.verify_params, batch, max_new_tokens, greedy=greedy, generator=generator,
                max_len=max_len,
                draft_params=self.params if self.scheme.spec_draft == "model" else None,
                spec_k=self.scheme.spec_k, spec_draft=self.scheme.spec_draft)
        return self.adapter.generate(self.params, batch, max_new_tokens, greedy=greedy,
                                     generator=generator, max_len=max_len)

    def serve(self, requests, *, n_slots: int = 4, max_len: int | None = None, mesh="auto",
              flash_decode: bool = False, metrics=None, trace=None) -> list:
        """Continuous-batching LM serving on the packed weights.

        ``requests`` is an iterable of ``(prompt_tokens, max_new_tokens)``
        pairs, prompts of any lengths (nothing is padded to a batch
        maximum). They are admitted into ``n_slots`` cache slots of one
        :class:`~repro_torch.serve.engine.ServeEngine` and the generated
        tokens come back as int32 numpy arrays in request order. ``max_len``
        is the per-slot cache capacity (default: the largest
        ``len(prompt) + max_new``). Speculative artifacts serve draft/verify
        rounds, token-identical to serving the verify tier alone.
        ``metrics``/``trace`` (an obs ``Registry`` / ``TraceLog``) turn on
        the engine's instrumentation. ``mesh`` is ``"auto"`` (an elastic mesh
        when the process group has more than one rank: every rank then calls
        this with the same requests and gets the same tokens), a
        ``DeviceMesh`` or None; ``flash_decode`` attends decode steps over the
        mesh's sequence-sharded cache. The paged cache and int8 K/V
        are :class:`~repro_torch.serve.engine.ServeEngine` options, as in the
        JAX package.
        """
        kw = dict(n_slots=n_slots, max_len=max_len, mesh=mesh, flash_decode=flash_decode,
                  metrics=metrics, trace=trace)
        if self.scheme.spec_k:
            return self.adapter.serve(
                self.verify_params, requests,
                draft_params=self.params if self.scheme.spec_draft == "model" else None,
                spec_k=self.scheme.spec_k, spec_draft=self.scheme.spec_draft, **kw)
        return self.adapter.serve(self.params, requests, **kw)

    def save(self, path: str) -> None:
        """Write the artifact directory, the manifest last (atomically).

        Layout, as the JAX package writes it: ``manifest.json`` (model,
        scheme, report, tree structure and a SHA-256 checksum per leaf),
        ``params/`` (a checkpoint-manager step holding the packed tree),
        ``calib.json`` (the calibration table of a static scheme) and
        ``verify_params/`` (the speculative verify tier, whose structure and
        checksums ride the manifest as ``verify_tree``/``verify_checksums``).
        """
        os.makedirs(path, exist_ok=True)
        checks = _checksums(self.params)
        CheckpointManager(os.path.join(path, _PARAMS_DIR), keep=1).save(0, self.params)
        if self.table is not None:
            self.table.save(os.path.join(path, _CALIB))
        manifest = {
            "format_version": ARTIFACT_VERSION,
            "kind": self.adapter.kind,
            "model": self.adapter.model_json(),
            "scheme": self.scheme.to_json(),
            "report": self.report.to_json() if self.report is not None else None,
            "tree": _tree_to_json(self.params),
            "checksums": checks,
            "has_calib": self.table is not None,
        }
        if self.verify_params is not None:
            manifest["verify_tree"] = _tree_to_json(self.verify_params)
            manifest["verify_checksums"] = _checksums(self.verify_params)
            CheckpointManager(os.path.join(path, _VERIFY_DIR), keep=1).save(0, self.verify_params)
        tmp = os.path.join(path, _MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, os.path.join(path, _MANIFEST))

    @classmethod
    def load(cls, path: str, *, device=None) -> "QuantizedModel":
        """Load and verify a saved artifact, its tensors on ``device`` (default: the card).

        A missing file, a schema mismatch, an undeclared or missing leaf or
        a checksum failure raises :class:`ArtifactError`: a partly written
        or bit-flipped artifact never serves. A speculative scheme without
        its verify tier raises too (serving it would emit draft-tier tokens).
        """
        device = resolve_device(device)
        mf = os.path.join(path, _MANIFEST)
        try:
            with open(mf) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
            raise ArtifactError(f"unreadable QuantizedModel manifest at {mf}: {e}") from e
        if not isinstance(doc, dict) or doc.get("format_version") != ARTIFACT_VERSION:
            raise ArtifactError(
                f"unsupported artifact format_version "
                f"{doc.get('format_version') if isinstance(doc, dict) else doc!r} "
                f"(expected {ARTIFACT_VERSION})"
            )
        for key in ("kind", "model", "scheme", "tree", "checksums"):
            if key not in doc:
                raise ArtifactError(f"manifest missing required key {key!r}")
        try:
            if doc["kind"] == "cnn":
                adapter = CnnAdapter(CnnAdapter.model_from_json(doc["model"]))
            elif doc["kind"] == "lm":
                adapter = LmAdapter(LmAdapter.model_from_json(doc["model"]))
            else:
                raise ValueError(f"unknown artifact kind {doc['kind']!r}")
            scheme = QuantScheme.from_json(doc["scheme"])
            example = _tree_from_json(doc["tree"])
        except (TypeError, ValueError, KeyError) as e:
            raise ArtifactError(f"malformed artifact manifest: {e}") from e
        verify_example = None
        if scheme.spec_k:
            if "verify_tree" not in doc or "verify_checksums" not in doc:
                raise ArtifactError(
                    "artifact's scheme is speculative but the manifest has no verify tier "
                    "(verify_tree/verify_checksums): incomplete save"
                )
            try:
                verify_example = _tree_from_json(doc["verify_tree"])
            except (TypeError, ValueError, KeyError) as e:
                raise ArtifactError(f"malformed verify tree: {e}") from e

        params = _restore_checked(path, example, doc["checksums"], device)
        verify_params = None
        if verify_example is not None:
            verify_params = _restore_checked(path, verify_example, doc["verify_checksums"],
                                             device, verify=True)

        table = None
        if doc.get("has_calib"):
            try:
                table = CalibrationTable.load(os.path.join(path, _CALIB))
            except (OSError, json.JSONDecodeError, KeyError, TypeError) as e:
                raise ArtifactError(f"calibration table unreadable: {e}") from e
        report = None
        if doc.get("report") is not None:
            try:
                report = ConversionReport.from_json(doc["report"])
            except (TypeError, ValueError, KeyError) as e:
                raise ArtifactError(f"malformed conversion report: {e}") from e
        return cls(params, adapter, scheme, table=table, report=report,
                   verify_params=verify_params)


def load(path: str, *, device=None) -> QuantizedModel:
    """Module-level alias for :meth:`QuantizedModel.load`."""
    return QuantizedModel.load(path, device=device)


# ---------------------------------------------------------------------------
# Artifact plumbing
# ---------------------------------------------------------------------------
def _restore_checked(path: str, example, declared: dict, device, *, verify: bool = False):
    """The params (or, with ``verify``, the verify-tier) tree of the artifact at
    ``path``, its leaves held to the manifest's SHA-256 checksums;
    :class:`ArtifactError` otherwise."""
    directory = os.path.join(path, _VERIFY_DIR if verify else _PARAMS_DIR)
    restored = CheckpointManager(directory, keep=0).restore_latest(example, device=device)
    if restored is None:
        what = "verify-tier" if verify else "params"
        raise ArtifactError(f"{what} checkpoint under {path!r} is missing or unreadable")
    _, tree = restored
    flat = _flatten(tree)
    if set(flat) != set(declared):
        what = "verify-tier" if verify else "artifact"
        raise ArtifactError(
            f"{what} leaves {sorted(set(flat) ^ set(declared))} do not match the manifest"
        )
    for k, digest in _checksums(tree).items():
        if digest != declared[k]:
            what = "verify leaf" if verify else "leaf"
            raise ArtifactError(f"checksum mismatch for {what} {k!r}: artifact corrupted")
    return tree


def _checksums(tree) -> dict[str, str]:
    """Each leaf's :func:`_leaf_sha256` by checkpoint key, hashed on a few threads
    (the device copy and SHA-256 release the GIL; an LM tree is gigabytes)."""
    flat = _flatten(tree)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        return dict(zip(flat, pool.map(_leaf_sha256, flat.values())))


def _leaf_sha256(v) -> str:
    """SHA-256 of a leaf's raw bytes, as the JAX package hashes them (bfloat16:
    its 2-byte values)."""
    return hashlib.sha256(np.ascontiguousarray(leaf_to_numpy(v))).hexdigest()


def _tree_to_json(tree: Any):
    """Structure-only description of a params tree (for the manifest)."""
    if isinstance(tree, Mapping):
        return {"kind": "dict", "items": {str(k): _tree_to_json(v) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"kind": "tuple" if isinstance(tree, tuple) else "list",
                "items": [_tree_to_json(v) for v in tree]}
    if isinstance(tree, PackedWeight):
        return {
            "kind": "packed",
            "fmt": tree.fmt_name,
            "nibble": bool(tree.nibble),
            "shape": list(tree.shape),
            "source_shape": list(tree.source_shape) if tree.source_shape else None,
            "act_scale": tree.act_scale,
            "act_bits": tree.act_bits,
        }
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return {"kind": "array", "shape": list(tree.shape), "dtype": _dtype_name(tree)}
    raise TypeError(f"cannot serialize tree node of type {type(tree).__name__}")


def _tree_from_json(doc) -> Any:
    """The example tree (structure and PackedWeight fields) a manifest describes.

    Leaf values are placeholders: the checkpoint manager restores the
    stored arrays by key.
    """
    if not isinstance(doc, dict) or "kind" not in doc:
        raise ValueError(f"malformed tree node {doc!r}")
    kind = doc["kind"]
    if kind == "dict":
        return {k: _tree_from_json(v) for k, v in doc["items"].items()}
    if kind in ("list", "tuple"):
        items = [_tree_from_json(v) for v in doc["items"]]
        return tuple(items) if kind == "tuple" else items
    if kind == "packed":
        return PackedWeight(
            codes=torch.zeros(0, dtype=torch.uint8),
            sf=torch.zeros(0),
            fmt_name=str(doc["fmt"]),
            nibble=bool(doc["nibble"]),
            shape=tuple(int(v) for v in doc["shape"]),
            source_shape=(
                tuple(int(v) for v in doc["source_shape"]) if doc.get("source_shape") else None
            ),
            act_scale=doc.get("act_scale"),
            act_bits=doc.get("act_bits"),
        )
    if kind == "array":
        return torch.zeros(0)
    raise ValueError(f"unknown tree node kind {kind!r}")

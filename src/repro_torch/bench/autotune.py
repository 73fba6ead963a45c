"""The autotuner behind ``impl="auto"``, ``block_sizes="auto"`` and flash-decode's ``block_s``.

The JAX package's ``repro/bench/autotune.py`` on the port's kernels. Per
``(M, K, N, fmt, code layout, backend)`` it times each implementation in
:data:`IMPLS` and keeps one entry per impl in a JSON cache; the dispatch
(:func:`repro_torch.kernels.ops.quantized_matmul` with ``impl="auto"``,
hence ``quantized_conv2d`` and every packed LM matmul) resolves a shape to
its measured winner with a dict lookup, and falls back to its heuristic on
a miss.

What is raced differs from the reference, because the port's CUDA kernels
take no tile arguments: each wrapper picks its own tiles and split-K. The
candidates are the two kernels, ``"tiled"`` (``elp_bsd_matmul``) and
``"fused"`` (``fused_decode_matmul``, only where ``M <= MAX_FUSED_M``), on
the route that ``route()`` picks for x's dtype, one candidate each, its
``blocks`` recording :data:`DEFAULT_BLOCKS`. The reference's ``xla`` impl
(dequantize, then a library matmul) is ``"library"`` here: the dequantized
weight times ``torch.matmul``. It is timed and written to the cache, but
:func:`lookup_impl` never returns it, so cuBLAS never takes a hand-written
kernel's place on the main path. Reference impl names map as
``pallas -> tiled``, ``pallas_fused -> fused``, ``xla -> library``.

On the card each candidate is the median of 7 launches, each with a cold
L2 (:func:`repro_torch.bench.harness.device_time_us`).

Cache layout (schema 2, the reference's keys)::

    {"schema_version": 2,
     "entries": {"cuda|tiled|elp_bsd_a4|nib|128x4096x4096":
                   {"blocks": [128, 128, 128], "wall_us": 61.2, "candidates": 1,
                    "bit_stable": true, "route": "wgmma"},
                 "cuda|flash_decode|attn|s4096|16x32x128":
                   {"blocks": [1, 512, 1], "wall_us": 812.0, ...}, ...}}

Key axes, in order: backend (``"cuda"`` or ``"cpu"``), impl, format, code
layout (``nib``/``u8``), shape. Schema 1 keys (no impl segment) migrate on
read to ``impl="tiled"`` without their ``wall_us`` (they never raced the
other impls). The file lives at ``build/autotune_cache.json`` (``build/`` is
not committed, so no host's timings ride in the tree);
``REPRO_TORCH_AUTOTUNE_CACHE`` names another path. On a miss every lookup
returns what the dispatch does without a cache.
"""
from __future__ import annotations

import json
import os
from typing import Iterable, Sequence

import torch

from repro_torch.kernels.fused_decode import MAX_FUSED_M

DEFAULT_BLOCKS = (128, 128, 128)
IMPLS = ("tiled", "fused", "library")
VOTING = ("tiled", "fused")  # the impls lookup_impl may return
CACHE_SCHEMA_VERSION = 2
CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
DEFAULT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))),
    "build", "autotune_cache.json")

# The parsed file, keyed by path, so a caller that repoints CACHE_ENV never
# reads another file's entries.
_loaded: dict[str, dict] = {}


def cache_path() -> str:
    return os.environ.get(CACHE_ENV, DEFAULT_CACHE)


def default_backend() -> str:
    """The backend an entry point runs on by default: ``"cuda"`` with a card."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def backend_of(t: torch.Tensor) -> str:
    """The cache backend of a call on ``t``: its device type, ``"cuda"`` for a
    ``meta`` tensor (the dry-run counts what the card would run)."""
    return "cuda" if t.device.type == "meta" else t.device.type


def cache_key(m: int, k: int, n: int, fmt_name: str, nibble: bool, backend: str,
              impl: str = "tiled") -> str:
    return f"{backend}|{impl}|{fmt_name}|{'nib' if nibble else 'u8'}|{m}x{k}x{n}"


def flash_cache_key(b: int, h: int, hd: int, s: int, backend: str) -> str:
    """Key of a flash-decode sequence-chunk entry (``blocks[1]`` = the chunk)."""
    return f"{backend}|flash_decode|attn|s{s}|{b}x{h}x{hd}"


def _valid_entry(ent) -> bool:
    if not isinstance(ent, dict):
        return False
    blocks = ent.get("blocks")
    return (isinstance(blocks, list) and len(blocks) == 3
            and all(isinstance(b, int) and b > 0 for b in blocks))


def _migrate_v1(key: str, ent: dict) -> tuple[str, dict] | None:
    """v1 ``backend|fmt|mode|MxKxN`` -> v2 with ``impl="tiled"`` spliced in.

    v1 entries timed the tiled kernel's block candidates only, so they land
    there, without their ``wall_us``: it never raced the other impls, and
    letting it vote in :func:`lookup_impl` would elect the tiled kernel
    unopposed. They keep steering :func:`lookup_blocks`.
    """
    parts = key.split("|")
    if len(parts) != 4:
        return None
    backend, fmt, mode, shape = parts
    return f"{backend}|tiled|{fmt}|{mode}|{shape}", {k: v for k, v in ent.items()
                                                     if k != "wall_us"}


def _read_cache(path: str) -> dict:
    """The parsed ``entries``; a corrupt or missing file reads as empty.

    The cache only steers dispatch, so a bad file degrades to the defaults
    instead of taking down a call that asked for ``"auto"``.
    """
    if path in _loaded:
        return _loaded[path]
    entries: dict = {}
    try:
        with open(path) as f:
            doc = json.load(f)
        version = doc.get("schema_version") if isinstance(doc, dict) else None
        if version in (1, CACHE_SCHEMA_VERSION):
            raw = doc.get("entries", {})
            if isinstance(raw, dict):
                for key, ent in raw.items():
                    if not _valid_entry(ent):
                        continue
                    if version == 1:
                        migrated = _migrate_v1(key, ent)
                        if migrated is None:
                            continue
                        key, ent = migrated
                    entries[key] = ent
    except (OSError, json.JSONDecodeError):
        entries = {}
    _loaded[path] = entries
    return entries


def invalidate_memory_cache() -> None:
    """Drop the parsed cache (after pointing CACHE_ENV elsewhere or an outside write)."""
    _loaded.clear()


def cache_entries() -> dict[str, dict]:
    """A copy of the parsed cache, keyed by :func:`cache_key` strings."""
    return dict(_read_cache(cache_path()))


def lookup_blocks(m: int, k: int, n: int, *, fmt_name: str, nibble: bool,
                  backend: str | None = None, impl: str = "tiled") -> tuple[int, int, int]:
    """``(block_m, block_n, block_k)`` of a shape and impl: the exact key's
    entry, else :data:`DEFAULT_BLOCKS` (never raises)."""
    backend = backend or default_backend()
    ent = _read_cache(cache_path()).get(cache_key(m, k, n, fmt_name, nibble, backend, impl))
    if ent is None:
        return DEFAULT_BLOCKS
    bm, bn, bk = ent["blocks"]
    if nibble and bk % 2:
        return DEFAULT_BLOCKS
    return (bm, bn, bk)


def lookup_impl(m: int, k: int, n: int, *, fmt_name: str, nibble: bool,
                backend: str | None = None) -> tuple[str | None, tuple[int, int, int]]:
    """The measured-best kernel ``(impl, blocks)`` of a shape, or ``(None, defaults)``.

    Of the :data:`VOTING` impls' entries with a recorded ``wall_us`` the
    smallest wins; ``"fused"`` only where ``m <= MAX_FUSED_M``, the decode-step
    kernel's limit. ``None``: nobody tuned this shape on this backend, and the
    caller takes its heuristic.
    """
    entries = _read_cache(cache_path())
    if not entries:  # every call of the dispatch asks: keep a cacheless run's cheap
        return None, DEFAULT_BLOCKS
    backend = backend or default_backend()
    best: tuple[str, float, list] | None = None
    for impl in VOTING:
        if impl == "fused" and m > MAX_FUSED_M:
            continue
        ent = entries.get(cache_key(m, k, n, fmt_name, nibble, backend, impl))
        if ent is None:
            continue
        wall = ent.get("wall_us")
        if not isinstance(wall, (int, float)) or isinstance(wall, bool):
            continue
        if best is None or wall < best[1]:
            best = (impl, float(wall), ent["blocks"])
    if best is None:
        return None, DEFAULT_BLOCKS
    bm, bn, bk = best[2]
    if nibble and bk % 2:
        return best[0], DEFAULT_BLOCKS
    return best[0], (bm, bn, bk)


def lookup_flash_block_s(b: int, h: int, hd: int, s: int, *,
                         backend: str | None = None) -> int | None:
    """The tuned flash-decode sequence chunk, or ``None`` (the one-shot slice).

    A miss keeps the untuned path as it was; a chunk applies only where it
    divides ``s`` and is smaller than it (0 is the one-shot sentinel).
    """
    backend = backend or default_backend()
    ent = _read_cache(cache_path()).get(flash_cache_key(b, h, hd, s, backend))
    if ent is None:
        return None
    block_s = ent["blocks"][1]
    if block_s <= 0 or s % block_s or block_s >= s:
        return None
    return block_s


def _check_backend(backend: str | None, device: torch.device) -> str:
    # The measurement runs on `device`; storing it under another backend's
    # keys would steer that backend's dispatch with foreign timings.
    if backend is not None and backend != device.type:
        raise ValueError(f"cannot tune for backend {backend!r} on {device}; run the tuner "
                         "on the target backend")
    return device.type


def autotune_matmul(
    m: int,
    k: int,
    n: int,
    fmt,
    *,
    nibble: bool | None = None,
    dtype: torch.dtype = torch.float32,
    iters: int = 7,
    warmup: int = 1,
    seed: int = 0,
    backend: str | None = None,
    write: bool = True,
    device=None,
) -> dict:
    """Time every impl of :data:`IMPLS` at one shape and (with ``write``) merge one
    entry per impl into the cache.

    A seeded activation ``x[m, k]`` of ``dtype`` and a weight packed from a
    seeded normal ``[k, n]`` (no Algorithm 1, as the reference; both drawn by
    a generator on ``device``) go through
    ``quantized_matmul(impl="tiled"/"fused")`` and ``torch.matmul`` on the
    weight dequantized beforehand (float32 without TF32). Returns the voting
    winner ``{"key", "impl", "blocks", "wall_us", "candidates", "bit_stable",
    "route", "ranking"}``, ``ranking`` every impl's time, fastest first.
    """
    from repro_torch.core.elp_bsd import resolve_format
    from repro_torch.device import full_f32, resolve_device
    from repro_torch.kernels.elp_bsd_matmul import route
    from repro_torch.kernels.ops import dequantize, pack_weight, quantized_matmul

    from repro_torch.bench.harness import device_time_us

    fmt = resolve_format(fmt)
    device = resolve_device(device)
    backend = _check_backend(backend, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(m, k, generator=gen, device=device).to(dtype)
    w = torch.randn(k, n, generator=gen, device=device) * 0.02
    pw, _ = pack_weight(w, fmt, compensate=False, nibble=nibble)
    wq = dequantize(pw).to(dtype)
    del w
    kernel_route = route(x, fmt) if device.type == "cuda" else "plain"
    calls = {"tiled": lambda: quantized_matmul(x, pw, impl="tiled")}
    if m <= MAX_FUSED_M:
        calls["fused"] = lambda: quantized_matmul(x, pw, impl="fused")
    calls["library"] = lambda: torch.matmul(x, wq)
    with torch.no_grad(), full_f32():
        ranking = [{"impl": impl, "blocks": list(DEFAULT_BLOCKS),
                    "wall_us": device_time_us(fn, iters=iters, warmup=warmup, device=device)}
                   for impl, fn in calls.items()]
    ranking.sort(key=lambda r: r["wall_us"])
    new_entries = {
        cache_key(m, k, n, fmt.name, pw.nibble, backend, r["impl"]): {
            "blocks": r["blocks"], "wall_us": r["wall_us"], "candidates": 1, "bit_stable": True,
            "route": kernel_route if r["impl"] in VOTING else "torch.matmul",
        }
        for r in ranking
    }
    if write:
        write_entries(new_entries)
    winner = next(r for r in ranking if r["impl"] in VOTING)
    return {
        "key": cache_key(m, k, n, fmt.name, pw.nibble, backend, winner["impl"]),
        "impl": winner["impl"],
        "blocks": winner["blocks"],
        "wall_us": winner["wall_us"],
        "candidates": len(ranking),
        "bit_stable": True,
        "route": kernel_route,
        "ranking": ranking,
    }


def autotune_flash_decode(
    b: int,
    s: int,
    h: int,
    hd: int,
    *,
    kv: int | None = None,
    dtype: torch.dtype = torch.float32,
    pctx=None,
    iters: int = 7,
    warmup: int = 1,
    seed: int = 0,
    backend: str | None = None,
    chunks: Sequence[int] = (128, 256, 512),
    write: bool = True,
    device=None,
) -> dict:
    """Time the flash-decode sequence chunks at ``b`` rows x ``h`` heads x ``hd`` over
    ``s`` cached positions and (with ``write``) store the winner.

    Candidate 0 is the one-shot slice (the untuned path); the chunks of
    ``chunks`` that divide this rank's slice ``s_loc = s / model_size`` and
    are smaller than it stream it through the running softmax combine. The
    rank's slice of a seeded ``[b, s, kv, hd]`` cache of ``dtype`` is attended
    at position ``s - 1`` over ``pctx`` (default: ``elastic.make_mesh()`` on
    ``device``). The winner lands under :func:`flash_cache_key` with the chunk
    in ``blocks[1]``.
    """
    from repro_torch.device import resolve_device
    from repro_torch.models.context import ParallelCtx
    from repro_torch.models.flash_decode import flash_decode_attention

    from repro_torch.bench.harness import device_time_us

    device = resolve_device(device)
    backend = _check_backend(backend, device)
    kv = kv or h
    if pctx is None:
        from repro_torch.runtime.elastic import make_mesh

        pctx = ParallelCtx(mesh=make_mesh(device=device), flash_decode=True)
    s_loc = s // pctx.model_size
    gen = torch.Generator(device=device).manual_seed(seed)

    def seeded(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    q = seeded(b, 1, h, hd)
    ck, cv = seeded(b, s, kv, hd), seeded(b, s, kv, hd)
    lo = pctx.model_rank * s_loc
    ck, cv = ck[:, lo:lo + s_loc].contiguous(), cv[:, lo:lo + s_loc].contiguous()
    cands = [0] + [c for c in chunks if 0 < c < s_loc and s_loc % c == 0]
    ranking = []
    with torch.no_grad():
        for block_s in cands:
            fn = lambda bs=block_s: flash_decode_attention(  # noqa: E731
                q, ck, cv, s - 1, pctx=pctx, block_s=bs)
            ranking.append({"block_s": block_s, "wall_us": device_time_us(
                fn, iters=iters, warmup=warmup, device=device)})
    ranking.sort(key=lambda r: r["wall_us"])
    best = ranking[0]
    key = flash_cache_key(b, h, hd, s, backend)
    entry = {"blocks": [1, int(best["block_s"]), 1], "wall_us": best["wall_us"],
             "candidates": len(ranking), "bit_stable": best["block_s"] == 0}
    if write:
        write_entries({key: entry})
    return {"key": key, "ranking": ranking, **entry}


def sweep_nibble(m: int, k: int, n: int, fmt, **kw) -> list[dict]:
    """Tune a 4-bit shape in both storage modes (u8 and nibble), each under its own keys."""
    return [autotune_matmul(m, k, n, fmt, nibble=nib, **kw) for nib in (False, True)]


def write_entries(new_entries: dict) -> None:
    """Merge entries into the cache file (read, update, atomic rename).

    Unlike the read path, which degrades a corrupt file to "no cache", a
    write REFUSES to go over an existing file it cannot parse: merging into
    the empty fallback would wipe every entry the file held. Delete or fix
    the file first. A readable schema-1 file is migrated and rewritten as 2.
    """
    path = cache_path()
    if os.path.exists(path):
        try:
            with open(path) as f:
                doc = json.load(f)
            ok = isinstance(doc, dict) and doc.get("schema_version") in (1, CACHE_SCHEMA_VERSION)
        except (OSError, json.JSONDecodeError):
            ok = False
        if not ok:
            raise RuntimeError(f"refusing to overwrite unreadable/foreign autotune cache {path}; "
                               "delete it (or fix the JSON / schema_version) and re-run")
    entries = dict(_read_cache(path))
    entries.update(new_entries)
    doc = {"schema_version": CACHE_SCHEMA_VERSION, "entries": dict(sorted(entries.items()))}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    _loaded[path] = entries


def autotune_shapes(shapes: Iterable[tuple], **kw) -> list[dict]:
    """Tune a batch of ``(m, k, n, fmt, nibble)`` specs (``--autotune``)."""
    return [autotune_matmul(m, k, n, fmt, nibble=nib, **kw) for m, k, n, fmt, nib in shapes]

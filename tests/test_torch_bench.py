"""The port's ``bench/`` against the JAX package's, on the CPU.

Held here, each against ``repro.bench`` on the same inputs:

* the registries (names, tiers, tags, ``autotune_shape`` s) and the ``shape``
  and ``bytes`` blocks of the smallest smoke entries (the grid of the
  reference's own smallest-entry test, one interpret-mode step);
* the run-document validators on the same good and mutated documents
  (``jax_version`` / ``torch_version`` mapped), and the regression gate on the
  same pairs of synthetic documents (impl keys mapped: ``pallas`` -> ``tiled``,
  ``pallas_fused`` -> ``fused``, ``xla`` -> ``library``);
* the autotune cache: a miss, write then hit, the disk round trip, merging,
  corrupt files, the refusal to clobber one, the v1 migration, the winner
  lookup and flash-decode's chunk rule;
* the dispatch on a cache: ``quantized_matmul(impl="auto")``,
  ``quantized_conv2d`` and ``flash_decode_attention`` against the reference's
  on mapped winners (rtol 1e-5 / atol 1e-4 for the matmuls, as in
  ``test_torch_kernels.py``; 1e-5 of max |out| for flash-decode, as in
  ``test_torch_distributed.py``), ``report.tuned_blocks`` and
  ``ServeEngine.kernel_dispatch`` against the reference's on the same cache;
* ``python -m repro_torch.bench`` end to end on one small workload.

Every cache and document lives in ``tmp_path``: nothing reads the committed
``BENCH_*.json`` or the reference's ``autotune_cache.json``. The card's twins
are in ``tests/test_torch_bench_gpu.py``.
"""
import copy
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch_parity as tp  # noqa: E402
from repro.bench import autotune as jat  # noqa: E402
from repro.bench import registry as jreg  # noqa: E402
from repro.bench import schema as jschema  # noqa: E402
from repro.bench.__main__ import _collect_ratios as j_ratios  # noqa: E402
from repro.bench.__main__ import _gate as j_gate  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.bench import __main__ as tcli  # noqa: E402
from repro_torch.bench import autotune as tat  # noqa: E402
from repro_torch.bench import registry as treg  # noqa: E402
from repro_torch.bench import schema as tschema  # noqa: E402
from repro_torch.interop import packed_from_numpy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-4)
IMPL_MAP = {"pallas": "tiled", "pallas_fused": "fused", "xla": "library", "auto": "auto"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test runner puts several workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """Both packages' autotune caches pointed at fresh files in ``tmp_path``."""
    paths = (str(tmp_path / "jax_cache.json"), str(tmp_path / "torch_cache.json"))
    monkeypatch.setenv(jat.CACHE_ENV, paths[0])
    monkeypatch.setenv(tat.CACHE_ENV, paths[1])
    jat.invalidate_memory_cache()
    tat.invalidate_memory_cache()
    yield paths
    jat.invalidate_memory_cache()
    tat.invalidate_memory_cache()


def _write_both(entries: dict) -> None:
    """Write the same entries into both caches, keyed with each package's impl name."""
    jat.write_entries(entries)
    tat.write_entries({_map_key(k): v for k, v in entries.items()})


def _map_key(key: str) -> str:
    parts = key.split("|")
    if len(parts) == 5 and parts[1] in IMPL_MAP:
        parts[1] = IMPL_MAP[parts[1]]
    return "|".join(parts)


# ---------------------------------------------------------------------------
# Registry and documents
# ---------------------------------------------------------------------------
def test_registries_match_reference():
    for suite in ("kernels", "e2e"):
        want = [(s.name, s.tier, s.tags, s.autotune_shape) for s in jreg.specs(suite)]
        got = [(s.name, s.tier, s.tags, s.autotune_shape) for s in treg.specs(suite)]
        assert got == want
        assert ([s.name for s in treg.specs(suite, smoke_only=True)]
                == [s.name for s in jreg.specs(suite, smoke_only=True)])
    assert treg.specs("kernels", only="conv2d/")
    with pytest.raises(KeyError):
        treg.get("not/a/workload")
    from repro.bench.workloads import autotune_shape_specs as j_shapes
    from repro_torch.bench.workloads import autotune_shape_specs as t_shapes

    # the reference skips shapes too large for interpret-mode timing on the CPU
    assert set(j_shapes()) <= set(t_shapes())


@pytest.mark.parametrize("name", ["matmul/elp_bsd_a4/nib/8x128x10",
                                  "matmul/elp_bsd_c6/u8/8x128x10"])
def test_smallest_smoke_entry_shape_and_bytes(name):
    want = jreg.get(name).run(1, 1)
    got = treg.get(name).run(1, 1, torch.device("cpu"))
    assert got["shape"] == want["shape"]
    assert got["bytes"] == want["bytes"]
    assert got["workload"] == want["workload"]
    assert set(got["wall_us"]) == {IMPL_MAP.get(k, k) for k in want["wall_us"]}
    assert got["wall_us"]["selected"]["impl"] == "fused"  # the cacheless heuristic at M = 8
    np.testing.assert_allclose(got["quality"]["out_mse"], want["quality"]["out_mse"], rtol=1e-3)
    tschema.validate({"schema_version": 1, "suite": "kernels", "backend": "cpu",
                      "torch_version": torch.__version__, "smoke_only": True,
                      "entries": {name: {**got, "tier": "smoke"}}})


def _doc(version_key: str) -> dict:
    return {
        "schema_version": 1,
        "suite": "kernels",
        "backend": "cpu",
        version_key: "0.0.test",
        "smoke_only": True,
        "entries": {
            "matmul/x": {
                "workload": "matmul",
                "tier": "smoke",
                "shape": {"m": 8, "k": 16, "n": 4, "fmt": "f", "dims": [8, 16, 4]},
                "wall_us": {"xla": {"median_us": 1.0, "min_us": 0.5, "iters": 3, "warmup": 1},
                            "pallas": None},
                "hlo": {"flops": 1.0, "bytes_accessed": None, "collective_bytes": 0.0},
                "quality": {"out_mse": 0.1},
                "bytes": None,
            }
        },
    }


def _entry(d):
    return d["entries"]["matmul/x"]


MUTATIONS = {
    "good": lambda d: None,
    "version": lambda d: d.update(schema_version=2),
    "suite": lambda d: d.update(suite="vibes"),
    "no-entries": lambda d: d.update(entries={}),
    "no-smoke-flag": lambda d: d.pop("smoke_only"),
    "empty-backend": lambda d: d.update(backend=""),
    "bad-tier": lambda d: _entry(d).update(tier="warm"),
    "empty-shape": lambda d: _entry(d).update(shape={}),
    "bool-shape": lambda d: _entry(d)["shape"].update(m=True),
    "no-wall": lambda d: _entry(d).update(wall_us={}),
    "negative-median": lambda d: _entry(d)["wall_us"]["xla"].update(median_us=-1),
    "missing-iters": lambda d: _entry(d)["wall_us"]["xla"].pop("iters"),
    "bool-iters": lambda d: _entry(d)["wall_us"]["xla"].update(iters=True),
    "hlo-missing-keys": lambda d: _entry(d).update(hlo={"flops": 1.0}),
    "non-numeric-quality": lambda d: _entry(d).update(quality={"mse": "tiny"}),
    "null-bytes-value": lambda d: _entry(d).update(bytes={"w": None}),
}


@pytest.mark.parametrize("mutation", list(MUTATIONS) + ["no-version", "empty-version",
                                                        "suite-mismatch"])
def test_validators_agree(mutation):
    verdicts = []
    for schema, version_key in ((jschema, "jax_version"), (tschema, "torch_version")):
        doc = _doc(version_key)
        suite = None
        if mutation == "no-version":
            doc.pop(version_key)
        elif mutation == "empty-version":
            doc[version_key] = ""
        elif mutation == "suite-mismatch":
            suite = "e2e"
        else:
            MUTATIONS[mutation](doc)
        doc_t = copy.deepcopy(doc)
        for e in doc_t["entries"].values():
            e["wall_us"] = {IMPL_MAP.get(k, k): v for k, v in e["wall_us"].items()}
        try:
            schema.validate(doc if schema is jschema else doc_t, suite=suite)
            verdicts.append("ok")
        except (jschema.SchemaError, tschema.SchemaError) as err:
            verdicts.append(type(err).__name__)
    assert verdicts[0] == verdicts[1]
    assert (verdicts[0] == "ok") == (mutation == "good")
    # each package's document names its own framework's version
    if mutation == "good":
        with pytest.raises(tschema.SchemaError, match="torch_version"):
            tschema.validate(_doc("jax_version"))


def _gate_docs(case: str):
    """(new, base) documents of the reference's impl keys for one gate case."""
    def doc(times: dict, backend="cpu", sel_impl="pallas_fused"):
        entries = {}
        for name, (group, impls) in times.items():
            wall = {}
            for impl, us in impls.items():
                wall[impl] = {"median_us": us, "min_us": us, "iters": 3, "warmup": 1}
                if impl == "selected":
                    wall[impl]["impl"] = sel_impl
            entries[name] = {"workload": group, "wall_us": wall}
        return {"backend": backend, "entries": entries}

    base_times = {
        f"{g}/{i}": (g, {"xla": 1000.0 * (i + 1), "pallas": 2000.0, "selected": 1000.0})
        for g in ("matmul", "conv2d", "cnn_fwd") for i in range(3)
    }

    def scaled(f, only=None, impl=None):
        return {n: (g, {k: us * (f if (only in (None, g)) and impl in (None, k) else 1.0)
                        for k, us in t.items()}) for n, (g, t) in base_times.items()}

    base = doc(base_times)
    if case == "same":
        return doc(base_times), base
    if case == "uniform-drift":
        return doc(scaled(2.0)), base
    if case == "group-regression":
        return doc(scaled(1.6, only="conv2d")), base
    if case == "catastrophic-entry":
        t = scaled(1.0)
        t["matmul/0"][1]["xla"] *= 3.0
        return doc(t), base
    if case == "cpu-skips-pallas":
        return doc(scaled(5.0, impl="pallas")), base
    if case == "tpu-gates-pallas":
        return doc(scaled(5.0, impl="pallas"), backend="tpu"), doc(base_times, backend="tpu")
    if case == "selected-same-impl":
        return doc(scaled(3.0, only="matmul", impl="selected")), base
    if case == "selected-flip":
        return doc(scaled(3.0, only="matmul", impl="selected"), sel_impl="xla"), base
    if case == "under-min-us":
        t = {n: (g, {k: us / 100.0 for k, us in ts.items()}) for n, (g, ts) in base_times.items()}
        return doc(scaled(3.0)), doc(t)
    raise ValueError(case)


def _map_doc(d: dict) -> dict:
    d = copy.deepcopy(d)
    if d["backend"] == "tpu":
        d["backend"] = "cuda"
    for e in d["entries"].values():
        e["wall_us"] = {IMPL_MAP.get(k, k): v for k, v in e["wall_us"].items()}
        sel = e["wall_us"].get("selected")
        if sel:
            sel["impl"] = IMPL_MAP[sel["impl"]]
    return d


@pytest.mark.parametrize("case", ["same", "uniform-drift", "group-regression",
                                  "catastrophic-entry", "cpu-skips-pallas", "tpu-gates-pallas",
                                  "selected-same-impl", "selected-flip", "under-min-us"])
def test_gate_verdicts_match_reference(case):
    new, base = _gate_docs(case)
    jr = j_ratios(new, base, 200.0)
    tr = tcli._collect_ratios(_map_doc(new), _map_doc(base), 200.0)
    assert [(g, n, IMPL_MAP.get(i, i), b, u, r, eg) for g, n, i, b, u, r, eg in jr] == tr
    jf, tf = j_gate(jr, 0.20), tcli._gate(tr, 0.20)
    assert len(tf) == len(jf)
    assert [f.split(" ")[:2] for f in tf] == [f.split(" ")[:2] for f in jf]


# ---------------------------------------------------------------------------
# The autotune cache
# ---------------------------------------------------------------------------
def test_cache_paths_live_under_build():
    assert tat.DEFAULT_CACHE == str(REPO / "build" / "autotune_cache.json")
    assert tcli.OUT_DIR == str(REPO / "build" / "bench")
    assert tat.cache_key(1, 2, 3, "f", True, "cpu") == "cpu|tiled|f|nib|1x2x3"
    assert tat.flash_cache_key(4, 8, 64, 256, "cuda") == jat.flash_cache_key(4, 8, 64, 256,
                                                                              "cuda")
    for impl in jat.IMPLS:
        assert (tat.cache_key(1, 2, 3, "f", False, "cpu", IMPL_MAP[impl])
                == _map_key(jat.cache_key(1, 2, 3, "f", False, "cpu", impl=impl)))


def _lookups(mod, impl_name=lambda i: i):
    kw = dict(fmt_name="elp_bsd_a4", nibble=True, backend="cpu")
    impl, blocks = mod.lookup_impl(8, 512, 128, **kw)
    return (mod.lookup_blocks(8, 512, 128, **kw), impl and impl_name(impl), blocks,
            mod.lookup_flash_block_s(4, 8, 64, 256, backend="cpu"))


def _both_lookups():
    inverse = {v: k for k, v in IMPL_MAP.items()}
    return _lookups(jat), _lookups(tat, lambda i: inverse[i])


def test_cache_miss_hit_roundtrip_and_merge(caches):
    want, got = _both_lookups()
    assert got == want == (tat.DEFAULT_BLOCKS, None, tat.DEFAULT_BLOCKS, None)
    key = jat.cache_key(8, 512, 128, "elp_bsd_a4", True, "cpu", impl="pallas")
    _write_both({key: {"blocks": [256, 128, 128], "wall_us": 5.0}})
    want, got = _both_lookups()
    assert got == want == ((256, 128, 128), "pallas", (256, 128, 128), None)
    # disk round trip
    jat.invalidate_memory_cache()
    tat.invalidate_memory_cache()
    assert _both_lookups()[1] == want
    # merge: a second write keeps the first entry
    fkey = jat.flash_cache_key(4, 8, 64, 256, "cpu")
    _write_both({fkey: {"blocks": [1, 64, 1], "wall_us": 3.0}})
    jat.invalidate_memory_cache()
    tat.invalidate_memory_cache()
    want, got = _both_lookups()
    assert got == want == ((256, 128, 128), "pallas", (256, 128, 128), 64)
    assert sorted(tat.cache_entries()) == sorted(map(_map_key, jat.cache_entries()))
    with open(caches[1]) as f:
        assert json.load(f)["schema_version"] == 2


@pytest.mark.parametrize("content", ["not json {", "[]", '{"schema_version": 99, "entries": {}}',
                                     '{"schema_version": 2, "entries": {"k": {"blocks": [0, 1, 2]}}}',
                                     '{"schema_version": 2, "entries": []}'])
def test_corrupt_cache_degrades_and_refuses_clobber(caches, content):
    for path in caches:
        with open(path, "w") as f:
            f.write(content)
    want, got = _both_lookups()
    assert got == want == (tat.DEFAULT_BLOCKS, None, tat.DEFAULT_BLOCKS, None)
    writable = content.startswith('{"schema_version": 2')
    for mod, path in zip((jat, tat), caches):
        if writable:
            mod.write_entries({"k2": {"blocks": [128, 128, 128]}})
            continue
        with pytest.raises(RuntimeError, match="refusing to overwrite"):
            mod.write_entries({"k": {"blocks": [128, 128, 128]}})
        with open(path) as f:
            assert f.read() == content  # untouched


def test_v1_cache_migrates_blocks_but_not_votes(caches):
    doc = {"schema_version": 1, "entries": {
        "cpu|elp_bsd_a4|nib|8x512x128": {"blocks": [256, 256, 128], "wall_us": 1.0},
        "short|key": {"blocks": [128, 128, 128]}}}
    for path in caches:
        with open(path, "w") as f:
            json.dump(doc, f)
    want, got = _both_lookups()
    assert got == want == ((256, 256, 128), None, tat.DEFAULT_BLOCKS, None)
    assert list(tat.cache_entries()) == ["cpu|tiled|elp_bsd_a4|nib|8x512x128"]
    assert list(tat.cache_entries()) == list(map(_map_key, jat.cache_entries()))


@pytest.mark.parametrize("walls", [(900.0, 120.0, 150.0), (100.0, 300.0, 200.0),
                                   (900.0, 300.0, 100.0), (None, 50.0, None),
                                   (20.0, None, 10.0)])
def test_lookup_impl_winner(caches, walls):
    """The smallest recorded ``wall_us`` wins, as in the reference, except that the
    library call never does: where the reference's ``xla`` is fastest, the port
    takes the faster of its two kernels."""
    entries = {}
    for impl, wall in zip(("pallas", "pallas_fused", "xla"), walls):
        ent = {"blocks": [128, 256, 128]}
        if wall is not None:
            ent["wall_us"] = wall
        entries[jat.cache_key(8, 512, 128, "elp_bsd_a4", True, "cpu", impl=impl)] = ent
    _write_both(entries)
    kw = dict(fmt_name="elp_bsd_a4", nibble=True, backend="cpu")
    want, _ = jat.lookup_impl(8, 512, 128, **kw)
    got, blocks = tat.lookup_impl(8, 512, 128, **kw)
    kernels = {IMPL_MAP[i]: w for i, w in zip(("pallas", "pallas_fused"), walls) if w is not None}
    if want == "xla":
        assert got == min(kernels, key=kernels.get)
    else:
        assert got == IMPL_MAP[want]
    assert blocks == (128, 256, 128)
    # the decode-step kernel never wins past its M limit
    big = {tat.cache_key(300, 512, 128, "elp_bsd_a4", True, "cpu", "fused"):
           {"blocks": [128, 128, 128], "wall_us": 1.0}}
    tat.write_entries(big)
    assert tat.lookup_impl(300, 512, 128, **kw) == (None, tat.DEFAULT_BLOCKS)


@pytest.mark.parametrize("block_s", [0, 16, 64, 96, 128, 256, 512])
def test_lookup_flash_block_s_divisibility(caches, block_s):
    key = jat.flash_cache_key(4, 8, 64, 256, "cpu")
    _write_both({key: {"blocks": [1, block_s, 1], "wall_us": 5.0}})
    want = jat.lookup_flash_block_s(4, 8, 64, 256, backend="cpu")
    assert tat.lookup_flash_block_s(4, 8, 64, 256, backend="cpu") == want
    assert tat.lookup_flash_block_s(4, 8, 64, 999, backend="cpu") is None  # miss


def test_autotune_matmul_on_cpu(caches):
    res = tat.autotune_matmul(8, 64, 32, "elp_bsd_a4", iters=1, warmup=1, device="cpu")
    assert {r["impl"] for r in res["ranking"]} == set(tat.IMPLS)
    assert res["impl"] in tat.VOTING and res["route"] == "plain"
    assert res["wall_us"] == min(r["wall_us"] for r in res["ranking"] if r["impl"] in tat.VOTING)
    tat.invalidate_memory_cache()
    entries = tat.cache_entries()
    for impl in tat.IMPLS:
        assert entries[tat.cache_key(8, 64, 32, "elp_bsd_a4", True, "cpu", impl)]["blocks"] == [
            128, 128, 128]
    assert tat.lookup_impl(8, 64, 32, fmt_name="elp_bsd_a4", nibble=True,
                           backend="cpu")[0] == res["impl"]
    # past MAX_FUSED_M only the tiled kernel and the library call race
    big = tat.autotune_matmul(257, 64, 32, "elp_bsd_c6", iters=1, warmup=0, device="cpu",
                              write=False)
    assert {r["impl"] for r in big["ranking"]} == {"tiled", "library"} and big["impl"] == "tiled"
    results = tat.sweep_nibble(4, 64, 32, "elp_bsd_a4", iters=1, warmup=0, device="cpu")
    assert [r["key"].split("|")[3] for r in results] == ["u8", "nib"]
    with pytest.raises(ValueError, match="cannot tune for backend"):
        tat.autotune_matmul(8, 64, 32, "elp_bsd_a4", backend="cuda", device="cpu")


# ---------------------------------------------------------------------------
# Dispatch on the cache
# ---------------------------------------------------------------------------
@pytest.fixture
def spies(monkeypatch):
    """Which kernel wrapper ``quantized_matmul`` called: {"tiled": n, "fused": n}."""
    calls = {"tiled": 0, "fused": 0}
    for impl, name in (("tiled", "elp_bsd_matmul"), ("fused", "fused_decode_matmul")):
        real = getattr(tops, name)

        def spy(*a, _real=real, _impl=impl, **kw):
            calls[_impl] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(tops, name, spy)
    return calls


# JAX packing jitted once per shape (eager conversion compiles every op)
_j_pack = jax.jit(jops.pack_weight, static_argnums=(1,))
_j_pack_conv = jax.jit(jops.pack_conv_weight, static_argnums=(1,))


@pytest.mark.parametrize("winner", [None, "pallas", "pallas_fused"])
def test_quantized_matmul_auto_follows_the_cache(caches, spies, winner):
    rng = np.random.default_rng(2)
    m, k, n = 4, 512, 128
    x = rng.normal(size=(m, k)).astype(np.float32)
    jpw, _ = _j_pack(jnp.asarray(rng.normal(size=(k, n)) * 0.05, jnp.float32), "elp_bsd_a4")
    pw = packed_from_numpy(np.asarray(jpw.codes), np.asarray(jpw.sf), jpw.fmt_name, jpw.nibble,
                           jpw.shape, device="cpu")
    if winner is not None:
        _write_both({jat.cache_key(m, k, n, "elp_bsd_a4", True, "cpu", impl=winner):
                     {"blocks": [128, 128, 256], "wall_us": 1.0}})
    jops.quantized_matmul.clear_cache()  # the reference resolves "auto" at trace time
    want = np.asarray(jops.quantized_matmul(jnp.asarray(x), jpw, impl="auto",
                                            block_sizes="auto"))
    got = tops.quantized_matmul(torch.from_numpy(x), pw, impl="auto", block_sizes="auto")
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    expect = "fused" if winner in (None, "pallas_fused") else "tiled"  # miss: M <= 256
    assert spies == {"tiled": int(expect == "tiled"), "fused": int(expect == "fused")}
    assert tops.resolve_impl(m, pw, "cpu") == (expect, "heuristic" if winner is None
                                               else "autotuned")
    # a cached odd block_k for nibble codes reads as the defaults; a bad value raises
    _write_both({jat.cache_key(m, k, n, "elp_bsd_a4", True, "cpu", impl="pallas"):
                 {"blocks": [128, 128, 127], "wall_us": 0.5}})
    assert tat.lookup_blocks(m, k, n, fmt_name="elp_bsd_a4", nibble=True, backend="cpu",
                             impl="tiled") == tat.DEFAULT_BLOCKS
    tops.quantized_matmul(torch.from_numpy(x), pw, impl="tiled", block_sizes="auto")
    with pytest.raises(ValueError, match="block_sizes must be"):
        tops.quantized_matmul(torch.from_numpy(x), pw, block_sizes="fastest")


@pytest.mark.parametrize("winner", [None, "pallas", "pallas_fused"])
def test_quantized_conv2d_asks_at_the_im2col_shape(caches, spies, winner):
    from repro.kernels.conv import quantized_conv2d as j_conv
    from repro_torch.kernels.conv import quantized_conv2d as t_conv

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 8, 8)).astype(np.float32)
    jpw, _ = _j_pack_conv(jnp.asarray(rng.normal(size=(3, 3, 8, 16)) * 0.1, jnp.float32),
                          "elp_bsd_a4")
    pw = packed_from_numpy(np.asarray(jpw.codes), np.asarray(jpw.sf), jpw.fmt_name, jpw.nibble,
                           jpw.shape, jpw.source_shape, device="cpu")
    m = 2 * 4 * 4  # B * Ho * Wo at stride 2
    if winner is not None:
        _write_both({jat.cache_key(m, 72, 16, "elp_bsd_a4", True, "cpu", impl=winner):
                     {"blocks": [128, 128, 128], "wall_us": 1.0}})
    jops.quantized_matmul.clear_cache()
    want = np.asarray(j_conv(jnp.asarray(x), jpw, stride=2, impl="auto"))
    got = t_conv(torch.from_numpy(x), pw, stride=2, impl="auto")
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    expect = "tiled" if winner == "pallas" else "fused"
    assert spies[expect] == 1 and sum(spies.values()) == 1


@pytest.mark.parametrize("tuned", [None, 16, 24])
def test_flash_decode_looks_up_its_chunk(caches, monkeypatch, tuned):
    from repro.models.context import ParallelCtx as JCtx
    from repro.models.flash_decode import flash_decode_attention as j_fd
    from repro_torch.models import flash_decode as tfd
    from repro_torch.models.context import ParallelCtx
    from repro_torch.runtime.elastic import make_mesh

    b, smax, h, kv, hd = 2, 64, 4, 2, 16
    rng = np.random.default_rng(4)
    q = rng.normal(size=(b, 1, h, hd)).astype(np.float32)
    ck, cv = (rng.normal(size=(b, smax, kv, hd)).astype(np.float32) for _ in range(2))
    if tuned is not None:
        _write_both({jat.flash_cache_key(b, h, hd, smax, "cpu"):
                     {"blocks": [1, tuned, 1], "wall_us": 3.0}})
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jctx = JCtx(mesh=jmesh, batch_axes=("data",), model_axis="model", flash_decode=True)
    with jmesh:  # one jit: the lookup runs at trace time, after the cache is written
        want = np.asarray(jax.jit(lambda *a: j_fd(*a, pctx=jctx))(
            jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.int32(49)))
    seen = []
    real = tfd._local_stats

    def spy(*a, block_s, **kw):
        seen.append(block_s)
        return real(*a, block_s=block_s, **kw)

    monkeypatch.setattr(tfd, "_local_stats", spy)
    with tp.cpu_group():
        pctx = ParallelCtx(mesh=make_mesh(device="cpu"), flash_decode=True)
        got = tfd.flash_decode_attention(torch.from_numpy(q), torch.from_numpy(ck),
                                         torch.from_numpy(cv), 49, pctx=pctx).numpy()
        if tuned is None:
            res = tat.autotune_flash_decode(b, smax, h, hd, kv=kv, pctx=pctx, chunks=(16, 32),
                                            iters=1, warmup=0, device="cpu")
            assert [r["block_s"] for r in sorted(res["ranking"], key=lambda r: r["block_s"])] == [
                0, 16, 32]
            tat.invalidate_memory_cache()
            assert tat.lookup_flash_block_s(b, h, hd, smax, backend="cpu") == (
                res["blocks"][1] or None)
    assert seen[0] == jat.lookup_flash_block_s(b, h, hd, smax, backend="cpu")
    assert seen[0] == (None if tuned in (None, 24) else tuned)  # 24 does not divide 64
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("cache", ["empty", "v2", "v2-four-field-keys", "v1", "other-backend"])
def test_tuned_blocks_equal_the_reference(caches, cache):
    """``report.tuned_blocks`` is the reference's ``_tuned_blocks_for`` on the same
    cache and the same packed shapes: a key must split into four fields, so a
    schema-2 cache (five) matches nothing in either package."""
    from repro import api as japi
    from repro_torch import api as tapi
    from repro_torch.kernels.ops import PackedWeight, tree_leaves
    from repro_torch.models import cnn as tcnn

    params = tcnn.init_params(tcnn.ALEXNET_MINI, seed=0, device="cpu")
    kn = sorted({(int(np.prod(v.shape[:-1])), v.shape[-1]) for k, v in params.items()
                 if k.endswith("_w")})
    backend = "tpu" if cache == "other-backend" else "cpu"
    entries = {}
    for i, (kdim, n) in enumerate(kn):
        if cache in ("v2-four-field-keys", "v1", "other-backend"):
            key = f"{backend}|elp_bsd_a4|nib|{8 * (i + 1)}x{kdim}x{n}"
        else:
            key = jat.cache_key(8 * (i + 1), kdim, n, "elp_bsd_a4", True, "cpu", impl="pallas")
        entries[key] = {"blocks": [128, 128 * (i + 1), 128], "wall_us": 1.0}
    if cache != "empty":
        version = 1 if cache == "v1" else 2
        for path, mapped in zip(caches, (False, True)):
            with open(path, "w") as f:
                json.dump({"schema_version": version, "entries": {
                    (_map_key(k) if mapped else k): v for k, v in entries.items()}}, f)
    qm = tapi.quantize(tcnn.ALEXNET_MINI, params, tapi.QuantScheme(block_sizes="auto"),
                       device="cpu")
    # the reference's records of the same packed leaves (its parse reads only
    # their shapes, formats and layouts)
    jtree = [jops.PackedWeight(leaf.codes.numpy(), leaf.sf.numpy(), leaf.fmt_name, leaf.nibble,
                               leaf.shape, leaf.source_shape, None, None)
             for leaf in tree_leaves(qm.params) if isinstance(leaf, PackedWeight)]
    want = japi._tuned_blocks_for(jtree)
    assert qm.report.tuned_blocks == want
    assert len(want) == (len(kn) if cache == "v2-four-field-keys" else 0)
    # the forward runs on the cache; the default scheme records nothing
    assert tuple(qm.forward(torch.zeros(2, 32, 32, 3)).shape) == (2, 10)
    assert tapi.quantize(tcnn.ALEXNET_MINI, params, device="cpu").report.tuned_blocks == ()


@pytest.fixture(scope="module")
def engine_trees():
    from repro.configs.base import ArchConfig as JCfg
    from repro.models import transformer as jtr
    from repro_torch.configs.base import ArchConfig as TCfg

    kw = dict(name="bench-t", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
              d_ff=128, vocab=128, head_dim=16, dtype_str="float32")
    jq = tp.jax_pack_lm(jtr.init_params(JCfg(**kw), jax.random.PRNGKey(0)), JCfg(**kw))
    return JCfg(**kw), jq, TCfg(**kw), packed_from_numpy_tree(jq)


def packed_from_numpy_tree(jq):
    from repro_torch.interop import params_from_numpy

    return params_from_numpy(tp.packed_to_numpy(jq), device="cpu")


@pytest.mark.parametrize("winner", [None, "pallas", "pallas_fused"])
def test_kernel_dispatch_matches_reference(caches, engine_trees, winner):
    """Shape keys, counts and ``source`` equal the reference's on the same cache:
    every stacked leaf reads ``structural`` there, whatever the cache says. The
    port's ``impl`` is the kernel its per-layer call takes: the cache's."""
    from repro.serve import ServeEngine as JEngine
    from repro_torch.serve.engine import ServeEngine

    jc, jq, tc, tq = engine_trees
    jeng = JEngine(jc, jq, n_slots=2, max_len=16, mesh=None)
    if winner is not None:
        entries = {}
        for key in jeng.kernel_dispatch():
            mkn, fmt, mode = key.split("|")
            m, k, n = (int(v) for v in mkn.split("x"))
            entries[jat.cache_key(m, k, n, fmt, mode == "nib", "cpu", impl=winner)] = {
                "blocks": [128, 128, 128], "wall_us": 1.0}
        _write_both(entries)
    want = jeng.kernel_dispatch()
    got = ServeEngine(tc, tq, n_slots=2, max_len=16).kernel_dispatch()
    assert list(got) == list(want)
    assert [(v["count"], v["source"]) for v in got.values()] == [
        (v["count"], v["source"]) for v in want.values()]
    kernel = "elp_bsd_matmul" if winner == "pallas" else "fused_decode_matmul"
    assert {v["impl"] for v in got.values()} == {f"{kernel}/plain"}


def test_resolve_impl_sources(caches):
    """The port's per-call resolution, which ``kernel_dispatch`` reports for a
    single ``[K, N]`` weight: ``heuristic`` on a miss, ``autotuned`` on a hit."""
    pw, _ = tops.pack_weight(torch.randn(64, 32), "elp_bsd_a4")
    assert tops.resolve_impl(4, pw, "cpu") == ("fused", "heuristic")
    assert tops.resolve_impl(257, pw, "cpu") == ("tiled", "heuristic")
    tat.write_entries({tat.cache_key(4, 64, 32, "elp_bsd_a4", True, "cpu", "tiled"):
                       {"blocks": [128, 128, 128], "wall_us": 1.0}})
    assert tops.resolve_impl(4, pw, "cpu") == ("tiled", "autotuned")
    assert tops.resolve_impl(4, pw, "cuda") == ("fused", "heuristic")  # per backend
    assert tat.backend_of(torch.empty(0, device="meta")) == "cuda"


# ---------------------------------------------------------------------------
# python -m repro_torch.bench
# ---------------------------------------------------------------------------
def test_cli_run_validate_list_and_gate(caches, tmp_path, capsys):
    only = ["--only", "matmul/elp_bsd_a4/nib/8x128x10", "--suite", "kernels"]
    run = ["--smoke", "--device", "cpu", "--iters", "1", "--warmup", "0"] + only
    assert tcli.main(run + ["--out-dir", str(tmp_path / "a")]) == 0
    path = tmp_path / "a" / "BENCH_kernels.json"
    doc = json.loads(path.read_text())
    assert doc["backend"] == "cpu" and doc["torch_version"] == torch.__version__
    assert list(doc["entries"]) == ["matmul/elp_bsd_a4/nib/8x128x10"]
    assert tcli.main(["--validate", str(path)]) == 0
    assert tcli.main(["--list", "--smoke"] + only) == 0
    assert "matmul/elp_bsd_a4/nib/8x128x10" in capsys.readouterr().out
    # against itself, and against a missing baseline
    assert tcli._gate(tcli._collect_ratios(doc, doc, 0.0), 0.20) == []
    assert tcli.main(run + ["--out-dir", str(tmp_path / "b"), "--gate-against",
                            str(tmp_path / "a"), "--min-us", "0", "--tolerance", "1000"]) == 0
    assert tcli.main(run + ["--out-dir", str(tmp_path / "c"), "--gate-against",
                            str(tmp_path / "missing")]) == 1
    # --autotune writes the cache (one shape, to keep it short)
    tat.autotune_shapes([(8, 128, 10, "elp_bsd_a4", True)], device="cpu", iters=1, warmup=0)
    tat.invalidate_memory_cache()
    assert len(tat.cache_entries()) == 3


def test_kernel_bench_rows_match_reference(monkeypatch, capsys):
    """``experiments/kernel_bench.py`` prints the reference script's rows: the same
    names and byte counts (its times are the port's own)."""
    from benchmarks import kernel_bench as jkb
    from repro_torch.experiments import kernel_bench as tkb

    monkeypatch.setattr(jkb, "SHAPES", [(8, 256, 128)])
    monkeypatch.setattr(tkb, "SHAPES", [(8, 256, 128)])
    rows = []
    for run in (jkb.main, lambda: tkb.main(["--device", "cpu"])):
        run()
        rows.append([(name, {k: v for k, v in (kv.split("=") for kv in derived.split(";"))
                             if k != "bf16_us"})
                     for name, _us, derived in (line.split(",") for line in
                                                capsys.readouterr().out.splitlines())])
    assert rows[1] == rows[0] and len(rows[0]) == 2

"""The port's observability layer against the JAX package's, on the CPU.

``repro_torch.obs`` is a copy of ``repro.obs`` with ``torch.profiler`` in
place of ``jax.profiler``: the same record sequence must give the same
Prometheus text and the same snapshot document in both, each package's
validator must accept the other's snapshots, and the straggler monitor
and the Table II energy model the serve engine reads at startup must
agree. The engine's instruments are held to the reference engine's on the
same requests (counts and counters; the latencies are wall clocks).
"""
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_parity as tp  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.runtime.straggler import StragglerMonitor as JMonitor  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.obs import ProfileHook, TraceLog  # noqa: E402
from repro_torch.obs import __main__ as obs_main  # noqa: E402
from repro_torch.obs import export as texport  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.runtime.straggler import StragglerMonitor as TMonitor  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the test runner puts several workers on
    one host, where oversubscribed torch threads slow small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _record(mod, seed):
    """The same seeded record sequence into a fresh registry of ``mod``."""
    rng = np.random.default_rng(seed)
    reg = mod.Registry(enabled=True)
    h = reg.histogram("serve.ttft_s")
    w = reg.histogram("serve.spec.round_width", lo=1.0, growth=2.0 ** 0.25, n_buckets=24)
    for v in rng.lognormal(-4.0, 1.5, 300):
        h.record(float(v))
    for v in rng.integers(1, 9, 50):
        w.record(float(v))
    h.record(1e-6)  # exactly the first boundary
    reg.counter("serve.tokens_total").inc(1234)
    reg.counter("serve.energy_nj_total").inc(5.5e6)
    reg.gauge("serve.queue_depth").set(3)
    reg.gauge("serve.cache.pages_used").set(0)
    reg.histogram("serve.empty_s")
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_text_and_snapshot_identical(seed):
    jreg, treg = _record(jmetrics, seed), _record(tmetrics, seed)
    assert texport.prometheus_text(treg) == jexport.prometheus_text(jreg)
    tdoc, jdoc = texport.snapshot(treg), jexport.snapshot(jreg)
    assert json.dumps(tdoc, sort_keys=True) == json.dumps(jdoc, sort_keys=True)
    # each package's validator reads the other's snapshots
    jexport.validate_snapshot(tdoc)
    texport.validate_snapshot(jdoc)


@pytest.mark.parametrize("q", [0, 1, 50, 90, 99, 100])
def test_histogram_percentiles_match(q):
    rng = np.random.default_rng(q)
    vals = rng.lognormal(-3.0, 2.0, 500)
    jh, th = jmetrics.Histogram("x"), tmetrics.Histogram("x")
    for v in vals:
        jh.record(float(v))
        th.record(float(v))
    assert th.percentile(q) == jh.percentile(q)
    assert th.counts == jh.counts and th.to_json() == jh.to_json()


def test_histogram_edge_cases_and_merge():
    h = tmetrics.Histogram("x")
    assert h.percentile(50) is None and h.mean is None
    h.record(0.25)
    assert h.percentile(1) == h.percentile(99) == 0.25
    other = tmetrics.Histogram("x")
    other.record(2.0)
    h.merge(other)
    assert h.count == 2 and h.max == 2.0
    with pytest.raises(ValueError, match="different bucket layouts"):
        h.merge(tmetrics.Histogram("y", lo=1.0))
    with pytest.raises(ValueError, match="lo > 0"):
        tmetrics.Histogram("z", lo=0.0)


def test_registry_semantics():
    off = tmetrics.Registry()
    off.counter("a").inc(5)
    off.histogram("h").record(1.0)
    assert not off.counters() and not off.histograms()
    assert tmetrics.NULL_REGISTRY.enabled is False
    reg = tmetrics.Registry(enabled=True)
    assert reg.counter("a") is reg.counter("a")
    with pytest.raises(ValueError, match="another kind"):
        reg.gauge("a")
    reg.histogram("h", lo=1.0)
    with pytest.raises(ValueError, match="bucket layout"):
        reg.histogram("h", lo=2.0)


def test_snapshot_validator_rejects_bad_documents():
    doc = texport.snapshot(_record(tmetrics, 0))
    for bad in ({**doc, "schema_version": 2}, {**doc, "kind": "x"},
                {**doc, "counters": {"a": "1"}}):
        with pytest.raises(texport.SnapshotError):
            texport.validate_snapshot(bad)
    h = dict(doc["histograms"]["serve.ttft_s"], count=1)
    with pytest.raises(texport.SnapshotError, match="sum to count"):
        texport.validate_snapshot({**doc, "histograms": {"serve.ttft_s": h}})


def test_obs_main_validates_and_prints(tmp_path, capsys):
    path = str(tmp_path / "snap.json")
    texport.write_snapshot(_record(tmetrics, 0), path)
    assert obs_main.main(["--validate", path]) == 0
    assert obs_main.main(["--prom", path]) == 0
    out = capsys.readouterr().out
    assert "serve_tokens_total 1234" in out and "serve_ttft_s_count 301" in out
    with open(path, "w") as f:
        json.dump({"schema_version": 1}, f)
    assert obs_main.main(["--validate", path]) == 1


def test_trace_log_and_profile_hook(tmp_path):
    buf = io.StringIO()
    log = TraceLog(buf)
    log.event("submit", 0, prompt_len=5)
    log.event("decode", None, live=2)
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    assert [e["event"] for e in lines] == ["submit", "decode"] and lines[1]["rid"] is None
    mem = TraceLog()
    mem.event("finish", 3, tokens=4)
    assert mem.events[0]["tokens"] == 4
    hook = ProfileHook(str(tmp_path / "prof"), n_steps=2)
    for _ in range(3):
        torch.ones(8).sum()
        hook.step()
    assert hook.done and not hook.active
    assert (tmp_path / "prof" / "trace.json").exists()
    assert len(hook.profiler.key_averages()) > 0


def test_straggler_monitor_matches_reference():
    rng = np.random.default_rng(0)
    dts = list(rng.uniform(0.01, 0.02, 40)) + [0.09] + list(rng.uniform(0.01, 0.02, 20))
    jm, tm = JMonitor(), TMonitor()
    for dt in dts:
        assert tm.record(dt) == jm.record(dt)
    assert tm.report() == jm.report()


@pytest.mark.parametrize("which", ["gqa", "qwen3_8b_reduced"])
def test_lm_token_energy_matches_reference(which):
    jc, tc = tp.lm_configs(which)
    jp, tparams = tp.lm_params(jc)
    assert tenergy.lm_weight_macs_per_token(tc) == jenergy.lm_weight_macs_per_token(jc)
    for kv_bits in (0, 8):
        assert (tenergy.lm_cache_bytes_per_token(tc, 64, kv_bits=kv_bits)
                == jenergy.lm_cache_bytes_per_token(jc, 64, kv_bits=kv_bits))
    assert tenergy.lm_token_energy(tc, tparams) == jenergy.lm_token_energy(jc, jp)
    jq = tp.jax_pack_lm(jp, jc)
    from repro_torch.interop import params_from_numpy

    tq = params_from_numpy(tp.packed_to_numpy(jq), device="cpu")
    want = jenergy.lm_token_energy(jc, jq)
    got = tenergy.lm_token_energy(tc, tq)
    assert got["fmt"] == want["fmt"] == "elp_bsd_a4"
    assert got == pytest.approx(want, rel=1e-12)
    assert tenergy.lm_token_energy(tc, tq, act_bits=5) == pytest.approx(
        jenergy.lm_token_energy(jc, jq, act_bits=5), rel=1e-12)


def test_engine_instruments_match_reference():
    """The same requests through both engines with metrics on: the same
    counters, the same number of samples in every histogram."""
    from repro.serve import ServeEngine as JEngine
    from repro_torch.serve.engine import ServeEngine as TEngine

    jc, tc = tp.lm_configs("gqa")
    jp, tparams = tp.lm_params(jc)
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, jc.vocab, 6).astype(np.int32), n) for n in (3, 5, 4)]
    jreg, treg = jmetrics.Registry(enabled=True), tmetrics.Registry(enabled=True)
    jout = JEngine(jc, jp, n_slots=2, max_len=16, mesh=None, metrics=jreg).serve(reqs)
    teng = TEngine(tc, tparams, n_slots=2, max_len=16, metrics=treg)
    tout = teng.serve(reqs)
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(a, b)
    jc_, tc_ = jreg.counters(), treg.counters()
    assert sorted(tc_) == sorted(jc_)
    for name in jc_:
        assert tc_[name].value == pytest.approx(jc_[name].value, rel=1e-9), name
    jh, th = jreg.histograms(), treg.histograms()
    assert sorted(th) == sorted(jh)
    assert {k: h.count for k, h in th.items()} == {k: h.count for k, h in jh.items()}
    assert sorted(treg.gauges()) == sorted(jreg.gauges())
    jexport.validate_snapshot(texport.snapshot(treg))
    lat = teng.stats()["latency"]
    assert lat["ttft_p50_s"] > 0 and lat["itl_p99_s"] >= lat["itl_p50_s"]

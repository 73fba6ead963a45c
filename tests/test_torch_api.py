"""The port's front door: device rules, scheme validation, what is not ported yet.

Entry points run on the card unless the caller passes ``device="cpu"``;
with no card they raise instead of carrying on on the CPU. The
calibration pieces are held against the JAX package's on the same
activations.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api, interop  # noqa: E402
from repro_torch.calib import observers, policy  # noqa: E402
from repro_torch.models import cnn  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the test runner puts several workers on
    one host, where oversubscribed torch threads slow small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def mini():
    params = cnn.init_params(cnn.ALEXNET_MINI, seed=0, device="cpu")
    imgs = np.random.default_rng(0).normal(size=(1, 4, 32, 32, 3)).astype(np.float32)
    return params, imgs


def test_entry_points_raise_without_a_card(no_card, mini):
    params, imgs = mini
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cnn.init_params(cnn.ALEXNET_MINI)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.quantize(cnn.ALEXNET_MINI, params, api.QuantScheme(act="static"), calib_data=imgs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.params_from_numpy({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.packed_from_numpy(np.zeros((2, 2), np.uint8), np.ones((1, 1)), "elp_bsd_a4",
                                  True, (4, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.quantize(cnn.ALEXNET_MINI, params, device="cpu").to("cuda")


def test_cpu_quantize_and_forward_run_the_plain_path(mini):
    params, imgs = mini
    qm = api.quantize(cnn.ALEXNET_MINI, params, api.QuantScheme(act="static"),
                      calib_data=imgs, device="cpu")
    assert qm.device.type == "cpu" and qm.report.compression > 7
    logits = qm.forward(imgs[0])
    assert tuple(logits.shape) == (4, 10) and bool(torch.isfinite(logits).all())
    dyn = api.quantize(cnn.ALEXNET_MINI, params, api.QuantScheme(act="dynamic"), device="cpu")
    assert tuple(dyn.forward(imgs[0], impl="tiled").shape) == (4, 10)


def test_not_ported_features_raise_not_implemented(mini):
    params, imgs = mini
    # speculative schemes are an LM serving feature, as in the JAX package
    with pytest.raises(ValueError, match="LM serving"):
        api.quantize(cnn.ALEXNET_MINI, params, api.QuantScheme(spec_verify="float", spec_k=4),
                     device="cpu")
    # block_sizes="auto" is ported (the autotune cache): it no longer raises
    auto = api.quantize(cnn.ALEXNET_MINI, params, api.QuantScheme(block_sizes="auto"),
                        device="cpu")
    assert auto.report.tuned_blocks == ()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        api.quantize(object(), params, device="cpu")
    qm = api.quantize(cnn.ALEXNET_MINI, params, device="cpu")
    with pytest.raises(NotImplementedError, match="CNN models classify"):
        qm.serve([])
    # generation is the LM path (ported); a CNN artifact says so, as in the JAX package
    with pytest.raises(NotImplementedError, match="CNN models classify"):
        qm.generate(None, 4)
    with pytest.raises(ValueError, match="calib_data"):
        api.quantize(cnn.ALEXNET_MINI, params, api.QuantScheme(act="static"), device="cpu")


def test_quant_scheme_validates_like_the_reference():
    assert api.QuantScheme(fmt="elp4").fmt == "elp_bsd_a4"
    assert api.QuantScheme(block_sizes=[128, 128, 64]).block_sizes == (128, 128, 64)
    for bad in (dict(act="int8"), dict(granularity="per_row"), dict(clip="mse"),
                dict(block_sizes=(1, 2)), dict(act_bits=1), dict(bw_min=6, bw_max=5),
                dict(spec_k=3), dict(fmt="elp5")):
        with pytest.raises(ValueError):
            api.QuantScheme(**bad)


def test_observers_and_policy_match_the_jax_package():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.calib import observers as jobs
    from repro.calib import policy as jpol

    rng = np.random.default_rng(5)
    acts = [np.maximum(rng.normal(size=(4, 6, 6, 8)), 0).astype(np.float32) for _ in range(2)]
    js, ts = jobs.init_observer(8), observers.init_observer(8, "cpu")
    for a in acts:
        js = jobs.update(js, jnp.asarray(a), quant=(8, 2.5))
        ts = observers.update(ts, torch.from_numpy(a), quant=(8, 2.5))
    jsum, tsum = jobs.summarize(js), observers.summarize(ts)
    np.testing.assert_array_equal(tsum.hist, jsum.hist)
    np.testing.assert_array_equal(tsum.ch_amax, jsum.ch_amax)
    for f in ("count", "amax"):
        assert getattr(tsum, f) == getattr(jsum, f)
    for f in ("mean", "std", "rho"):
        np.testing.assert_allclose(getattr(tsum, f), getattr(jsum, f), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tsum.err_mean, jsum.err_mean, atol=1e-6)
    for pct in (99.0, 99.9, 100.0):
        assert tsum.percentile_amax(pct) == jsum.percentile_amax(pct)
    jt = jpol.attach_errors(jpol.build_table({"conv0": jsum}), {"conv0": jsum})
    tt = policy.attach_errors(policy.build_table({"conv0": tsum}), {"conv0": tsum})
    assert tt.site("conv0").compensate == jt.site("conv0").compensate
    assert tt.site("conv0").amax == jt.site("conv0").amax
    with pytest.raises(KeyError, match="no calibration"):
        tt.site("fc9")
    assert tt.lookup("fc9") is None and tt.lookup("conv0") is tt.site("conv0")


def test_block_sizes_auto_follows_the_autotune_cache(mini, tmp_path, monkeypatch):
    """``QuantScheme(block_sizes="auto")``: on a cache miss the default dispatch (the
    decode-step kernel up to 256 rows, M = B*Ho*Wo for a conv, the tiled one
    above), on a hit the cache's winner."""
    from repro_torch.bench import autotune
    from repro_torch.kernels import ops

    params, imgs = mini
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "autotune_cache.json"))
    autotune.invalidate_memory_cache()
    calls = []
    for name in ("elp_bsd_matmul", "fused_decode_matmul"):
        real = getattr(ops, name)

        def spy(x, codes, *a, _real=real, _name=name, **kw):
            calls.append((_name, x.shape[0], x.shape[1], codes.shape[1]))
            return _real(x, codes, *a, **kw)

        monkeypatch.setattr(ops, name, spy)
    qm = api.quantize(cnn.ALEXNET_MINI, params, api.QuantScheme(block_sizes="auto"),
                      device="cpu")
    x = torch.from_numpy(imgs[0])
    default = qm.forward(x)
    miss = list(calls)
    assert len(miss) == 5 and miss[0][1] > 256
    assert all(c[0] == ("fused_decode_matmul" if c[1] <= 256 else "elp_bsd_matmul")
               for c in miss)
    # the last conv's winner in the cache: the tiled kernel
    i, (_, m, k, n) = 2, miss[2]
    assert m <= 256
    autotune.write_entries({autotune.cache_key(m, k, n, "elp_bsd_a4", True, "cpu", impl):
                            {"blocks": [128, 128, 128], "wall_us": wall}
                            for impl, wall in (("tiled", 1.0), ("fused", 2.0))})
    calls.clear()
    tuned = qm.forward(x)
    assert [c[0] for c in calls] == [c[0] if j != i else "elp_bsd_matmul"
                                     for j, c in enumerate(miss)]
    np.testing.assert_allclose(tuned.numpy(), default.numpy(), rtol=1e-5, atol=1e-5)
    autotune.invalidate_memory_cache()

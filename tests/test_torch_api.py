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
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        api.quantize(cnn.ALEXNET_MINI, params, eval_fn=lambda p, a: 1.0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        api.quantize(cnn.ALEXNET_MINI, params, api.QuantScheme(spec_verify="float", spec_k=4),
                     device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        api.quantize(cnn.ALEXNET_MINI, params, api.QuantScheme(block_sizes="auto"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        api.quantize(object(), params, device="cpu")
    qm = api.quantize(cnn.ALEXNET_MINI, params, device="cpu")
    for call in (lambda: qm.save("x"), lambda: api.QuantizedModel.load("x"),
                 lambda: qm.serve([])):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            call()
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

"""The mini-CNN experiments (Fig. 15a/b) and their plumbing, port against the
JAX package's ``benchmarks/``, on the CPU.

* ``CnnDataset`` batches and ``calib_images``: bit-identical.
* ``weight_group_axes`` equal; ``loss_fn`` within 1e-6 relative and
  ``accuracy`` equal on the same weights.
* Training: one step and five steps of ``train_mini_cnn`` (momentum SGD)
  from the same numpy initial weights as the JAX package's trainer: every
  parameter within 1e-5 of its max |w| (both read below 6e-7), and the
  loss after them within 1e-5 relative. Float32 gradients summed in
  another order drift apart (8.8e-3 of max |w| after 40 steps), so the
  full 1200 steps are not held.
* ``fig15a.quantize_uniform``: bit-identical to the reference's.
* ``fig15a.run`` / ``run_activation`` and ``fig15b.run`` on ALEXNET_MINI
  trained 40 steps by the JAX trainer: every accuracy within 2/1024 of
  the reference's, the activation MSEs within 1e-3 relative, PDP and byte
  counts exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import common as jcommon  # noqa: E402
from benchmarks import fig15a_error_comp as jfig15a  # noqa: E402
from benchmarks import fig15b_accuracy_pdp as jfig15b  # noqa: E402
from repro.data.pipeline import CnnDataset as JDataset  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.data.pipeline import CnnDataset as TDataset  # noqa: E402
from repro_torch.experiments import common as tcommon  # noqa: E402
from repro_torch.experiments import fig15a_error_comp as tfig15a  # noqa: E402
from repro_torch.experiments import fig15b_accuracy_pdp as tfig15b  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from torch_parity import jax_trained_mini  # noqa: E402

ACC_TOL = 2 / 1024
SPEC = "ALEXNET_MINI"


def _t(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


@pytest.mark.parametrize("hw,ch,seed,amp", [(32, 3, 0, 1.2), (17, 2, 5, 0.7)])
def test_dataset_batches_bit_identical(hw, ch, seed, amp):
    jd, td = JDataset(hw, ch, 10, 6, seed=seed, amp=amp), TDataset(hw, ch, 10, 6, seed=seed,
                                                                   amp=amp)
    np.testing.assert_array_equal(td.templates, jd.templates)
    for step in (0, 1, 10_003):
        (jx, jy), (tx, ty) = jd.np_batch(step), td.np_batch(step)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    imgs = tcommon.calib_images(tcnn.VGG_MINI, n_batches=2, batch=4, device="cpu")
    np.testing.assert_array_equal(
        imgs.numpy(), np.asarray(jcommon.calib_images(jcnn.VGG_MINI, n_batches=2, batch=4)))


@pytest.fixture(scope="module")
def init_params():
    """The JAX trainer's initial weights for ALEXNET_MINI (seed 0), as numpy."""
    p = jcnn.init_params(jcnn.ALEXNET_MINI, jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in p.items()}


def test_loss_accuracy_and_group_axes(init_params):
    x, y = JDataset(32, 3, 10, 16).np_batch(0)
    jp, tp = {k: jnp.asarray(v) for k, v in init_params.items()}, _t(init_params)
    assert tcnn.weight_group_axes(tp) == jcnn.weight_group_axes(jp)
    jl = float(jcnn.loss_fn(jp, jcnn.ALEXNET_MINI, jnp.asarray(x), jnp.asarray(y)))
    tl = float(tcnn.loss_fn(tp, tcnn.ALEXNET_MINI, torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(tl - jl) <= 1e-6 * abs(jl)
    ja = float(jcnn.accuracy(jp, jcnn.ALEXNET_MINI, jnp.asarray(x), jnp.asarray(y)))
    ta = float(tcnn.accuracy(tp, tcnn.ALEXNET_MINI, torch.from_numpy(x), torch.from_numpy(y)))
    assert ta == ja


@pytest.mark.parametrize("steps", [1, 5])
def test_train_mini_cnn_matches_reference(init_params, tmp_path, steps):
    jp = jax_trained_mini(SPEC, steps, tmp_path)
    tp = tcommon.train_mini_cnn(tcnn.ALEXNET_MINI, steps=steps, params=init_params,
                                device="cpu")
    assert set(tp) == set(jp)
    for k, v in jp.items():
        moved = np.abs(v - init_params[k]).max()
        assert moved > 0, k
        err = np.abs(tp[k].numpy() - v).max()
        assert err <= 1e-5 * np.abs(v).max(), (k, err, moved)
    x, y = JDataset(32, 3, 10, 128).np_batch(steps)
    jl = float(jcnn.loss_fn({k: jnp.asarray(v) for k, v in jp.items()}, jcnn.ALEXNET_MINI,
                            jnp.asarray(x), jnp.asarray(y)))
    tl = float(tcnn.loss_fn(tp, tcnn.ALEXNET_MINI, torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(tl - jl) <= 1e-5 * abs(jl)


def test_train_mini_cnn_caches_by_spec_and_steps(tmp_path, monkeypatch):
    monkeypatch.setattr(tcommon, "RESULTS", str(tmp_path))
    a = tcommon.train_mini_cnn(tcnn.ALEXNET_MINI, steps=2, device="cpu")
    assert (tmp_path / "alexnet_mini_s2_trained.npz").exists()
    b = tcommon.train_mini_cnn(tcnn.ALEXNET_MINI, steps=2, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    tcommon.train_mini_cnn(tcnn.ALEXNET_MINI, steps=1, device="cpu", cache=False)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["alexnet_mini_s2_trained.npz"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return jax_trained_mini(SPEC, 40, tmp_path_factory.mktemp("results"))


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("compensate", [False, True])
def test_quantize_uniform_bit_identical(trained, bits, compensate):
    jp = {k: jnp.asarray(v) for k, v in trained.items()}
    tp = _t(trained)
    jq = jfig15a.quantize_uniform(jp, bits, compensate, jcnn.weight_group_axes(jp))
    tq = tfig15a.quantize_uniform(tp, bits, compensate, tcnn.weight_group_axes(tp))
    for k, v in jq.items():
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(v), err_msg=k)


@pytest.fixture
def reference_trains_nothing(trained, monkeypatch):
    """The reference experiments quantize ``trained`` instead of training 1200 steps."""
    monkeypatch.setattr(jcommon, "train_mini_cnn",
                        lambda spec, **kw: {k: jnp.asarray(v) for k, v in trained.items()})


def test_fig15a_runs_match_reference(trained, reference_trains_nothing):
    tp = _t(trained)
    jrows = jfig15a.run(jcnn.ALEXNET_MINI, bit_range=(3, 4))
    trows = tfig15a.run(tcnn.ALEXNET_MINI, bit_range=(3, 4), params=tp, device="cpu")
    assert [r["bits"] for r in trows] == [r["bits"] for r in jrows] == ["fp32", 3, 4]
    for t, j in zip(trows, jrows):
        for k in ("plain", "compensated"):
            assert abs(t[k] - j[k]) <= ACC_TOL, (t, j)
    jact = jfig15a.run_activation(jcnn.ALEXNET_MINI, bit_range=(4, 8))
    tact = tfig15a.run_activation(tcnn.ALEXNET_MINI, bit_range=(4, 8), params=tp, device="cpu")
    for t, j in zip(tact, jact, strict=True):
        assert t["bits"] == j["bits"]
        for k in ("acc_plain", "acc_comp"):
            assert abs(t[k] - j[k]) <= ACC_TOL, (t, j)
        for k in ("mse_plain", "mse_comp"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-3)
    tfig15a.report(trows, tact)


def test_fig15b_run_matches_reference(trained, reference_trains_nothing, capsys):
    jrows = jfig15b.run(jcnn.ALEXNET_MINI, act_bits_range=(8, 4))
    trows = tfig15b.run(tcnn.ALEXNET_MINI, act_bits_range=(8, 4), params=_t(trained),
                        device="cpu")
    assert len(trows) == len(jrows) == 4 * 2 + 2
    for t, j in zip(trows, jrows):
        assert (t["format"], t["act_bits"], t["pdp_fj"], t["energy_uj"], t["weight_bytes"]) == (
            j["format"], j["act_bits"], j["pdp_fj"], j["energy_uj"], j["weight_bytes"])
        assert abs(t["accuracy"] - j["accuracy"]) <= ACC_TOL, (t, j)
        assert abs(t["acc_drop"] - j["acc_drop"]) <= 2 * ACC_TOL
    tfig15b.report(trows)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("fig15b_elp_bsd_a4_a8,0.0,acc=")
    assert lines[-2].startswith("fig15b_claim_50pct,0.0,most_power_hungry=elp_bsd_b7@8b")

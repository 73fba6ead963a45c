"""The Sec. V methodology and the ``eval_fn`` search of ``api.quantize``, port
against the JAX package, on the CPU.

* ``quantize_tensor`` / ``compensate_tensor`` / ``compensated_quantize``:
  level indices and values bit-identical (every Table II format, conv and
  fc layouts); ``mean_error_report`` to float32 rounding (rtol 1e-5).
* ``run_methodology`` (dynamic and static activations) and
  ``api.quantize(..., eval_fn=...)`` (float, dynamic, static) on
  ALEXNET_MINI trained for 40 steps by the JAX package's trainer: the
  same CBW_A, bit-identical codes, every accuracy within 2/1024 (two of
  the 1024 eval images; dynamic and static activation fake quant is
  discontinuous, so float32 sums in another order may flip an image).
* ``CalibrationTable.with_bits`` and its JSON file, read across packages;
  ``pdp_reduction`` exactly.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from benchmarks import common as jcommon  # noqa: E402
from repro import api as japi  # noqa: E402
from repro.calib import policy as jpolicy  # noqa: E402
from repro.calib.runner import calibrate_cnn as jcalibrate  # noqa: E402
from repro.core import compensate as jcomp  # noqa: E402
from repro.core import elp_bsd as jelp  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core import methodology as jmeth  # noqa: E402
from repro.core import quantize as jquant  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.calib import policy as tpolicy  # noqa: E402
from repro_torch.calib.runner import calibrate_cnn as tcalibrate  # noqa: E402
from repro_torch.core import compensate as tcomp  # noqa: E402
from repro_torch.core import elp_bsd as telp  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.core import methodology as tmeth  # noqa: E402
from repro_torch.core import quantize as tquant  # noqa: E402
from repro_torch.experiments import common as tcommon  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from torch_parity import jax_trained_mini  # noqa: E402

FMT_NAMES = sorted(telp.PRESET_FORMATS)
ACC_TOL = 2 / 1024
SPEC = "ALEXNET_MINI"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the test runner puts several workers on
    one host, where oversubscribed torch threads slow small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 0.1


@pytest.mark.parametrize("name", FMT_NAMES)
@pytest.mark.parametrize("shape,group_axes", [((3, 3, 4, 8), (0, 1)), ((20, 10), (0,))])
def test_quantize_and_compensate_tensor_bit_identical(name, shape, group_axes):
    w = _weights(shape)
    jf, tf = jelp.PRESET_FORMATS[name], telp.PRESET_FORMATS[name]
    jq = jquant.quantize_tensor(jnp.asarray(w), jf)
    tq = tquant.quantize_tensor(torch.from_numpy(w), tf)
    np.testing.assert_array_equal(tq.level_idx.numpy(), np.asarray(jq.level_idx))
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    np.testing.assert_array_equal(np.asarray(tq.levels), np.asarray(jq.levels))
    assert float(tq.sf) == float(jq.sf) and tq.nbytes_encoded == jq.nbytes_encoded
    jc = jcomp.compensate_tensor(jnp.asarray(w), jq, group_axes)
    tc = tcomp.compensate_tensor(torch.from_numpy(w), tq, group_axes)
    np.testing.assert_array_equal(tc.level_idx.numpy(), np.asarray(jc.level_idx))
    np.testing.assert_array_equal(tc.values.numpy(), np.asarray(jc.values))
    assert not np.array_equal(tc.level_idx.numpy(), tq.level_idx.numpy())  # flips happened
    tcq = tcomp.compensated_quantize(torch.from_numpy(w), tf, group_axes)
    np.testing.assert_array_equal(tcq.level_idx.numpy(), tc.level_idx.numpy())
    jr = jcomp.mean_error_report(jnp.asarray(w), jq, jc, group_axes)
    tr = tcomp.mean_error_report(torch.from_numpy(w), tq, tc, group_axes)
    for k in ("before", "after", "reduction"):
        np.testing.assert_allclose(tr[k], jr[k], rtol=1e-5, atol=1e-9)
    assert tr["after"] < tr["before"]


def test_scale_factor_tql_and_uniform_levels():
    w = _weights((5, 7), seed=1)
    sf_j = jquant.scale_factor(w, jelp.FORMAT_B)
    sf_t = tquant.scale_factor(torch.from_numpy(w), telp.FORMAT_B)
    assert float(sf_t) == float(sf_j)
    np.testing.assert_array_equal(tquant.tql(telp.FORMAT_B, sf_t).numpy(),
                                  np.asarray(jquant.tql(jelp.FORMAT_B, sf_j)))
    np.testing.assert_array_equal(tquant.tql(telp.FORMAT_B, 0.5), jquant.tql(jelp.FORMAT_B, 0.5))
    for bits in (2, 5, 8):
        np.testing.assert_array_equal(tquant.uniform_levels(bits, 1.7),
                                      jquant.uniform_levels(bits, 1.7))
        lv = jquant.uniform_levels(bits, 0.3)
        jv, ji = jquant.nn_quantize(jnp.asarray(w), lv)
        tv, ti = tquant.nn_quantize(torch.from_numpy(w), lv)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    with pytest.raises(ValueError, match="bits >= 2"):
        tquant.uniform_levels(1, 1.0)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """ALEXNET_MINI after 40 steps of the JAX package's trainer (numpy), and both
    packages' eval functions."""
    params = jax_trained_mini(SPEC, 40, tmp_path_factory.mktemp("results"))
    jspec, tspec = getattr(jcnn, SPEC), getattr(tcnn, SPEC)
    return {
        "np": params,
        "jspec": jspec,
        "tspec": tspec,
        "jeval": jcommon.make_eval_fn(jspec),
        "teval": tcommon.make_eval_fn(tspec, device="cpu"),
        "t": {k: torch.from_numpy(np.array(v)) for k, v in params.items()},
        "j": {k: jnp.asarray(v) for k, v in params.items()},
    }


def _calib(trained):
    imgs = np.asarray(jcommon.calib_images(trained["jspec"], n_batches=2))
    jt, _ = jcalibrate(trained["j"], trained["jspec"], jnp.asarray(imgs), bits=8)
    tt, _ = tcalibrate(trained["t"], trained["tspec"], torch.from_numpy(imgs), bits=8)
    return imgs, jt, tt


@pytest.mark.parametrize("act", ["dynamic", "static"])
def test_run_methodology_matches_reference(trained, act):
    jt = tt = None
    if act == "static":
        _, jt, tt = _calib(trained)
    jga = jcnn.weight_group_axes(trained["j"])
    tga = tcnn.weight_group_axes(trained["t"])
    assert tga == jga
    jr = jmeth.run_methodology(trained["j"], jga, jelp.FORMAT_A, trained["jeval"], calib=jt)
    tr = tmeth.run_methodology(trained["t"], tga, telp.FORMAT_A, trained["teval"], calib=tt)
    assert tr.act_bits == jr.act_bits
    assert abs(tr.baseline_accuracy - jr.baseline_accuracy) <= ACC_TOL
    assert abs(tr.accuracy - jr.accuracy) <= ACC_TOL
    assert (tr.encoded_bytes, tr.raw_bytes) == (jr.encoded_bytes, jr.raw_bytes)
    assert set(tr.quantized) == set(jr.quantized) == {k for k in jga}
    for k, q in tr.quantized.items():
        np.testing.assert_array_equal(q.level_idx.numpy(), np.asarray(jr.quantized[k].level_idx))
        np.testing.assert_array_equal(tr.weights[k].numpy(), np.asarray(jr.weights[k]))


def test_convert_is_deprecated(trained):
    ga = tcnn.weight_group_axes(trained["t"])
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        r = tmeth.convert(trained["t"], ga, telp.FORMAT_A, lambda w, a: 1.0, bw_min=7)
    assert any(issubclass(w.category, DeprecationWarning) for w in rec)
    assert r.act_bits == 7 and r.accuracy_loss == 0.0 and r.compression > 7


@pytest.mark.parametrize("act", ["float", "dynamic", "static"])
def test_api_quantize_eval_fn_matches_reference(trained, act):
    kw = {}
    if act == "static":
        kw["calib_data"] = np.asarray(jcommon.calib_images(trained["jspec"], n_batches=2))
    scheme = dict(fmt="elp_bsd_a4", act=act, ac=0.01, bw_max=8, bw_min=4)
    jq = japi.quantize(trained["jspec"], trained["j"], japi.QuantScheme(**scheme),
                       eval_fn=trained["jeval"],
                       **{k: jnp.asarray(v) for k, v in kw.items()})
    tq = tapi.quantize(trained["tspec"], trained["np"], tapi.QuantScheme(**scheme),
                       eval_fn=trained["teval"], device="cpu", **kw)
    jr, tr = jq.report, tq.report
    assert tr.act_bits == jr.act_bits
    assert abs(tr.baseline_accuracy - jr.baseline_accuracy) <= ACC_TOL
    assert abs(tr.accuracy - jr.accuracy) <= ACC_TOL
    assert abs(tr.accuracy_loss - jr.accuracy_loss) <= 2 * ACC_TOL
    assert (tr.encoded_bytes, tr.packed_bytes, tr.raw_bytes) == (
        jr.encoded_bytes, jr.packed_bytes, jr.raw_bytes)
    np.testing.assert_allclose(tr.energy_nj, jr.energy_nj, rtol=1e-12)
    for k, v in jq.params.items():
        if k.endswith("_w"):
            np.testing.assert_array_equal(tq.params[k].codes.numpy(), np.asarray(v.codes))
            np.testing.assert_array_equal(tq.params[k].sf.numpy(), np.asarray(v.sf))
    if act == "static":
        assert {s.bits for _, s in tq.table.sites} == {jr.act_bits}
        assert tq.table.names() == jq.table.names()
    else:
        assert tq.table is None


def test_api_quantize_eval_fn_semantics():
    """Step 1 sweeps the float params; step 5 evaluates the float twin of the
    packed codes and walks CBW_A back up while the constraint is violated."""
    spec = tcnn.ALEXNET_MINI
    params = tcnn.init_params(spec, seed=0, device="cpu")
    calls = []

    def eval_fn(p, act_quant):
        packed_twin = not torch.equal(p["conv0_w"], params["conv0_w"])
        calls.append((packed_twin, act_quant))
        if act_quant is None:
            return 0.9
        return 0.9 if (not packed_twin or act_quant >= 7) else 0.5

    qm = tapi.quantize(spec, params, tapi.QuantScheme(act="dynamic", bw_min=5), eval_fn=eval_fn,
                       device="cpu")
    assert calls == [(False, None), (False, 8), (False, 7), (False, 6), (False, 5),
                     (True, 5), (True, 6), (True, 7)]
    assert qm.report.act_bits == 7 and qm.report.accuracy_loss == 0.0


def test_calibration_table_with_bits_and_json_across_packages(trained, tmp_path):
    _, jt, tt = _calib(trained)
    t4 = tt.with_bits(4)
    assert {s.bits for _, s in t4.sites} == {4} and t4.names() == tt.names()
    assert [s.amax for _, s in t4.sites] == [s.amax for _, s in tt.sites]
    tt.save(tmp_path / "port.json")
    assert tpolicy.CalibrationTable.load(tmp_path / "port.json") == tt
    back = jpolicy.CalibrationTable.load(tmp_path / "port.json")
    assert back.names() == tt.names()
    for (_, a), (_, b) in zip(back.sites, tt.sites, strict=True):
        assert (a.amax, a.bits, a.rho, a.err_mean, a.compensate) == (
            b.amax, b.bits, b.rho, b.err_mean, b.compensate)
    jt.with_bits(5).save(tmp_path / "jax.json")
    loaded = tpolicy.CalibrationTable.load(tmp_path / "jax.json")
    assert loaded.names() == jt.names() and {s.bits for _, s in loaded.sites} == {5}
    for (_, a), (_, b) in zip(loaded.sites, jt.sites, strict=True):
        assert (a.amax, a.rho, a.err_mean, a.compensate) == (b.amax, b.rho, b.err_mean,
                                                             b.compensate)


@pytest.mark.parametrize("name", FMT_NAMES + ["booth_mac"])
@pytest.mark.parametrize("bits", [3, 4, 5, 6, 7, 8, 9])
def test_pdp_reduction_exact(name, bits):
    assert tenergy.pdp_reduction(name, bits) == jenergy.pdp_reduction(name, bits)
    assert tenergy.pdp_reduction(name, bits, "booth_mac") == jenergy.pdp_reduction(
        name, bits, "booth_mac")

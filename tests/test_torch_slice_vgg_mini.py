"""The whole slice on VGG_MINI, port against the JAX package, on the CPU.

JAX parameters carried across, then ``api.quantize(act="static")`` in both
packages on the same calibration images:

* packed codes, scale factors and dequantized weights: bit-identical;
* calibration table: amax rtol 1e-6, rho atol 1e-4, per-channel err_mean
  atol 1e-5 (float32 sums over the activations in another order), rho
  gates identical;
* folded biases: atol 1e-5;
* logits: max |diff| <= 1e-4 * max |logit|, argmax identical. The float
  forward (no quantization) is held to the same tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from torch_parity import run_slice  # noqa: E402

SPEC = "VGG_MINI"


@pytest.fixture(scope="module")
def slice_run():
    return run_slice(SPEC)


def test_packed_codes_bit_identical(slice_run):
    jq, tq = slice_run["jq"], slice_run["tq"]
    packed = [k for k in jq.params if k.endswith("_w")]
    assert packed and set(jq.params) == set(tq.params)
    for k in packed:
        jw, tw = jq.params[k], tq.params[k]
        assert (tw.fmt_name, tw.nibble, tw.shape, tw.source_shape) == (
            jw.fmt_name, jw.nibble, tuple(jw.shape), jw.source_shape
        )
        np.testing.assert_array_equal(tw.codes.numpy(), np.asarray(jw.codes), err_msg=k)
        np.testing.assert_array_equal(tw.sf.numpy(), np.asarray(jw.sf), err_msg=k)
    jd, td = jax.jit(jops.dequantize_tree)(jq.params), tops.dequantize_tree(tq.params)
    for k in packed:
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]), err_msg=k)


def test_calibration_table_close(slice_run):
    jt, tt = slice_run["jq"].table, slice_run["tq"].table
    assert tt.names() == jt.names()
    for (name, js), (_, ts) in zip(jt.sites, tt.sites):
        assert ts.bits == js.bits and ts.compensate == js.compensate, name
        np.testing.assert_allclose(ts.amax, js.amax, rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(ts.rho, js.rho, atol=1e-4, err_msg=name)
        assert (ts.err_mean is None) == (js.err_mean is None)
        if js.err_mean is not None:
            np.testing.assert_allclose(ts.err_mean, js.err_mean, atol=1e-5, err_msg=name)


def test_folded_biases_close(slice_run):
    jq, tq = slice_run["jq"], slice_run["tq"]
    for k in (k for k in jq.params if k.endswith("_b")):
        np.testing.assert_allclose(tq.params[k].numpy(), np.asarray(jq.params[k]), atol=1e-5)


def test_logits_close_and_argmax_identical(slice_run):
    jl, tl = slice_run["j_logits"], slice_run["t_logits"]
    assert tl.shape == jl.shape
    assert np.abs(tl - jl).max() <= 1e-4 * np.abs(jl).max()
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    jf, tf = slice_run["j_float"], slice_run["t_float"]
    assert np.abs(tf - jf).max() <= 1e-4 * np.abs(jf).max()


def test_conversion_report_matches(slice_run):
    jr, tr = slice_run["jq"].report, slice_run["tq"].report
    for field in ("fmt", "act", "act_bits", "raw_bytes", "packed_bytes",
                  "packed_weight_bytes", "encoded_bytes", "energy_nj"):
        assert getattr(tr, field) == getattr(jr, field), field

"""The paper's remaining results in the port against the JAX package, on the CPU.

ALEXNET_MINI weights: the JAX package's initial weights (seed 0) trained 20
steps by the port's ``train_mini_cnn`` (momentum SGD), the same numpy arrays
in both packages.

* ``ca_levels`` equal (17 levels at 3 shift bits, with and without zero).
* Sec. VI-D: ``quantize_ca`` bit-identical to the JAX script's, with and
  without Algorithm 1; ``caxcnn_compare.run`` on the shared weights (the
  reference's trainer replaced by them): accuracies equal, logit MSEs
  within 1e-5 relative.
* Table II: ``table2_energy.main()``'s output string-for-string equal to
  ``benchmarks/table2_energy.py``'s.
* Dynamic against static activations: ``calib_bench.run`` and its rows on
  ALEXNET_MINI, and the packed c6 forward of both minis at batch 4: the
  static forward counts 0 range reductions, the dynamic one exactly one a
  quantization site (the input, every conv, every fc but the last), the
  count derived from the spec. The reference's ``count_range_reductions``
  does not run under this jax (``calib/runner.py:273``), so the port is held
  to that contract instead of to the reference's count.
* The leftover names: ``packed_weight_bytes``; the deprecated
  ``cnn.quantize_params`` (warns; codes bit-identical to the reference's and
  to the port's own ``api.quantize``) and
  ``runtime.quantized_params.quantize_params_for_serving`` (warns; codes
  bit-identical); the ``configs.alexnet`` / ``configs.vgg16`` aliases.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from benchmarks import caxcnn_compare as jcax  # noqa: E402
from benchmarks import common as jcommon  # noqa: E402
from benchmarks import table2_energy as jtable2  # noqa: E402
from repro.core import ca_levels as jca_levels  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.core import ca_levels as tca_levels  # noqa: E402
from repro_torch.experiments import calib_bench as tcalib  # noqa: E402
from repro_torch.experiments import caxcnn_compare as tcax  # noqa: E402
from repro_torch.experiments import common as tcommon  # noqa: E402
from repro_torch.experiments import table2_energy as ttable2  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the test runner puts several workers on
    one host, and oversubscribed torch threads made these small ops 20-50x
    slower (the lm_ptq case: 12 s alone, 222 s beside five other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained():
    init = jcnn.init_params(jcnn.ALEXNET_MINI, jax.random.PRNGKey(0))
    p = tcommon.train_mini_cnn(tcnn.ALEXNET_MINI, steps=20,
                               params={k: np.asarray(v) for k, v in init.items()},
                               device="cpu", cache=False)
    return {k: v.numpy() for k, v in p.items()}


@pytest.mark.parametrize("bits,zero", [(3, True), (3, False), (2, True)])
def test_ca_levels_equal(bits, zero):
    got, want = tca_levels(bits, zero), jca_levels(bits, zero)
    assert got.dtype == want.dtype and len(got) == 2 ** (bits + 1) + zero
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("compensate", [False, True])
def test_quantize_ca_bit_identical(trained, compensate):
    jp = {k: jnp.asarray(v) for k, v in trained.items()}
    tpar = {k: torch.from_numpy(v) for k, v in trained.items()}
    jq = jcax.quantize_ca(jp, jcnn.weight_group_axes(jp), compensate=compensate)
    tq = tcax.quantize_ca(tpar, tcnn.weight_group_axes(tpar), compensate=compensate)
    for k, v in jq.items():
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(v), err_msg=k)


def test_caxcnn_compare_rows_match_reference(trained, monkeypatch, capsys):
    monkeypatch.setattr(jcommon, "train_mini_cnn",
                        lambda spec, **kw: {k: jnp.asarray(v) for k, v in trained.items()})
    want = jcax.run()
    got = tcax.run(params={k: torch.from_numpy(v) for k, v in trained.items()}, device="cpu")
    assert sorted(got) == sorted(want)
    for key in ("baseline", "caxcnn_5b", "conlocnn_4b"):
        assert got[key] == want[key], key
    for key in ("mse_cax", "mse_conlo"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    tcax.report(got)
    assert capsys.readouterr().out.startswith("caxcnn_compare,0.0,baseline=")


def test_table2_energy_output_string_equal(capsys):
    jtable2.main()
    want = capsys.readouterr().out
    ttable2.main()
    got = capsys.readouterr().out
    assert len(want.splitlines()) == 18
    assert got == want
    assert ttable2._param_count(tcnn.VGG16) == jtable2._param_count(jcnn.VGG16)


def _sites(spec) -> int:
    """Activation quantization sites of a CNN forward: the input, every conv, every
    fc but the last."""
    n_conv = sum(isinstance(l, tcnn.Conv) for l in spec.layers)
    n_fc = sum(isinstance(l, tcnn.Fc) for l in spec.layers)
    return 1 + n_conv + n_fc - 1


def test_calib_bench_run_and_rows(trained, capsys):
    spec = tcnn.ALEXNET_MINI
    r = tcalib.run(spec, params={k: torch.from_numpy(v) for k, v in trained.items()},
                   device="cpu")
    assert r["reduce_max_static"] == 0
    assert r["reduce_max_dynamic"] == _sites(spec) == 5
    assert min(r["us_fp"], r["us_dynamic"], r["us_static"], r["convert_ms"]) > 0
    tcalib.report(spec, r)
    rows = capsys.readouterr().out.splitlines()
    assert [row.split(",")[0] for row in rows] == [
        f"calib_bench_{spec.name}_{k}" for k in ("dynamic", "static", "overheads")]
    assert rows[1].split(",")[2].startswith("reduce_max=0;speedup_vs_dynamic=")


@pytest.mark.parametrize("spec_name", ["ALEXNET_MINI", "VGG_MINI"])
def test_packed_forward_range_reductions_per_site(spec_name):
    """calib_bench's forwards at a small size: a static packed forward counts 0
    range reductions, a dynamic one exactly one a site (derived from the spec)."""
    from repro_torch.calib.runner import count_range_reductions

    spec = getattr(tcnn, spec_name)
    params = tcnn.init_params(spec, seed=0, device="cpu")
    images = tcommon.calib_images(spec, n_batches=1, batch=4, device="cpu")
    qm = tapi.quantize(spec, params, tapi.QuantScheme(fmt="elp_bsd_c6", act="static", act_bits=8),
                       calib_data=images, device="cpu")
    x = images[0]
    static = count_range_reductions(lambda: tcnn.forward(qm.params, spec, x, calib=qm.table))
    dynamic = count_range_reductions(lambda: tcnn.forward(qm.params, spec, x, act_bits=8))
    assert static == 0
    assert dynamic == _sites(spec) == (5 if spec_name == "ALEXNET_MINI" else 6)


def _codes(tree):
    return {k: (np.asarray(v.codes), np.asarray(v.sf)) for k, v in tree.items()
            if hasattr(v, "codes")}


def test_leftover_cnn_names_match_reference(trained):
    jp = {k: jnp.asarray(v) for k, v in trained.items()}
    tpar = {k: torch.from_numpy(v) for k, v in trained.items()}
    with pytest.warns(DeprecationWarning, match="api.quantize"):
        jq = jcnn.quantize_params(jp, "elp_bsd_a4")
    with pytest.warns(DeprecationWarning, match="api.quantize"):
        tq = tcnn.quantize_params(tpar, "elp_bsd_a4")
    via_api = tapi.quantize(tcnn.ALEXNET_MINI, tpar, tapi.QuantScheme(fmt="elp_bsd_a4"),
                            device="cpu").params
    jc, tc_, ac = _codes(jq), _codes(tq), _codes(via_api)
    assert sorted(jc) == sorted(tc_) == sorted(ac)
    for k in jc:
        for a, b, c in zip(tc_[k], jc[k], ac[k]):
            np.testing.assert_array_equal(a, b, err_msg=k)
            np.testing.assert_array_equal(a, c, err_msg=k)
    assert tcnn.packed_weight_bytes(tq) == jcnn.packed_weight_bytes(jq) > 0
    assert tcnn.packed_weight_bytes(tpar) == jcnn.packed_weight_bytes(jp) == 0


def test_quantize_params_for_serving_matches_reference():
    from repro.runtime.quantized_params import quantize_params_for_serving as jqps
    from repro_torch.runtime.quantized_params import quantize_params_for_serving as tqps

    jc, tc_ = tp.lm_configs("gqa")
    jp, tparams = tp.lm_params(jc)
    with pytest.warns(DeprecationWarning, match="api.quantize"):
        jq = jax.jit(lambda p: jqps(p, jc, "elp4"))(jp)
    with pytest.warns(DeprecationWarning, match="api.quantize"):
        tq = tqps(tparams, tc_, "elp4")
    jb, tb = _codes(jq["blocks"]), _codes(tq["blocks"])
    assert sorted(jb) == sorted(tb) and len(tb) == 7
    for k in jb:
        for a, b in zip(tb[k], jb[k]):
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("name", ["alexnet", "vgg16"])
def test_config_aliases_match_reference(name):
    import importlib

    def record(spec):
        return (spec.name, spec.input_hw, spec.input_ch,
                [(type(l).__name__, dataclasses.astuple(l)) for l in spec.layers])

    jm = importlib.import_module(f"repro.configs.{name}")
    tm = importlib.import_module(f"repro_torch.configs.{name}")
    assert record(tm.CONFIG) == record(jm.CONFIG)
    assert record(tm.CONFIG_MINI) == record(jm.CONFIG_MINI)
    assert tm.CONFIG.macs() == jm.CONFIG.macs()

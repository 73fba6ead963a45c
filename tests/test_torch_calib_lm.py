"""LM conversion and calibration in the port against the JAX package, on the CPU.

Stacked packing (``quantize_stacked`` / ``pack_lm_params``, per-slice scale
factors, Algorithm 1 per (slice, column)) must give bit-identical codes and
scale factors. Calibration runs the same tapped forward on the same token
ids: site statistics agree to 1e-5 relative (float32 activations summed in
another order), the K/V cache scales likewise, and the static activation
scales stamped onto the packed leaves are the table's own numbers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from repro.calib.runner import calibrate_kv_cache as jkv  # noqa: E402
from repro.calib.runner import calibrate_lm as jcal  # noqa: E402
from repro.runtime.quantized_params import quantize_stacked as jstack  # noqa: E402
from repro_torch.api_schemes import pack_lm_params as tpack  # noqa: E402
from repro_torch.calib.runner import calibrate_kv_cache as tkv  # noqa: E402
from repro_torch.calib.runner import calibrate_lm as tcal  # noqa: E402
from repro_torch.core.elp_bsd import resolve_format  # noqa: E402
from repro_torch.kernels.ops import PackedWeight, packed_tree_bytes  # noqa: E402
from repro_torch.runtime.quantized_params import ACT_SITE_BY_LEAF, quantize_stacked  # noqa: E402


@pytest.fixture(scope="module")
def gqa():
    jc, tc = tp.lm_configs("gqa")
    jp, tpar = tp.lm_params(jc)
    toks = np.random.default_rng(1).integers(0, jc.vocab, (2, 4, 16)).astype(np.int32)
    return jc, tc, jp, tpar, toks


def _same_packed(jpw, tpw):
    assert isinstance(tpw, PackedWeight)
    assert np.array_equal(np.asarray(jpw.codes), tpw.codes.numpy())
    assert np.array_equal(np.asarray(jpw.sf), tpw.sf.numpy())
    assert (jpw.fmt_name, jpw.nibble, jpw.shape) == (tpw.fmt_name, tpw.nibble, tpw.shape)


@pytest.mark.parametrize("compensate", [True, False])
def test_pack_lm_params_is_bit_identical(gqa, compensate):
    jc, tc, jp, tpar, _ = gqa
    jq = tp.jax_pack_lm(jp, jc, compensate=compensate)
    tq = tpack(tpar, tc, "elp_bsd_a4", compensate=compensate)
    for name, leaf in jq["blocks"].items():
        if name in ("ln1", "ln2"):
            assert np.array_equal(np.asarray(leaf), tq["blocks"][name].numpy())
        else:
            _same_packed(leaf, tq["blocks"][name])
            assert tuple(tq["blocks"][name].codes.shape)[0] == jc.n_layers
    for name in ("embed", "final_norm", "lm_head"):
        assert np.array_equal(np.asarray(jq[name]), tq[name].numpy())
    # stacked leaves counted whole: codes + one float32 sf per slice
    jbytes = sum(int(np.prod(np.asarray(v).shape)) * 4 for v in jax.tree.leaves(jp))
    assert packed_tree_bytes(tpar) == jbytes
    w = tq["blocks"]["wq"]
    assert packed_tree_bytes({"w": w}) == w.codes.numel() + jc.n_layers * 4


def test_quantize_stacked_u8_and_slice_views(gqa):
    """A 6-bit format (one code per byte), slice by slice as stacked; each
    layer view shares the stack's storage."""
    jc, _, jp, tpar, _ = gqa
    fmt = "elp_bsd_c6"
    from repro.core.elp_bsd import PRESET_FORMATS

    jpw = jax.jit(lambda w: jstack(w, PRESET_FORMATS[fmt]))(jp["blocks"]["w1"])
    tpw = quantize_stacked(tpar["blocks"]["w1"], resolve_format(fmt))
    _same_packed(jpw, tpw)
    assert not tpw.nibble
    for i in range(jc.n_layers):
        view = tpw.layer(i)
        assert view.codes.data_ptr() == tpw.codes[i].data_ptr() and view.sf.numel() == 1
        assert np.array_equal(view.codes.numpy(), np.asarray(jpw.codes)[i])


@pytest.mark.parametrize("clip", ["max", "percentile"])
def test_calibrate_lm_sites_match(gqa, clip):
    jc, tc, jp, tpar, toks = gqa
    jt = jcal(jp, jc, jnp.asarray(toks), bits=8, clip=clip)
    tt = tcal(tpar, tc, torch.from_numpy(toks), bits=8, clip=clip)
    assert set(jt.names()) == set(tt.names()) == {
        "embed", "blocks", "attn_in", "attn_mix", "ffn_in", "ffn_hidden", "final"}
    for name in jt.names():
        js, ts = jt.site(name), tt.site(name)
        np.testing.assert_allclose(ts.amax, js.amax, rtol=1e-5)
        np.testing.assert_allclose([ts.mean, ts.std], [js.mean, js.std], rtol=1e-4, atol=1e-6)
        assert abs(ts.rho - js.rho) < 1e-4 and ts.compensate == js.compensate
    # stamped onto the packed leaves: each leaf's input site, the table's number
    jq = tp.jax_pack_lm(jp, jc, calib=jt)
    tq = tpack(tpar, tc, "elp_bsd_a4", calib=tt)
    for name, site in ACT_SITE_BY_LEAF.items():
        if name in tq["blocks"]:
            assert tq["blocks"][name].act_scale == tt.site(site).amax
            np.testing.assert_allclose(tq["blocks"][name].act_scale,
                                       jq["blocks"][name].act_scale, rtol=1e-5)
            assert tq["blocks"][name].act_bits == jq["blocks"][name].act_bits == 8


def test_calibrate_kv_cache_scales_match(gqa):
    jc, tc, jp, tpar, toks = gqa
    jk, jv = jkv(jp, jc, jnp.asarray(toks))
    tk, tv = tkv(tpar, tc, torch.from_numpy(toks))
    assert tk.shape == tv.shape == (jc.n_layers, jc.n_kv_heads) and tk.dtype == np.float32
    np.testing.assert_allclose(tk, jk, rtol=1e-5)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)

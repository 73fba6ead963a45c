"""The port's formats, decoders and conversion engine against the JAX package.

Integer outputs must be bit-identical: the format tables, every decoded
code value (both decoders), nibble unpacking, and ``convert_tensor``'s
level indices, codes and scale factors. Inputs come from numpy seeds and
go to both packages on the CPU.
"""
import ast
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.core.convert  # noqa: E402,F401  (repro.core re-exports a function named convert)
from repro.core import elp_bsd as jelp  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core import quantize as jquant  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import convert as tconvert  # noqa: E402
from repro_torch.core import elp_bsd as telp  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.core import quantize as tquant  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

jconvert = sys.modules["repro.core.convert"]
REPO = pathlib.Path(__file__).resolve().parents[1]
FMT_NAMES = sorted(telp.PRESET_FORMATS)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the test runner puts several workers on
    one host, where oversubscribed torch threads slow small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", FMT_NAMES)
def test_format_tables_equal(name):
    jf, tf = jelp.PRESET_FORMATS[name], telp.PRESET_FORMATS[name]
    assert tf.bits_per_weight == jf.bits_per_weight and tf.max_shift == jf.max_shift
    assert tf.field_layout() == jf.field_layout()
    for a, b in zip(tf.shift_tables(), jf.shift_tables(), strict=True):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tf.shift_add_decomposition(), jf.shift_add_decomposition(), strict=True):
        assert a[:3] == b[:3] and a[4] == b[4]
        np.testing.assert_array_equal(a[3], b[3])
    np.testing.assert_array_equal(tf.levels(), jf.levels())
    np.testing.assert_array_equal(tf.level_codes(), jf.level_codes())


def test_resolve_format_aliases_and_errors():
    assert telp.resolve_format("elp4") is telp.FORMAT_A
    assert telp.resolve_format("elp8") is telp.FORMAT_C
    with pytest.raises(ValueError, match="unknown ELP_BSD format"):
        telp.resolve_format("elp5")
    with pytest.raises(TypeError):
        telp.resolve_format(4)


@pytest.mark.parametrize("name", FMT_NAMES)
def test_every_code_decodes_bit_identically(name):
    """Both port decoders against the JAX decoder, over every raw code."""
    codes = np.arange(2 ** telp.PRESET_FORMATS[name].bits_per_weight, dtype=np.int32)
    want = np.asarray(jref.decode_values(jnp.asarray(codes), jelp.PRESET_FORMATS[name]))
    fmt = telp.PRESET_FORMATS[name]
    for decoder in (tref.decode_values, tref.decode_values_shift_add):
        got = decoder(torch.from_numpy(codes), fmt).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_nibble_unpack_bit_identical():
    packed = np.random.default_rng(0).integers(0, 256, size=(2, 5, 7)).astype(np.uint8)
    want = np.asarray(jref.unpack_nibbles_k(jnp.asarray(packed)))
    got = tref.unpack_nibbles_k(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [6, 7])
def test_nibble_pack_matches_including_odd_pad_row(k):
    codes = np.random.default_rng(k).integers(0, 16, size=(k, 5)).astype(np.uint8)
    want = np.asarray(jconvert.nibble_pack(jnp.asarray(codes)))
    got = tconvert.nibble_pack(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == ((k + 1) // 2, 5)


def test_nn_quantize_and_second_neighbor_bit_identical():
    lv = telp.FORMAT_D.levels()
    w = np.random.default_rng(1).normal(scale=60.0, size=(257,)).astype(np.float32)
    w[:5] = ((lv[1:6] + lv[:5]) / 2).astype(np.float32)  # exact midpoints: ties go low
    nn_j = jquant.nn_quantize_idx(jnp.asarray(w), lv)
    nn_t = tquant.nn_quantize_idx(torch.from_numpy(w), lv)
    np.testing.assert_array_equal(nn_t.numpy(), np.asarray(nn_j))
    sn_j = jquant.second_neighbor_idx(jnp.asarray(w), lv, nn_j)
    sn_t = tquant.second_neighbor_idx(torch.from_numpy(w), lv, nn_t)
    np.testing.assert_array_equal(sn_t.numpy(), np.asarray(sn_j))


@pytest.mark.parametrize("bits", [4, 8])
def test_fake_quant_rounds_half_to_even_like_jax(bits):
    x = np.random.default_rng(2).normal(size=(300,)).astype(np.float32)
    qmax = 2 ** (bits - 1) - 1
    x[:8] = (np.arange(8) - 3.5) * (2.0 / qmax)  # exact .5 steps at max_abs = 2
    want = np.asarray(jquant.fake_quant_uniform(jnp.asarray(x), bits, 2.0))
    got = tquant.fake_quant_uniform(torch.from_numpy(x), bits, 2.0).numpy()
    np.testing.assert_array_equal(got, want)
    want_d = np.asarray(jquant.fake_quant_dynamic(jnp.asarray(x), bits))
    np.testing.assert_array_equal(tquant.fake_quant_dynamic(torch.from_numpy(x), bits).numpy(), want_d)
    with pytest.raises(ValueError, match="bits >= 2"):
        tquant.fake_quant_uniform(torch.from_numpy(x), 1, 2.0)


# (layout shape, granularity): fc [K, N] with odd K, and a conv [kh, kw, cin, cout]
CONVERT_CASES = [
    ((37, 24), "per_tensor"),
    ((37, 24), "per_channel"),
    ((3, 3, 5, 8), "per_tensor"),
    ((3, 3, 5, 8), "per_channel"),
]


@pytest.mark.parametrize("fmt_name", ["elp_bsd_a4", "elp_bsd_d6"])
@pytest.mark.parametrize("shape,granularity", CONVERT_CASES)
@pytest.mark.parametrize("compensate", [True, False])
def test_convert_tensor_bit_identical(fmt_name, shape, granularity, compensate):
    rng = np.random.default_rng(len(shape) * 7 + compensate)
    w = (rng.normal(size=shape) * 0.1).astype(np.float32)
    ga = (0, 1) if len(shape) == 4 else (0,)
    jc = jconvert.convert_tensor(
        jnp.asarray(w), fmt_name, granularity=granularity, compensate=compensate, group_axes=ga
    )
    tc = tconvert.convert_tensor(
        torch.from_numpy(w), fmt_name, granularity=granularity, compensate=compensate,
        group_axes=ga,
    )
    np.testing.assert_array_equal(tc.level_idx.numpy(), np.asarray(jc.level_idx))
    np.testing.assert_array_equal(tc.sf.numpy(), np.asarray(jc.sf))
    np.testing.assert_array_equal(tc.codes().numpy(), np.asarray(jc.codes()))
    np.testing.assert_array_equal(tc.values.numpy(), np.asarray(jc.values))


@pytest.mark.parametrize("fmt_name", ["elp_bsd_b7", "elp_bsd_c6"])
def test_convert_tensor_bit_identical_other_formats(fmt_name):
    w = (np.random.default_rng(3).normal(size=(5, 5, 3, 16)) * 0.2).astype(np.float32)
    jc = jconvert.convert_tensor(jnp.asarray(w), fmt_name, group_axes=(0, 1))
    tc = tconvert.convert_tensor(torch.from_numpy(w), fmt_name, group_axes=(0, 1))
    np.testing.assert_array_equal(tc.codes().numpy(), np.asarray(jc.codes()))
    np.testing.assert_array_equal(tc.sf.numpy(), np.asarray(jc.sf))


def test_convert_tensor_rejects_groups_across_scale_cells():
    w = torch.zeros(4, 6)
    with pytest.raises(ValueError, match="cross scale cells"):
        tconvert.convert_tensor(w, "elp4", granularity="per_channel", group_axes=(1,))


def test_energy_model_matches():
    for fmt in ("elp_bsd_a4", "elp_bsd_c6", "conventional_fp"):
        for bits in (4, 6, 8):
            assert tenergy.pdp_fj(fmt, bits) == jenergy.pdp_fj(fmt, bits)
    assert tenergy.network_energy_nj(10**9, 38 * 10**6, "elp_bsd_a4", 8) == (
        jenergy.network_energy_nj(10**9, 38 * 10**6, "elp_bsd_a4", 8)
    )


def _imported_modules(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module)
    return out


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    banned = ("jax", "jaxlib", "repro")
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in banned, f"{path.relative_to(REPO)} imports {mod}"

"""The tiled matmul's tensor-core routes: the pieces that run on the CPU, against the JAX package.

The bf16 tensor-core kernel (``csrc/elp_bsd_matmul_wgmma.cu``) decodes by a
byte-indexed table built from ``repro_torch.kernels.ref.decode_table``;
here that table meets the JAX package's decoder bit for bit, the routing
rule is checked without a launch, and the plain version, the yardstick of
both routes on the card, meets the Pallas kernel on bf16 activations with
the float32 tolerance of ``tests/test_torch_kernels.py`` (rtol 1e-5,
atol 1e-4: float32 sums in another order; bf16 x times a bf16-exact weight
is exact in float32 on both sides).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.elp_bsd import PRESET_FORMATS as JFMT  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core.elp_bsd import PRESET_FORMATS as TFMT  # noqa: E402
from repro_torch.core.elp_bsd import DigitSpec, ElpBsdFormat  # noqa: E402
from repro_torch.kernels import elp_bsd_matmul as mm  # noqa: E402
from repro_torch.kernels.ref import bf16_exact, decode_table  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-4)
# Two digits 9 binary places apart: 2^9 + 1 needs 10 significant bits.
WIDE = ElpBsdFormat((DigitSpec(shifts=(0,)), DigitSpec(shifts=(9,))), name="shifts_0_9")
LAYOUTS = [("elp_bsd_a4", True)] + [(f, False) for f in sorted(TFMT)]


def _f32_bits_of_bf16(half: np.ndarray) -> np.ndarray:
    """16-bit bf16 patterns -> the float32 bit patterns of the same values."""
    return (half.astype(np.uint32) << 16).view(np.float32).view(np.uint32)


@pytest.mark.parametrize("fmt_name,nibble", LAYOUTS)
def test_decode_table_bit_identical_to_jax(fmt_name, nibble):
    table = decode_table(TFMT[fmt_name], nibble).numpy().astype(np.uint32)
    byte = jnp.arange(256, dtype=jnp.uint8)[None, :]  # one byte row, 256 columns
    codes = jref.unpack_nibbles_k(byte) if nibble else byte
    want = np.asarray(jref.decode_values_shift_add(codes, JFMT[fmt_name])).view(np.uint32)
    np.testing.assert_array_equal(_f32_bits_of_bf16(table & 0xFFFF), want[0])
    if nibble:
        np.testing.assert_array_equal(_f32_bits_of_bf16(table >> 16), want[1])
    else:
        assert not (table >> 16).any()


def test_decode_table_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="exact in bfloat16"):
        decode_table(WIDE, False)
    with pytest.raises(ValueError, match="nibbles hold 4"):
        decode_table(TFMT["elp_bsd_c6"], True)


@pytest.mark.parametrize("fmt", [*sorted(TFMT), WIDE.name])
def test_bf16_exact(fmt):
    if fmt == WIDE.name:
        assert not bf16_exact(WIDE)
    else:
        assert bf16_exact(TFMT[fmt])


@pytest.mark.parametrize("fmt_name,nibble", [("elp_bsd_a4", True), ("elp_bsd_a4", False),
                                             ("elp_bsd_c6", False), ("elp_bsd_d6", False)])
@pytest.mark.parametrize("m,k,n", [(100, 71, 34), (7, 131, 96), (130, 256, 130)])
def test_plain_on_bf16_x_matches_pallas(fmt_name, nibble, m, k, n):
    """The wgmma route's function: bf16 x, float32 out, ragged M, K and N."""
    rng = np.random.default_rng(m + k + n)
    x32 = rng.normal(size=(m, k)).astype(np.float32)
    hi = 256 if nibble else 2 ** TFMT[fmt_name].bits_per_weight
    codes = rng.integers(0, hi, size=((k + 1) // 2 if nibble else k, n)).astype(np.uint8)
    sf = np.float32(0.013)
    xj = jnp.asarray(x32).astype(jnp.bfloat16)
    xt = torch.from_numpy(x32).to(torch.bfloat16)
    np.testing.assert_array_equal(xt.float().numpy(), np.asarray(xj.astype(jnp.float32)))
    jpw = jops.PackedWeight(jnp.asarray(codes), jnp.full((1, 1), sf), fmt_name, nibble, (k, n),
                            None, None, None)
    want = jops.quantized_matmul(xj, jpw, impl="pallas", out_dtype=jnp.float32, interpret=True)
    got = mm.elp_bsd_matmul_plain(xt, torch.from_numpy(codes), torch.tensor(sf),
                                  TFMT[fmt_name], nibble=nibble, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_route_rule_without_launching():
    a4, c6 = TFMT["elp_bsd_a4"], TFMT["elp_bsd_c6"]
    x = torch.zeros(300, 64)
    assert mm.route(x.to(torch.bfloat16), a4) == "wgmma"
    assert mm.route(x.to(torch.bfloat16), c6) == "wgmma"
    assert mm.route(x, a4) == "bf16x3"
    assert mm.route(x, c6) == "bf16x3"
    assert mm.route(x.to(torch.float16), a4) == "bf16x3"
    assert mm.route(x.to(torch.bfloat16), WIDE) == "f32"
    assert mm.route(x, WIDE) == "f32"
    assert mm.route(x.to(torch.float16), WIDE) == "f32"
    before = (mm.elp_bsd_matmul.launches, dict(mm.elp_bsd_matmul.launches_by_route))
    out = mm.elp_bsd_matmul(x.to(torch.bfloat16), torch.zeros(32, 16, dtype=torch.uint8), 1.0, a4,
                            nibble=True)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (300, 16)
    assert (mm.elp_bsd_matmul.launches, mm.elp_bsd_matmul.launches_by_route) == before
    assert set(mm.elp_bsd_matmul.launches_by_route) == set(mm.ROUTES)


@pytest.mark.parametrize("shape,dtype", [((5, 64), torch.bfloat16), ((5, 71), torch.bfloat16),
                                         ((3, 34), torch.uint8), ((3, 48), torch.uint8)])
def test_tma_rows_pads_only_rows_tma_cannot_read(shape, dtype):
    t = torch.arange(shape[0] * shape[1]).reshape(shape).to(dtype)
    got = mm._tma_rows(t)
    assert got.stride(1) == 1 and got.stride(0) * got.element_size() % 16 == 0
    assert got.data_ptr() % 16 == 0
    assert torch.equal(got[:, : shape[1]], t) and not got[:, shape[1]:].any()
    assert (got.data_ptr() == t.data_ptr()) == (shape[1] * t.element_size() % 16 == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
def test_tma_rows_keeps_row_strided_views(dtype):
    """A view into rows of a multiple of 16 bytes (the im2col patches of a K
    that is not one) goes to TMA as it is; a view with other rows is copied."""
    per_row = 16 // torch.empty((), dtype=dtype).element_size()
    buf = torch.arange(6 * 2 * per_row).reshape(6, 2 * per_row).to(dtype)
    view = buf[:, : 2 * per_row - 1]
    got = mm._tma_rows(view)
    assert got.data_ptr() == view.data_ptr() and got.stride() == view.stride()
    odd = torch.arange(6 * 11).reshape(6, 11).to(dtype)[:, :9]
    copied = mm._tma_rows(odd)
    assert copied.data_ptr() != odd.data_ptr() and torch.equal(copied[:, :9], odd)
    assert copied.stride(0) * copied.element_size() % 16 == 0


def test_table_words_are_the_table_unsigned():
    fmt = TFMT["elp_bsd_a4"]
    words = list(mm._table_words(fmt, True))
    assert words == [v & 0xFFFFFFFF for v in decode_table(fmt, True).tolist()]
    assert mm._table_words(fmt, True) is mm._table_words(fmt, True)

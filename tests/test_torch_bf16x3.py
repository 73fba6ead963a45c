"""The bf16x3 routes of both packed matmuls, on the CPU, against the JAX package.

Float32 activations reach the tensor-core kernels split exactly into three
bf16 terms, ``x = hi + mid + lo`` (``repro_torch.kernels.ref.split_bf16x3``,
twin of ``csrc/hopper.cuh::split_bf16x3``). Here the split is held bit for
bit, and the routes' arithmetic (the three terms' float32 products with the
decoded weight, summed) meets the Pallas kernels on float32 x in interpret
mode with the float32 tolerance of ``tests/test_torch_kernels.py`` (rtol
1e-5, atol 1e-4: each term's product is exact, so only the order of the
float32 sums differs). The kernels themselves run on the card
(``tests/test_torch_gpu.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.elp_bsd import PRESET_FORMATS as JFMT  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.fused_decode import fused_decode_matmul as jfused  # noqa: E402
from repro_torch.core.elp_bsd import PRESET_FORMATS as TFMT  # noqa: E402
from repro_torch.kernels import conv  # noqa: E402
from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul_plain  # noqa: E402
from repro_torch.kernels.ref import elp_bsd_matmul_bf16x3, split_bf16x3  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-4)
FLT_MAX = np.finfo(np.float32).max


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy().view(np.uint32)


def _split_cases() -> np.ndarray:
    rng = np.random.default_rng(0)
    # seeded normals' significands (in [1, 2), with their signs) at every exponent
    normals = rng.normal(size=(228, 64)).astype(np.float32)
    sig, _ = np.frexp(normals)
    scaled = np.ldexp(2 * sig, np.arange(-100, 128)[:, None]).astype(np.float32)
    near_max = np.nextafter(np.float32(FLT_MAX), np.float32(0), dtype=np.float32)
    edges = np.array([0.0, -0.0, 1.0, -1.0, FLT_MAX, -FLT_MAX, near_max, -near_max,
                      np.float32(1) + np.finfo(np.float32).eps, 2.0 ** -100, -(2.0 ** -100)],
                     dtype=np.float32)
    return np.concatenate([scaled.ravel(), -scaled.ravel(), edges])


def test_split_bf16x3_is_exact():
    """hi + mid + lo == x bit for bit, each term exact in bf16, hi and mid
    the truncations, over exponents -100..127, zeros, negatives and FLT_MAX."""
    x = torch.from_numpy(_split_cases())
    assert bool(torch.isfinite(x).all())
    hi, mid, lo = split_bf16x3(x)
    for t in (hi, mid, lo):
        assert t.dtype == torch.float32 and bool(torch.isfinite(t).all())
        np.testing.assert_array_equal(_bits(t.to(torch.bfloat16).float()), _bits(t))
    total = (hi + mid) + lo
    assert torch.equal(total, x)  # -0.0 sums to +0.0: equal in value
    nz = x != 0
    np.testing.assert_array_equal(_bits(total[nz]), _bits(x[nz]))
    np.testing.assert_array_equal(_bits(hi), _bits(x) & 0xFFFF0000)
    np.testing.assert_array_equal(_bits(mid), _bits(x - hi) & 0xFFFF0000)
    # each term carries at most 8 significant bits: |mid| <= 2^-8 |x|, |lo| <= 2^-16 |x|
    ax = x.double().abs()
    assert bool((mid.double().abs() <= ax * 2.0 ** -7).all())
    assert bool((lo.double().abs() <= ax * 2.0 ** -15).all())


def test_split_bf16x3_of_float16_and_zeros():
    """float16 x (11 significant bits) fits in hi and mid; lo is zero."""
    rng = np.random.default_rng(1)
    x16 = torch.from_numpy(rng.normal(size=(64, 33)).astype(np.float16))
    hi, mid, lo = split_bf16x3(x16)
    assert not lo.any()
    np.testing.assert_array_equal(_bits(hi + mid), _bits(x16.float()))
    assert not any(t.any() for t in split_bf16x3(torch.zeros(5, 7)))


def _case(fmt_name, nibble, m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    hi = 256 if nibble else 2 ** TFMT[fmt_name].bits_per_weight
    codes = rng.integers(0, hi, size=((k + 1) // 2 if nibble else k, n)).astype(np.uint8)
    return x, codes, np.float32(0.017)


LAYOUTS = [("elp_bsd_a4", True), ("elp_bsd_c6", False)]


@pytest.mark.parametrize("fmt_name,nibble", LAYOUTS)
@pytest.mark.parametrize("m,k,n", [(100, 71, 34), (7, 256, 96), (130, 128, 130)])
def test_bf16x3_arithmetic_matches_pallas_tiled(fmt_name, nibble, m, k, n):
    """The tiled kernel's bf16x3 function on float32 x against the Pallas
    ``elp_bsd_matmul`` (interpret mode), ragged M and N."""
    x, codes, sf = _case(fmt_name, nibble, m, k, n, m + k + n)
    jpw = jops.PackedWeight(jnp.asarray(codes), jnp.full((1, 1), sf), fmt_name, nibble, (k, n),
                            None, None, None)
    # the ops wrapper pads M, K and N to the Pallas kernel's tiles
    want = jops.quantized_matmul(jnp.asarray(x), jpw, impl="pallas", out_dtype=jnp.float32,
                                 interpret=True)
    got = elp_bsd_matmul_bf16x3(torch.from_numpy(x), torch.from_numpy(codes), torch.tensor(sf),
                                TFMT[fmt_name], nibble=nibble)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fmt_name,nibble", LAYOUTS)
@pytest.mark.parametrize("m", [1, 17, 64])
def test_bf16x3_arithmetic_matches_pallas_decode_step(fmt_name, nibble, m):
    """The decode-step kernel's bf16x3 function on float32 x (AlexNet's fc
    layers run M = 64) against the Pallas ``fused_decode_matmul``."""
    k, n = 384, 96
    x, codes, sf = _case(fmt_name, nibble, m, k, n, 100 + m)
    want = jfused(jnp.asarray(x), jnp.asarray(codes), jnp.full((1, 1), sf), JFMT[fmt_name],
                  nibble=nibble, block_n=32, block_k=128, out_dtype=jnp.float32, interpret=True)
    got = elp_bsd_matmul_bf16x3(torch.from_numpy(x), torch.from_numpy(codes), torch.tensor(sf),
                                TFMT[fmt_name], nibble=nibble)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fmt_name,nibble", LAYOUTS)
def test_bf16x3_ragged_k_meets_plain(fmt_name, nibble):
    """An odd K (the nibble pad row) and K = 363 (AlexNet's conv0): the three
    terms' sum against the plain float32 product; one term alone is far off."""
    for m, k, n in [(33, 71, 34), (40, 363, 96)]:
        x, codes, sf = _case(fmt_name, nibble, m, k, n, k)
        xt, ct, st = torch.from_numpy(x), torch.from_numpy(codes), torch.tensor(sf)
        want = elp_bsd_matmul_plain(xt, ct, st, TFMT[fmt_name], nibble=nibble).numpy()
        got = elp_bsd_matmul_bf16x3(xt, ct, st, TFMT[fmt_name], nibble=nibble).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        one = elp_bsd_matmul_bf16x3(xt, ct, st, TFMT[fmt_name], nibble=nibble, terms=1).numpy()
        assert np.abs(one - want).max() > 2e-5 * np.abs(want).max()


def test_conv0_patches_rows_are_tma_aligned():
    """AlexNet conv0's im2col rows (K = 363 float32) lie 364 elements apart,
    as a view; the values are the JAX package's patches."""
    from repro.kernels import conv as jconv

    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 40, 40, 3)).astype(np.float32)
    got = conv.extract_patches(torch.from_numpy(x), 11, 11, stride=4)
    assert got.shape[-1] == 363 and got.stride(-2) == 364 and got.stride(-1) == 1
    flat = got.reshape(-1, 363)
    assert flat.data_ptr() == got.data_ptr() and flat.stride() == (364, 1)
    want = np.asarray(jconv.extract_patches(jnp.asarray(x), 11, 11, stride=4, padding="SAME"))
    np.testing.assert_array_equal(got.numpy(), want)

"""The matmul kernel modules' plain versions and wrappers against the JAX package.

On the CPU each kernel wrapper runs its plain PyTorch version (the CUDA
kernels are held against those on the card, ``tests/test_torch_gpu.py``).
Here the plain versions meet the JAX Pallas kernels in interpret mode at
the shapes of ``tests/test_kernels.py`` and ``tests/test_fused_decode.py``,
with the same tolerance those tests use: rtol 1e-5, atol 1e-4 (float32
sums taken in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.elp_bsd import PRESET_FORMATS as JFMT  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.elp_bsd_matmul import elp_bsd_matmul as j_mm  # noqa: E402
from repro.kernels.fused_decode import fused_decode_matmul as j_fused  # noqa: E402
from repro_torch.core.elp_bsd import PRESET_FORMATS as TFMT  # noqa: E402
from repro_torch.interop import packed_from_numpy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul as t_mm  # noqa: E402
from repro_torch.kernels.fused_decode import MAX_FUSED_M  # noqa: E402
from repro_torch.kernels.fused_decode import fused_decode_matmul as t_fused  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the test runner puts several workers on
    one host, where oversubscribed torch threads slow small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stored(rng, fmt_name, k, n, nibble):
    if nibble:
        return rng.integers(0, 256, size=(k // 2, n)).astype(np.uint8)
    return rng.integers(0, 2 ** TFMT[fmt_name].bits_per_weight, size=(k, n)).astype(np.uint8)


# JAX packing jitted once per shape: eager conversion compiles every op
# separately, which dominates these tests' time. Both sides then use the
# same carried codes and scale factors, so the jit does not enter the parity.
_j_pack = jax.jit(jops.pack_weight, static_argnums=(1,), static_argnames=("granularity",))


def _carry(pw) -> tops.PackedWeight:
    """A JAX PackedWeight -> the port's, through numpy."""
    return packed_from_numpy(
        np.asarray(pw.codes), np.asarray(pw.sf), pw.fmt_name, pw.nibble, pw.shape,
        pw.source_shape, pw.act_scale, pw.act_bits, device="cpu",
    )


@pytest.mark.parametrize("fmt_name", sorted(TFMT))
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 128), (128, 256, 384)])
def test_tiled_plain_matches_pallas_u8(fmt_name, m, k, n):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(m, k)).astype(np.float32)
    codes = _stored(rng, fmt_name, k, n, False)
    want = j_mm(jnp.asarray(x), jnp.asarray(codes), jnp.float32(0.013), JFMT[fmt_name],
                interpret=True)
    got = t_mm(torch.from_numpy(x), torch.from_numpy(codes), 0.013, TFMT[fmt_name])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (128, 512, 256)])
def test_tiled_plain_matches_pallas_nibble(m, k, n):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(m, k)).astype(np.float32)
    packed = _stored(rng, "elp_bsd_a4", k, n, True)
    want = j_mm(jnp.asarray(x), jnp.asarray(packed), jnp.float32(0.05), JFMT["elp_bsd_a4"],
                nibble=True, interpret=True)
    got = t_mm(torch.from_numpy(x), torch.from_numpy(packed), 0.05, TFMT["elp_bsd_a4"],
               nibble=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (fmt, nibble): the storable layouts, as in tests/test_fused_decode.py
GRID = [("elp_bsd_a4", True), ("elp_bsd_a4", False), ("elp_bsd_c6", False)]


@pytest.mark.parametrize("fmt_name,nibble", GRID)
@pytest.mark.parametrize("m,k,n", [(1, 128, 128), (4, 256, 384), (8, 384, 256)])
def test_fused_plain_matches_pallas(fmt_name, nibble, m, k, n):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(m, k)).astype(np.float32)
    stored = _stored(rng, fmt_name, k, n, nibble)
    want = j_fused(jnp.asarray(x), jnp.asarray(stored), jnp.float32(0.017), JFMT[fmt_name],
                   nibble=nibble, interpret=True)
    got = t_fused(torch.from_numpy(x), torch.from_numpy(stored), 0.017, TFMT[fmt_name],
                  nibble=nibble)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_kernel_wrappers_raise_like_pallas():
    """The operand contract of the Pallas kernels; unlike them, the port's
    kernels take ragged M, K and N (they mask the edges), so the tiling
    checks live in ``quantized_matmul`` (see the next tests)."""
    x = torch.zeros(128, 128)
    codes = torch.zeros(128, 128, dtype=torch.uint8)
    fmt = TFMT["elp_bsd_a4"]
    assert t_mm(x[:100, :71], codes[:36, :34], 0.01, fmt, nibble=True).shape == (100, 34)
    with pytest.raises(ValueError, match="K dim must match"):
        t_mm(x, codes[:64], 0.01, fmt)
    with pytest.raises(ValueError, match="two K rows per byte"):
        t_mm(x, codes[:100], 0.01, fmt, nibble=True)
    with pytest.raises(ValueError, match="two K rows per byte"):
        t_fused(x[:4, :71], codes[:35], 0.01, fmt, nibble=True)
    with pytest.raises(ValueError, match="x\\[M, K\\]"):
        t_mm(x[0], codes, 0.01, fmt)
    with pytest.raises(ValueError, match="exceeds"):
        t_fused(torch.zeros(MAX_FUSED_M + 1, 128), codes, 0.01, fmt)
    with pytest.raises(ValueError, match="one scale factor"):
        t_fused(x[:4], codes, torch.ones(2), fmt)


def test_cpu_wrappers_never_count_launches():
    fmt = TFMT["elp_bsd_a4"]
    before = (t_mm.launches, t_fused.launches)
    t_mm(torch.zeros(128, 128), torch.zeros(64, 128, dtype=torch.uint8), 1.0, fmt, nibble=True)
    t_fused(torch.zeros(4, 128), torch.zeros(64, 128, dtype=torch.uint8), 1.0, fmt, nibble=True)
    assert (t_mm.launches, t_fused.launches) == before


@pytest.mark.parametrize("impl", ["tiled", "fused"])
@pytest.mark.parametrize("granularity", ["per_tensor", "per_channel"])
@pytest.mark.parametrize("fmt_name", ["elp_bsd_a4", "elp_bsd_c6"])
def test_quantized_matmul_padding_and_per_channel(impl, granularity, fmt_name):
    """Odd K (nibble pad row), non-tile M and N, both scale granularities:
    the port's wrapper on JAX-packed codes against JAX's xla path."""
    rng = np.random.default_rng(4)
    w = (rng.normal(size=(131, 96)) * 0.1).astype(np.float32)
    jpw, _ = _j_pack(jnp.asarray(w), fmt_name, granularity=granularity)
    x = rng.normal(size=(7, 131)).astype(np.float32)
    want = np.asarray(jops.quantized_matmul(jnp.asarray(x), jpw, impl="xla"))
    pw = _carry(jpw)
    got = tops.quantized_matmul(torch.from_numpy(x), pw, impl=impl)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(tops.dequantize(pw).numpy(), np.asarray(jops.dequantize(jpw)))
    np.testing.assert_array_equal(
        tops.dequantize_shift_add(pw).numpy(), np.asarray(jops.dequantize_shift_add(jpw))
    )


def test_quantized_matmul_static_act_scale_and_errors():
    rng = np.random.default_rng(6)
    w = (rng.normal(size=(64, 32)) * 0.1).astype(np.float32)
    jpw, _ = _j_pack(jnp.asarray(w), "elp_bsd_a4")
    jpw = type(jpw)(jpw.codes, jpw.sf, jpw.fmt_name, jpw.nibble, jpw.shape, None, 1.5, 6)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    want = np.asarray(jops.quantized_matmul(jnp.asarray(x), jpw, impl="xla"))
    pw = _carry(jpw)
    got = tops.quantized_matmul(torch.from_numpy(x), pw)
    assert got.shape == (3, 5, 32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="block_sizes must be"):
        tops.quantized_matmul(torch.from_numpy(x), pw, block_sizes=(128, 128))
    with pytest.raises(ValueError, match="even block_k"):
        tops.quantized_matmul(torch.from_numpy(x), pw, block_k=63)
    with pytest.raises(ValueError, match="must be positive"):
        tops.quantized_matmul(torch.from_numpy(x), pw, block_sizes=(0, 128, 128))
    with pytest.raises(ValueError, match="unknown impl"):
        tops.quantized_matmul(torch.from_numpy(x), pw, impl="xla")
    with pytest.raises(ValueError, match="does not match"):
        tops.quantized_matmul(torch.from_numpy(x[..., :63]), pw)


def test_pack_weight_matches_jax_and_roundtrips():
    w = (np.random.default_rng(7).normal(size=(131, 96)) * 0.1).astype(np.float32)
    jpw, jvals = jops.pack_weight(jnp.asarray(w), "elp_bsd_a4")
    pw, vals = tops.pack_weight(torch.from_numpy(w), "elp_bsd_a4")
    assert pw.nibble and tuple(pw.codes.shape) == (66, 96)
    np.testing.assert_array_equal(pw.codes.numpy(), np.asarray(jpw.codes))
    np.testing.assert_array_equal(pw.sf.numpy(), np.asarray(jpw.sf))
    np.testing.assert_array_equal(tops.dequantize(pw).numpy(), vals.numpy())
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("fmt_name,nibble", GRID + [("elp_bsd_d6", False)])
def test_ref_oracles_match_jax(fmt_name, nibble):
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref

    rng = np.random.default_rng(8)
    stored = _stored(rng, fmt_name, 64, 48, nibble)
    x = rng.normal(size=(5, 64)).astype(np.float32)
    want = np.asarray(jref.dequantize_ref(jnp.asarray(stored), jnp.float32(0.02), JFMT[fmt_name],
                                          nibble=nibble))
    got = tref.dequantize_ref(torch.from_numpy(stored), torch.tensor(0.02), TFMT[fmt_name],
                              nibble=nibble)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jref.elp_bsd_matmul_ref(jnp.asarray(x), jnp.asarray(stored),
                                              jnp.float32(0.02), JFMT[fmt_name], nibble=nibble))
    got = tref.elp_bsd_matmul_ref(torch.from_numpy(x), torch.from_numpy(stored),
                                  torch.tensor(0.02), TFMT[fmt_name], nibble=nibble)
    np.testing.assert_allclose(got.numpy(), want, **TOL)

"""The packed conv (im2col into the packed matmul) against the JAX package.

The port's ``quantized_conv2d`` on JAX-packed codes against JAX's
``lax.conv`` path over kernel size x stride x padding (stride-2 VALID
included), and AlexNet conv0's asymmetric SAME pads. Tolerance rtol 1e-5,
atol 1e-4, as in ``tests/test_kernels.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.kernels import conv as jconv  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.interop import packed_from_numpy  # noqa: E402
from repro_torch.kernels import conv as tconv  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-4)
# JAX packing jitted once per shape (eager conversion compiles every op);
# both sides use the same carried codes, so the jit does not enter the parity.
_j_pack = jax.jit(jops.pack_conv_weight, static_argnums=(1,), static_argnames=("granularity",))


def _carry(pw):
    return packed_from_numpy(
        np.asarray(pw.codes), np.asarray(pw.sf), pw.fmt_name, pw.nibble, pw.shape,
        pw.source_shape, device="cpu",
    )


@pytest.mark.parametrize("ksize", [1, 3, 5])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_quantized_conv2d_matches_jax_grid(ksize, stride, padding):
    """The port's im2col conv on JAX-packed codes against JAX's lax.conv path,
    over ksize x stride x padding (stride-2 VALID included)."""
    rng = np.random.default_rng(ksize * 10 + stride)
    x = rng.normal(size=(2, 9, 9, 8)).astype(np.float32)
    w = (rng.normal(size=(ksize, ksize, 8, 16)) * 0.1).astype(np.float32)
    jpw, _ = _j_pack(jnp.asarray(w), "elp_bsd_a4")
    want = np.asarray(
        jconv.quantized_conv2d(jnp.asarray(x), jpw, stride=stride, padding=padding, impl="xla")
    )
    got = tconv.quantized_conv2d(torch.from_numpy(x), _carry(jpw), stride=stride, padding=padding)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_alexnet_conv0_same_pads_are_asymmetric():
    """11x11 stride 4 on 224: SAME pads (3, 4), which F.conv2d cannot express."""
    assert tconv._out_size_and_pads(224, 11, 4, "SAME") == (56, (3, 4))
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1, 224, 224, 3)).astype(np.float32)
    w = (rng.normal(size=(11, 11, 3, 8)) * 0.05).astype(np.float32)
    want = np.asarray(jconv.extract_patches(jnp.asarray(x), 11, 11, stride=4, padding="SAME"))
    got = tconv.extract_patches(torch.from_numpy(x), 11, 11, stride=4, padding="SAME")
    np.testing.assert_array_equal(got.numpy(), want)
    jpw, _ = _j_pack(jnp.asarray(w), "elp_bsd_a4", granularity="per_channel")
    want = np.asarray(jconv.quantized_conv2d(jnp.asarray(x), jpw, stride=4, impl="xla"))
    got = tconv.quantized_conv2d(torch.from_numpy(x), _carry(jpw), stride=4)
    assert tuple(got.shape) == (1, 56, 56, 8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the float path (F.conv2d with explicit pads) against lax.conv
    flt = tconv.conv2d_nhwc(torch.from_numpy(x), torch.from_numpy(w), stride=4)
    want = lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (4, 4), "SAME",
                                    dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_allclose(flt.numpy(), np.asarray(want), **TOL)

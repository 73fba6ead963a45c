"""The port's ``models/layers.py`` against the JAX package's, on the CPU.

Same numpy inputs (seeded) through both. Tolerances: float32 elementwise
functions agree to 1e-6 relative (exp/rsqrt/cos may differ by an ulp
between the two libraries); float32 contractions to 1e-5 (sums in another
order); rotate-half itself is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

RNG = np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the test runner puts several workers on
    one host, where oversubscribed torch threads slow small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


def test_rms_norm_matches():
    x, s = _np((2, 5, 32)), _np((32,), 0.1)
    _close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(s)),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(s)), 1e-6)
    # bfloat16: the same three roundings (inv, 1 + scale, each product) -> 1 bf16 step
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tl.rms_norm(xb, torch.from_numpy(s).to(torch.bfloat16)).float().numpy()
    want = jl.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(s, jnp.bfloat16))
    _close(got, np.asarray(want, np.float32), 2.0 ** -7)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_tables_and_rotation_match(theta):
    pos = np.arange(12)[None, :] + 3
    cos_t, sin_t = tl.rope_embed(torch.from_numpy(pos), 16, theta)
    cos_j, sin_j = jl.rope_embed(jnp.asarray(pos), 16, theta)
    _close(cos_t, cos_j, 1e-6)
    _close(sin_t, sin_j, 1e-6)
    x = _np((2, 12, 4, 16))
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(np.asarray(cos_j)),
                        torch.from_numpy(np.asarray(sin_j)))
    _close(got, jl.apply_rope(jnp.asarray(x), cos_j, sin_j), 1e-6)
    # per-row tables [B, S, hd/2] (continuous batching positions)
    pos2 = np.stack([np.arange(5), np.arange(5) + 7])
    c2, s2 = jl.rope_embed(jnp.asarray(pos2), 16, theta)
    x2 = _np((2, 5, 4, 16))
    got = tl.apply_rope(torch.from_numpy(x2), torch.from_numpy(np.asarray(c2)),
                        torch.from_numpy(np.asarray(s2)))
    _close(got, jl.apply_rope(jnp.asarray(x2), c2, s2), 1e-6)


def test_rotate_half_is_exact():
    """Slice + concatenate equals the JAX package's ±1 contraction bit for bit."""
    x = _np((3, 7, 2, 16))
    ones, zeros = np.ones((1, 7, 8), np.float32), np.zeros((1, 7, 8), np.float32)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(zeros), torch.from_numpy(ones))
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(zeros), jnp.asarray(ones))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_repeat_kv_matches():
    k = _np((2, 5, 2, 8))
    assert np.array_equal(tl.repeat_kv(torch.from_numpy(k), 3).numpy(),
                          np.asarray(jl.repeat_kv(jnp.asarray(k), 3)))


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, 0, 0), (False, 0, 0), (True, 4, 0), (True, 0, 6), (True, 0, np.array([3, 9])),
    (True, 3, np.array([0, 5])),
])
def test_attention_dot_matches(causal, window, q_offset):
    q, k, v = _np((2, 4, 4, 8)), _np((2, 16, 4, 8)), _np((2, 16, 4, 8))
    off_t = torch.from_numpy(q_offset) if isinstance(q_offset, np.ndarray) else q_offset
    got = tl.attention_dot(*map(torch.from_numpy, (q, k, v)), causal=causal, window=window,
                           q_offset=off_t)
    want = jl.attention_dot(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                            window=window, q_offset=jnp.asarray(q_offset))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("q_offset", [0, np.array([2, 30])])
def test_attention_chunked_matches(q_offset):
    q, k, v = _np((2, 8, 2, 8)), _np((2, 64, 2, 8)), _np((2, 64, 2, 8))
    off_t = torch.from_numpy(q_offset) if isinstance(q_offset, np.ndarray) else q_offset
    got = tl.attention_chunked(*map(torch.from_numpy, (q, k, v)), chunk=16, q_offset=off_t)
    want = jl.attention_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=16,
                                q_offset=jnp.asarray(q_offset))
    _close(got, want, 1e-5)
    _close(got, tl.attention_dot(*map(torch.from_numpy, (q, k, v)), q_offset=off_t), 1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_apply_matches(kind):
    p = {"w1": _np((32, 48), 0.2), "w2": _np((48, 32), 0.2), "w3": _np((32, 48), 0.2)}
    x = _np((2, 3, 32))
    acts_t, acts_j = {}, {}
    got = tl.mlp_apply(params_from_numpy(p, device="cpu"), torch.from_numpy(x), kind, acts_t)
    want = jl.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), kind, acts_j)
    _close(got, want, 1e-5)
    _close(acts_t["ffn_hidden"], acts_j["ffn_hidden"], 1e-5)


def test_matmul_float_and_packed_match():
    w, x = _np((40, 24), 0.2), _np((3, 5, 40))
    _close(tl.matmul(torch.from_numpy(x), torch.from_numpy(w)),
           jl.matmul(jnp.asarray(x), jnp.asarray(w)), 1e-5)
    jpw, _ = jops.pack_weight(jnp.asarray(w), "elp_bsd_a4")
    tpw, _ = tops.pack_weight(torch.from_numpy(w), "elp_bsd_a4")
    assert np.array_equal(np.asarray(jpw.codes), tpw.codes.numpy())
    # packed: the kernels' plain version scales after the product, the JAX
    # path decodes scaled weights first: float32 rounding apart
    _close(tl.matmul(torch.from_numpy(x), tpw), jl.matmul(jnp.asarray(x), jpw), 1e-5)


def test_dense_init_scale_and_truncation():
    g = torch.Generator().manual_seed(0)
    w = tl.dense_init(g, (256, 512), torch.float32, scale=2.0)
    std = 2.0 / 16.0
    assert float(w.abs().max()) <= 2.0 * std + 1e-7
    # a N(0,1) cut at ±2 has std 0.8796
    assert abs(float(w.std()) / std - 0.8796) < 0.01

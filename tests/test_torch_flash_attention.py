"""The flash-attention kernel's plain version against the JAX package, on the CPU.

``flash_attention`` on CPU tensors runs ``flash_attention_plain`` (the CUDA
kernel is held against it on the card, ``tests/test_torch_gpu.py``). Here
the plain version meets the JAX Pallas kernel in interpret mode and
``layers.attention_dot`` at the shapes of ``tests/test_kernels.py``.
Tolerances: float32 at 2e-5 (sums and the softmax normaliser in another
order); bfloat16 inputs at 3e-2 as the JAX package's own test holds its
kernel (the output is rounded to bfloat16, 2^-8 relative, on values up to
about 3), and at one bfloat16 step against the same float32 math.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.models.layers import attention_dot as jdot  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_plain,
)
from repro_torch.models import layers as tl  # noqa: E402


def _qkv(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32).astype(dtype) for _ in range(3)]


def _tr(x):
    return jnp.moveaxis(x, 1, 2)  # [B, H, S, hd] <-> [B, S, H, hd]


@pytest.mark.parametrize("b,h,s,hd", [(1, 2, 256, 64), (2, 4, 384, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_jax_kernel_and_attention_dot(b, h, s, hd, causal):
    q, k, v = _qkv(7, (b, h, s, hd))
    before = flash_attention.launches
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal).numpy()
    assert flash_attention.launches == before  # CPU tensors: the plain version, no launch
    want = np.asarray(jflash(*map(jnp.asarray, (q, k, v)), causal=causal, block_q=128,
                             block_k=128, interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    dot = np.asarray(_tr(jdot(*(_tr(jnp.asarray(t)) for t in (q, k, v)), causal=causal)))
    np.testing.assert_allclose(got, dot, rtol=2e-5, atol=2e-5)


def test_plain_bf16_matches_jax_kernel():
    q, k, v = _qkv(8, (1, 2, 256, 64))
    tq, tk, tv = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    got = flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    want = np.asarray(jflash(jq, jk, jv, interpret=True), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2, atol=3e-2)
    # the same math in float32 on the bf16 values, rounded once: one bf16 step apart at most
    f32 = flash_attention_plain(tq.float(), tk.float(), tv.float())
    assert (got.float() - f32).abs().max().item() <= 2.0 ** -8 * f32.abs().max().item()


def test_gqa_heads_and_q_offset_match_attention_dot():
    """k/v with fewer heads read head h // group; q_offset places the queries
    after a cached prefix: the same as attention_dot over repeated heads."""
    rng = np.random.default_rng(9)
    q = rng.normal(size=(2, 8, 128, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 2, 256, 16)).astype(np.float32) for _ in range(2))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), q_offset=128)
    rep = lambda t: tl.repeat_kv(torch.from_numpy(t).transpose(1, 2), 4)  # noqa: E731
    want = tl.attention_dot(torch.from_numpy(q).transpose(1, 2), rep(k), rep(v),
                            q_offset=128).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_padded_keys_past_every_query_change_nothing():
    """The transformer pads keys to the block: causal masking hides them."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(10, (1, 2, 128, 32)))
    pad = torch.randn(1, 2, 128, 32)
    got = flash_attention(q, torch.cat([k, pad], 2), torch.cat([v, pad], 2))
    torch.testing.assert_close(got, flash_attention(q, k, v), rtol=1e-6, atol=1e-6)


def test_wrapper_checks_like_the_jax_kernel():
    q = torch.zeros(1, 2, 100, 64)
    with pytest.raises(ValueError, match="tile by the block sizes"):
        flash_attention(q, q, q)
    ok = torch.zeros(1, 2, 128, 64)
    with pytest.raises(ValueError, match="H % KVH"):
        flash_attention(torch.zeros(1, 3, 128, 64), ok, ok)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(ok, ok, ok, q_offset=-1)

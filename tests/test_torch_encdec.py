"""The port's enc-dec model (seamless-m4t's backbone) against the JAX package's.

seamless-m4t-large-v2 at ``reduced()`` widths (float32, 2 encoder and 2
decoder layers, d_model 64, 4 heads of 16, GELU MLP), the same weights in
both packages (a JAX key, carried across as numpy) and the same numpy
frame embeddings and tokens, each test with its own seed:

  * ``encode``: ``frontend_proj``, the non-causal encoder stack (its
    attention on the flash path: more than one query a row, keys at their
    true count, 20 and 200 frames against the 128-row block) and
    ``enc_norm``;
  * one decoder block with cross-attention over an encoder output
    (``ln_x``, ``xq``/``xk``/``xv``/``xo``, no RoPE) without a cache, and in
    a decode step against a cache (one query a row: ``attention_dot``);
  * prefill (the serve state ``(cache, enc_out)``) and greedy decode steps.

Tolerance: 1e-4 of the reference's largest value, for a block and a whole
stack alike (float32 sums in another order). Non-causal flash at a ragged
key count is held against the JAX kernel in interpret mode, with its
zero-key control.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.layers import rope_embed as jrope  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.layers import rope_embed as trope  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the test runner puts several workers on
    one host, where oversubscribed torch threads slow small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


@pytest.fixture(scope="module")
def model():
    jc, tc = (get("seamless_m4t_large_v2").reduced() for get in (jget, tget))
    assert tc.family == "audio" and tc.n_dec_layers == 2
    jp, tparams = tp.lm_params(jc)
    return jc, tc, jp, tparams


def _frames(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


@pytest.mark.parametrize("frames", [20, 200])
def test_encode_matches_reference(model, frames):
    jc, tc, jp, tparams = model
    src = _frames(frames, 2, frames, tc.d_model)
    want = jax.jit(lambda p, v: jed.encode(p, jc, v))(jp, jnp.asarray(src))
    _close(ted.encode(tparams, tc, torch.from_numpy(src)), want, 1e-4)


@pytest.mark.parametrize("form", ["prefill", "decode"])
def test_cross_attention_block_matches_reference(model, form):
    jc, tc, jp, tparams = model
    rng = np.random.default_rng(3)
    jlp = jax.tree.map(lambda a: a[1], jp["decoder"])
    tlp = ttr.layer_params(tparams["decoder"], 1)
    assert {"ln_x", "xq", "xk", "xv", "xo"} <= set(tlp)
    enc = rng.normal(size=(2, 30, tc.d_model)).astype(np.float32)
    if form == "prefill":
        x = rng.normal(size=(2, 24, tc.d_model)).astype(np.float32)
        pos = np.arange(24)[None]
        jrp, trp = jrope(jnp.asarray(pos), jc.hd), trope(torch.from_numpy(pos), tc.hd)
        want, _ = jax.jit(lambda p, v, e: jtr.block_apply(
            p, jc, v, rope=(*jrp, *jrp), causal=True, enc_out=e))(jlp, jnp.asarray(x),
                                                                  jnp.asarray(enc))
        got, _ = ttr.block_apply(tlp, tc, torch.from_numpy(x), rope=(*trp, *trp), causal=True,
                                 enc_out=torch.from_numpy(enc))
        _close(got, want, 1e-4)
        return
    ck, cv = (rng.normal(size=(2, 16, tc.n_kv_heads, tc.hd)).astype(np.float32)
              for _ in range(2))
    x = rng.normal(size=(2, 1, tc.d_model)).astype(np.float32)
    pos = np.array([[9]])
    jrp, trp = jrope(jnp.asarray(pos), jc.hd), trope(torch.from_numpy(pos), tc.hd)
    want, (wk, wv) = jax.jit(lambda p, v, e, k_, v_: jtr.block_apply(
        p, jc, v, rope=(*jrp, *jrp), causal=True, kv_cache=(k_, v_), cache_pos=jnp.int32(9),
        enc_out=e))(jlp, jnp.asarray(x), jnp.asarray(enc), jnp.asarray(ck), jnp.asarray(cv))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, _ = ttr.block_apply(tlp, tc, torch.from_numpy(x), rope=(*trp, *trp), causal=True,
                             kv_cache=(tk, tv), cache_pos=9, enc_out=torch.from_numpy(enc))
    _close(got, want, 1e-4)
    _close(tk, wk, 1e-4)
    _close(tv, wv, 1e-4)


def test_prefill_and_decode_match_reference(model):
    """200 frames (ragged against the flash block) and a 16-token prompt: the
    prefill's logits, decoder cache and encoder output, then four greedy steps."""
    jc, tc, jp, tparams = model
    rng = np.random.default_rng(7)
    src = _frames(8, 2, 200, tc.d_model)
    tokens = rng.integers(0, jc.vocab, (2, 16)).astype(np.int32)
    jcache, tcache = jed.init_cache(jc, 2, 24), ted.init_cache(tc, 2, 24, device="cpu")
    want, (jcache, jenc) = jax.jit(lambda p, t, c, f: jed.prefill(p, jc, t, c, frontend=f))(
        jp, jnp.asarray(tokens), jcache, jnp.asarray(src))
    got, (tcache, tenc) = ted.prefill(tparams, tc, torch.from_numpy(tokens), tcache,
                                      frontend=torch.from_numpy(src))
    _close(got, want, 1e-4)
    _close(tenc, jenc, 1e-4)
    for key in ("k", "v"):
        _close(tcache[key][:, :, :16], jcache[key][:, :, :16], 1e-4)
    step = jax.jit(lambda p, t, st, pos: jed.decode_step(p, jc, t, st, pos))
    jstate, tstate = (jcache, jenc), (tcache, tenc)
    for i in range(4):
        tok = np.asarray(want).argmax(-1).astype(np.int32)
        want, jstate = step(jp, jnp.asarray(tok), jstate, jnp.int32(16 + i))
        got, tstate = ted.decode_step(tparams, tc, torch.from_numpy(tok), tstate, 16 + i)
        _close(got, want, 1e-4)
    full = jax.jit(lambda p, t, f: jed.forward(p, jc, t, frontend=f))(
        jp, jnp.asarray(tokens), jnp.asarray(src))
    _close(ted.forward(tparams, tc, torch.from_numpy(tokens), frontend=torch.from_numpy(src)),
           full, 1e-4)


def test_noncausal_flash_at_a_ragged_key_count():
    """seamless's shapes: hd 64, 200 encoder frames as the keys."""
    tp.check_noncausal_ragged_flash(9, b=1, h=2, kvh=2, sq=128, sk=200, hd=64, block_k=40)

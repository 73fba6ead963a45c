"""The port's RecurrentGemma hybrid (RG-LRU + local attention) against the JAX package's.

recurrentgemma-2b at ``reduced()`` widths (float32, 3 layers: rec, rec,
attn; d_model and lru 64, 4 heads of 16 with 1 KV head, window 32), the
same weights in both packages (a JAX key, carried across as numpy) and the
same numpy inputs, each test with its own seed:

  * ``_rg_lru`` at S = 128 (the doubling scan's 7 steps against
    ``lax.associative_scan``) with and without an entering state, and the
    one-step decode update;
  * ``rec_block`` as a prefill from a cached conv window and state, and as
    a decode step;
  * the ring cache: a prompt shorter than the window, then decode steps that
    carry the write position past it (the slot mask), and a prompt longer
    than the window (the ring filled by a roll), each step's logits and the
    ring's contents against the reference.

Tolerance: 1e-4 of the reference's largest value, for a single op and a
whole model alike (float32 sums and exponentials in another order; the
doubling scan multiplies the same pairs in another tree). The
port's softplus is ``logaddexp(x, 0)``, ``jax.nn.softplus``'s definition
(``F.softplus`` returns x above 20, which would differ by about 2e-9 of x).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import rglru as jr  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import rglru as tr  # noqa: E402
from repro_torch.models.transformer import layer_params  # noqa: E402


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
    jc, tc = jget("recurrentgemma_2b").reduced(), tget("recurrentgemma_2b").reduced()
    assert tc.window == 32 and tc.period == ("rec", "rec", "attn")
    jp, tparams = tp.lm_params(jc)
    return jc, tc, jp, tparams


def _rec_layer(model, i=1):
    jc, tc, jp, tparams = model
    return jax.tree.map(lambda a: a[i], jp["rec"]), layer_params(tparams["rec"], i)


@pytest.mark.parametrize("s,with_h0", [(128, False), (128, True), (1, True)],
                         ids=["scan", "scan_h0", "decode"])
def test_rg_lru_matches_reference(model, s, with_h0):
    jlp, tlp = _rec_layer(model)
    rng = np.random.default_rng(s + with_h0)
    x = rng.normal(size=(2, s, 64)).astype(np.float32)
    h0 = rng.normal(size=(2, 64)).astype(np.float32) if with_h0 else None
    want_y, want_h = jr._rg_lru(jlp, jnp.asarray(x), None if h0 is None else jnp.asarray(h0))
    got_y, got_h = tr._rg_lru(tlp, torch.from_numpy(x),
                              None if h0 is None else torch.from_numpy(h0))
    _close(got_y, want_y, 1e-4)
    _close(got_h, want_h, 1e-4)


@pytest.mark.parametrize("s", [20, 1], ids=["prefill", "decode"])
def test_rec_block_matches_reference(model, s):
    jc, tc, _, _ = model
    jlp, tlp = _rec_layer(model, 0)
    rng = np.random.default_rng(10 + s)
    x = rng.normal(size=(2, s, tc.d_model)).astype(np.float32)
    win = rng.normal(size=(2, tc.conv_width - 1, 64)).astype(np.float32)
    h0 = rng.normal(size=(2, 64)).astype(np.float32)
    want, (wwin, wh) = jax.jit(lambda p, v, c, h: jr.rec_block(p, jc, v, state=(c, h)))(
        jlp, *map(jnp.asarray, (x, win, h0)))
    got, (gwin, gh) = tr.rec_block(tlp, tc, torch.from_numpy(x),
                                   state=(torch.from_numpy(win), torch.from_numpy(h0)))
    _close(got, want, 1e-4)
    _close(gwin, wwin, 1e-4)
    _close(gh, wh, 1e-4)
    want, _ = jax.jit(lambda p, v: jr.rec_block(p, jc, v))(jlp, jnp.asarray(x))
    got, state = tr.rec_block(tlp, tc, torch.from_numpy(x))
    assert state is None
    _close(got, want, 1e-4)


@pytest.mark.parametrize("prompt,steps", [(24, 14), (40, 4)], ids=["wrap_in_decode",
                                                                  "prompt_past_window"])
def test_ring_cache_matches_reference_across_the_window(model, prompt, steps):
    jc, tc, jp, tparams = model
    tokens = np.random.default_rng(prompt).integers(0, jc.vocab, (2, prompt)).astype(np.int32)
    jcache = jr.init_cache(jc, 2, 64)
    tcache = tr.init_cache(tc, 2, 64, device="cpu")
    assert tuple(tcache["k"].shape) == tuple(jcache["k"].shape) == (1, 2, 32, 1, 16)
    want, jcache = jax.jit(lambda p, t, c: jr.prefill(p, jc, t, c))(jp, jnp.asarray(tokens),
                                                                   jcache)
    got, tcache = tr.prefill(tparams, tc, torch.from_numpy(tokens), tcache)
    _close(got, want, 1e-4)
    for key in ("k", "v", "conv", "h"):
        _close(tcache[key], jcache[key], 1e-4)
    step = jax.jit(lambda p, t, c, pos: jr.decode_step(p, jc, t, c, pos))
    for i in range(steps):
        tok = np.asarray(want).argmax(-1).astype(np.int32)
        want, jcache = step(jp, jnp.asarray(tok), jcache, jnp.int32(prompt + i))
        got, tcache = tr.decode_step(tparams, tc, torch.from_numpy(tok), tcache, prompt + i)
        _close(got, want, 1e-4)
    assert prompt + steps > tc.window  # the write position crossed the window
    for key in ("k", "v", "h"):
        _close(tcache[key], jcache[key], 1e-4)


def test_cacheless_forward_matches_reference(model):
    jc, tc, jp, tparams = model
    tokens = np.random.default_rng(5).integers(0, jc.vocab, (2, 48)).astype(np.int32)
    want = jax.jit(lambda p, t: jr.forward(p, jc, t))(jp, jnp.asarray(tokens))
    _close(tr.forward(tparams, tc, torch.from_numpy(tokens)), want, 1e-4)


def test_noncausal_flash_at_a_ragged_key_count():
    tp.check_noncausal_ragged_flash(6, b=2, h=4, kvh=1, sq=128, sk=160, hd=32, block_k=32)

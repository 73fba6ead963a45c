"""The port's mamba2 (SSD) against the JAX package's, on the CPU.

mamba2-780m at ``reduced()`` widths (float32, d_model 64, 2 layers, 8 SSD
heads of 16, state 16), the same weights in both packages (a JAX key,
carried across as numpy) and the same numpy inputs, seed 0 unless a test
names another:

  * ``_ssd_chunked`` at S = 128 (one chunk) and S = 512 (two chunks of 256:
    the inter-chunk loop), with and without an entering state;
  * ``_causal_conv`` (the port's ``layers.causal_conv``, shared with the RG-LRU block);
  * ``block_apply`` in both forms, the chunked parallel one and the
    one-token decode step with a state;
  * prefill at S = 512 through the whole model, its state and the decode
    steps after it.

Tolerance: 1e-4 of the reference's largest value, for a single op and a
whole model alike (float32 sums and exponentials in another order; the
SSD's outputs sum up to 256 products with cancellation, and one of several
parallel runs read 2.5e-5 of max |y| where the others read 3e-6). The
port's softplus is ``logaddexp(x, 0)``, ``jax.nn.softplus``'s definition
(``F.softplus`` returns x above 20, which would differ by about 2e-9 of
x). Non-causal flash at a ragged key count is checked here as in
the other recurrent and enc-dec test files.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import mamba2 as jm  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import mamba2 as tm  # noqa: E402
from repro_torch.models.layers import causal_conv  # noqa: E402
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
    jc, tc = jget("mamba2_780m").reduced(), tget("mamba2_780m").reduced()
    jp, tparams = tp.lm_params(jc)
    return jc, tc, jp, tparams


def _ssd_inputs(seed, b, s, nh, hd, st):
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(b, s, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, nh)) - 3.0)).astype(np.float32)
    a = -np.arange(1, nh + 1, dtype=np.float32)
    bm, cm = (rng.normal(size=(b, s, st)).astype(np.float32) for _ in range(2))
    h0 = rng.normal(size=(b, nh, hd, st)).astype(np.float32)
    return xh, dt, a, bm, cm, h0


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_state", "h0"])
@pytest.mark.parametrize("s", [128, 512])
def test_ssd_chunked_matches_reference(s, with_h0):
    xh, dt, a, bm, cm, h0 = _ssd_inputs(s, 2, s, 8, 16, 16)
    h0 = h0 if with_h0 else None
    args = (xh, dt, a, bm, cm)
    want_y, want_h = jax.jit(jm._ssd_chunked)(*map(jnp.asarray, args),
                                              None if h0 is None else jnp.asarray(h0))
    got_y, got_h = tm._ssd_chunked(*map(torch.from_numpy, args),
                                   None if h0 is None else torch.from_numpy(h0))
    _close(got_y, want_y, 1e-4)
    _close(got_h, want_h, 1e-4)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 20, 96)).astype(np.float32)
    w = rng.normal(size=(4, 96)).astype(np.float32)
    b = rng.normal(size=(96,)).astype(np.float32)
    want = jm._causal_conv(*map(jnp.asarray, (x, w, b)))
    _close(causal_conv(*map(torch.from_numpy, (x, w, b))), want, 1e-6)


@pytest.mark.parametrize("form", ["parallel", "decode"])
def test_block_apply_matches_reference(model, form):
    jc, tc, jp, tparams = model
    rng = np.random.default_rng(2)
    jlp = jax.tree.map(lambda a: a[1], jp["blocks"])
    tlp = layer_params(tparams["blocks"], 1)
    d_in, nh, hd, st = tm.dims(tc)
    if form == "parallel":
        x = rng.normal(size=(2, 32, tc.d_model)).astype(np.float32)
        want, _ = jax.jit(lambda p, v: jm.block_apply(p, jc, v))(jlp, jnp.asarray(x))
        got, state = tm.block_apply(tlp, tc, torch.from_numpy(x))
        assert state is None
        _close(got, want, 1e-4)
        return
    x = rng.normal(size=(2, 1, tc.d_model)).astype(np.float32)
    conv = rng.normal(size=(2, tc.conv_width - 1, d_in + 2 * st)).astype(np.float32)
    h0 = rng.normal(size=(2, nh, hd, st)).astype(np.float32)
    want, (wconv, wh) = jax.jit(lambda p, v, c, h: jm.block_apply(p, jc, v, state=(c, h)))(
        jlp, *map(jnp.asarray, (x, conv, h0)))
    got, (gconv, gh) = tm.block_apply(tlp, tc, torch.from_numpy(x),
                                      state=(torch.from_numpy(conv), torch.from_numpy(h0)))
    _close(got, want, 1e-4)
    _close(gconv, wconv, 1e-4)  # the window holds this token's projection
    _close(gh, wh, 1e-4)


def test_prefill_two_chunks_then_decode_matches_reference(model):
    """A 512-token prompt (two SSD chunks) through the whole model: logits, the conv
    windows and SSD states it leaves, then three greedy decode steps."""
    jc, tc, jp, tparams = model
    tokens = np.random.default_rng(3).integers(0, jc.vocab, (2, 512)).astype(np.int32)
    jstate = jm.init_state(jc, 2)
    tstate = tm.init_state(tc, 2, device="cpu")
    want, jstate = jax.jit(lambda p, t, st: jm.prefill(p, jc, t, st))(jp, jnp.asarray(tokens),
                                                                     jstate)
    got, tstate = tm.prefill(tparams, tc, torch.from_numpy(tokens), tstate)
    _close(got, want, 1e-4)
    # the cache-less forward's last position is the prefill's
    _close(tm.forward(tparams, tc, torch.from_numpy(tokens))[:, -1:], got, 1e-6)
    _close(tstate[0], jstate[0], 1e-4)
    _close(tstate[1], jstate[1], 1e-4)
    step = jax.jit(lambda p, t, st: jm.decode_step(p, jc, t, st))
    for _ in range(3):
        tok = np.asarray(want).argmax(-1).astype(np.int32)
        want, jstate = step(jp, jnp.asarray(tok), jstate)
        got, tstate = tm.decode_step(tparams, tc, torch.from_numpy(tok), tstate)
        _close(got, want, 1e-4)


def test_noncausal_flash_at_a_ragged_key_count():
    tp.check_noncausal_ragged_flash(4, b=1, h=4, kvh=2, sq=128, sk=72, hd=16, block_k=8)


def test_ssd_gradient_finite_where_the_decay_overflows():
    """One chunk of 256 positions whose decay spans more than e^88 (mamba2-780m's
    48 heads at its init reach it): the port's outputs equal the reference's,
    and its gradient is finite where the reference's, which masks ``exp(seg)``
    after the exponential overflows above the diagonal, is NaN."""
    rng = np.random.default_rng(5)
    b, s, nh, hd, st = 1, 256, 4, 8, 8
    xh = rng.normal(size=(b, s, nh, hd)).astype(np.float32)
    dt = np.full((b, s, nh), 0.1, np.float32)
    a = -np.arange(1, nh + 1, dtype=np.float32) * 12.0  # a decay of up to e^(4.8 * 255)
    bm, cm = (rng.normal(size=(b, s, st)).astype(np.float32) for _ in range(2))
    want, _ = jm._ssd_chunked(*map(jnp.asarray, (xh, dt, a, bm, cm)))
    args = [torch.from_numpy(v).requires_grad_(True) for v in (xh, dt, a, bm, cm)]
    got, _ = tm._ssd_chunked(*args)
    _close(got.detach(), want, 1e-4)
    got.sum().backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in args)
    jgrad = jax.grad(lambda d: jm._ssd_chunked(jnp.asarray(xh), d, *map(jnp.asarray, (a, bm, cm)))
                     [0].sum())(jnp.asarray(dt))
    assert not np.isfinite(np.asarray(jgrad)).all()

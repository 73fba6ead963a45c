"""The port's decoder LM (``models/transformer.py``) against the JAX package, on the CPU.

The same weights (a JAX key, carried across as numpy) and the same token
ids through both: the cache-less forward with its tap sites, ``prefill``,
and ``decode_step`` with a scalar position, a per-row ``[B]`` position and
``s > 1`` tokens per row, for each cache layout the port carries (dense,
dynamic int8 ``quant``, calibrated int8 ``static``). Prefill attention runs
through ``flash_attention``, here its plain version.

Tolerances, relative to max |logit|: 1e-4 for float32 activations and a
dense cache (matmuls and softmax sums in another order). The int8 caches
round keys and values to 127 levels; a value within float32 noise of a
rounding half-step lands on the neighbouring code in one package and not
the other, a change of one step (1/127 of the head's range) in one cached
element, so those layouts are held to 1e-3.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402

B, S, MAX_LEN = 2, 12, 20
TOL = {"dense": 1e-4, "quant": 1e-3, "static": 1e-3}


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
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def _caches(jc, layout):
    kw = {}
    if layout == "quant":
        kw["quant"] = True
    elif layout == "static":
        rng = np.random.default_rng(5)
        kw["kv_scales"] = tuple(rng.uniform(0.02, 0.04, (jc.n_layers, jc.n_kv_heads))
                                .astype(np.float32) for _ in range(2))
    return jtr.init_cache(jc, B, MAX_LEN, **kw), kw


@pytest.mark.parametrize("which,layout", [
    ("gqa", "dense"), ("gqa", "quant"), ("gqa", "static"),
    ("gqa_qknorm", "dense"), ("qwen3_8b_reduced", "dense"),
])
def test_prefill_and_decode_steps_match(which, layout):
    jc, tc = tp.lm_configs(which)
    jp, tparams = tp.lm_params(jc)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    steps = rng.integers(0, jc.vocab, (B, 6)).astype(np.int32)
    jcache, kw = _caches(jc, layout)
    tcache = ttr.init_cache(tc, B, MAX_LEN, device="cpu", **kw)
    assert ttr.cache_layout(tcache) == jtr.cache_layout(jcache) == layout
    jpre = jax.jit(lambda p, t, c: jtr.prefill(p, jc, t, c))
    jdec = jax.jit(lambda p, t, c, pos: jtr.decode_step(p, jc, t, c, pos))
    rel = TOL[layout]

    want, jcache = jpre(jp, jnp.asarray(toks), jcache)
    got, tcache = ttr.prefill(tparams, tc, torch.from_numpy(toks), tcache)
    assert tuple(got.shape) == (B, 1, jc.vocab) and got.dtype == torch.float32
    _close(got, want, rel)
    if layout == "dense":
        _close(tcache["k"][:, :, :S], np.asarray(jcache["k"])[:, :, :S], 1e-5)

    # (tokens, position): lockstep scalar, per-row vector, a run of 2 at a
    # scalar position (the prefill branch with an offset), a run of 2 at
    # per-row positions (the speculative verify shape)
    pos_vec = np.array([S + 1, S + 1], np.int32)
    cases = [(steps[:, :1], S), (steps[:, 1:2], pos_vec), (steps[:, 2:4], S + 2),
             (steps[:, 4:6], np.array([S + 4, S + 3], np.int32))]
    for tok, pos in cases:
        want, jcache = jdec(jp, jnp.asarray(tok), jcache, jnp.asarray(pos))
        tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        got, tcache = ttr.decode_step(tparams, tc, torch.from_numpy(tok), tcache, tpos)
        assert tuple(got.shape) == (B, tok.shape[1], jc.vocab)
        _close(got, want, rel)


def test_forward_taps_match():
    jc, tc = tp.lm_configs("gqa_qknorm")
    jp, tparams = tp.lm_params(jc)
    toks = np.random.default_rng(4).integers(0, jc.vocab, (2, 10)).astype(np.int32)
    jacts, tacts = {}, {}

    def jtap(name, x):
        jacts[name] = x
        return x

    def ttap(name, x):
        tacts[name] = x
        return x

    want = jtr.forward(jp, jc, jnp.asarray(toks), tap=jtap, tap_kv=True)
    got = ttr.forward(tparams, tc, torch.from_numpy(toks), tap=ttap, tap_kv=True)
    _close(got, want, 1e-4)
    assert set(tacts) == set(jacts) == {"embed", "blocks", "attn_in", "attn_mix", "ffn_in",
                                        "ffn_hidden", "final", "k_cache", "v_cache"}
    for name, act in jacts.items():
        assert tuple(tacts[name].shape) == act.shape, name
        _close(tacts[name], act, 1e-5)


def test_packed_prefill_and_decode_match():
    """Every block matmul on packed codes (the kernels' plain versions here)."""
    jc, tc = tp.lm_configs("qwen3_8b_reduced")
    jp, _ = tp.lm_params(jc)
    jq = tp.jax_pack_lm(jp, jc)
    from repro_torch.interop import params_from_numpy

    tq = params_from_numpy(tp.packed_to_numpy(jq), device="cpu")
    assert tq["blocks"]["w2"].n_layers == jc.n_layers
    toks = np.random.default_rng(6).integers(0, jc.vocab, (B, S)).astype(np.int32)
    jcache = jtr.init_cache(jc, B, MAX_LEN)
    tcache = ttr.init_cache(tc, B, MAX_LEN, device="cpu")
    want, jcache = jax.jit(lambda p, t, c: jtr.prefill(p, jc, t, c))(jq, jnp.asarray(toks), jcache)
    got, tcache = ttr.prefill(tq, tc, torch.from_numpy(toks), tcache)
    _close(got, want, 1e-4)
    tok = np.asarray(want).argmax(-1).astype(np.int32)
    want, _ = jax.jit(lambda p, t, c: jtr.decode_step(p, jc, t, c, S))(jq, jnp.asarray(tok), jcache)
    got, _ = ttr.decode_step(tq, tc, torch.from_numpy(tok), tcache, S)
    _close(got, want, 1e-4)


def test_model_api_and_unported_inputs():
    _, tc = tp.lm_configs("gqa")
    api = get_model(tc)
    params = api.init_params(tc, 0, device="cpu")
    assert params["blocks"]["wq"].shape == (2, 32, 32) and params["embed"].std() > 0
    cache = api.init_cache(tc, 1, 8, device="cpu")
    logits, cache = api.prefill(params, tc, {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                                cache)
    assert tuple(logits.shape) == (1, 1, tc.vocab)
    toks = torch.zeros(1, 4, dtype=torch.long)
    loss = api.loss_fn(params, tc, {"tokens": toks, "labels": toks})
    assert loss.ndim == 0 and bool(torch.isfinite(loss))
    # over a mesh whose model axis holds more than one rank every family is tensor
    # parallel (test_torch_tensor_parallel.py, test_torch_tp_recurrent.py), each
    # laying out its own cache: here model rank 1 of two, before any collective
    from repro_torch.models import mamba2
    from repro_torch.models.context import ParallelCtx

    pctx = ParallelCtx(mesh=tp.TwoRankMesh(1))
    assert tuple(api.tp_cache(cache, tc, pctx)["k"].shape) == (2, 1, 8, 1, tc.hd)
    sc = type(tc)(**{**tc.__dict__, "family": "ssm", "expand": 2, "ssm_head_dim": 8,
                     "ssm_state": 4})
    state = get_model(sc).init_cache(sc, 1, 8, device="cpu")
    conv, ssd = get_model(sc).tp_cache(state, sc, pctx)  # 8 SSD heads, 72 conv channels
    assert tuple(conv.shape) == (2, 1, 3, 36) and tuple(ssd.shape) == (2, 1, 4, 8, 4)
    assert mamba2.heads(sc, pctx) == (4, 8)
    assert get_model(type(tc)(**{**tc.__dict__, "family": "encdec"})).tp_cache is ttr.tp_cache
    with pytest.raises(ValueError, match="unknown model family"):
        get_model(type(tc)(**{**tc.__dict__, "family": "rnn"}))
    with pytest.raises(ValueError, match="get_model"):  # the ssm family has its own tree
        ttr.init_params(type(tc)(**{**tc.__dict__, "family": "ssm"}), 0, device="cpu")
    with pytest.raises(ValueError, match="exclusive"):
        api.init_cache(tc, 1, 8, quant=True, kv_scales=(np.ones((2, 2)),) * 2, device="cpu")

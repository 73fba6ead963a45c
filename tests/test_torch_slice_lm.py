"""The LM serving slice end to end on the CPU: ``api.quantize`` + ``generate`` in the port
against the JAX package's conversion and ``serve.static_generate``.

Both packages start from the same weights (a JAX key, carried across as
numpy) and the same calibration and prompt token ids. The JAX side is its
LM conversion (``calibrate_lm`` then ``pack_lm_params``, what its
``api.quantize`` runs for an ``ArchConfig``) under ``jax.jit``, and its
``static_generate``. With float activations the greedy tokens must be
identical. With static 8-bit activations the JAX package's tokens are
teacher-forced through both and the logits compared, relative to max
|logit|: float32 sums in another order can move a pre-activation across a
rounding half-step of the 8-bit quantizer, so they are held to 5e-2 (the
CNN slice's bound for the same effect); they are also reported when the
tokens agree. The int8 KV cache (``kv_scales``) is held to the same tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from repro.calib.runner import calibrate_kv_cache as jkv  # noqa: E402
from repro.calib.runner import calibrate_lm as jcal  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve.engine import ServeSetup as JSetup  # noqa: E402
from repro.serve.engine import static_generate as jgen  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.calib.runner import calibrate_kv_cache as tkv  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serve.engine import ServeSetup, static_generate  # noqa: E402

N_NEW = 8


def _setup(which):
    jc, tc = tp.lm_configs(which)
    jp, tparams = tp.lm_params(jc)
    rng = np.random.default_rng(2)
    calib = rng.integers(0, jc.vocab, (2, 4, 16)).astype(np.int32)
    prompts = rng.integers(0, jc.vocab, (3, 12)).astype(np.int32)
    return jc, tc, jp, tparams, calib, prompts


def _jax_generate(jc, jq, prompts, **kw):
    setup = JSetup(cfg=jc, mesh=None, max_len=prompts.shape[1] + N_NEW, batch=prompts.shape[0])
    return np.asarray(jgen(setup, jq, {"tokens": jnp.asarray(prompts)}, N_NEW, **kw))


@pytest.mark.parametrize("which", ["gqa", "qwen3_8b_reduced"])
def test_float_act_greedy_tokens_match_reference(which):
    jc, tc, jp, tparams, _, prompts = _setup(which)
    want = _jax_generate(jc, tp.jax_pack_lm(jp, jc), prompts)
    qm = api.quantize(tc, tparams, api.QuantScheme(fmt="elp4", act="float"), device="cpu")
    got = qm.generate(prompts, N_NEW)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, N_NEW)
    assert np.array_equal(got.numpy(), want)


def test_static_act_matches_reference_teacher_forced():
    jc, tc, jp, tparams, calib, prompts = _setup("gqa")
    jq = tp.jax_pack_lm(jp, jc, calib=jcal(jp, jc, jnp.asarray(calib), bits=8))
    want = _jax_generate(jc, jq, prompts)
    qm = api.quantize(tc, tparams, api.QuantScheme(fmt="elp4", act="static"),
                      calib_data=calib, device="cpu")
    assert qm.table is not None and qm.params["blocks"]["w2"].act_bits == 8
    got = qm.generate(prompts, N_NEW).numpy()
    # teacher-force the reference's tokens through both
    jc_ = jtr.init_cache(jc, 3, 12 + N_NEW)
    tc_ = ttr.init_cache(tc, 3, 12 + N_NEW, device="cpu")
    jl, jc_ = jax.jit(lambda p, t, c: jtr.prefill(p, jc, t, c))(jq, jnp.asarray(prompts), jc_)
    tl, tc_ = ttr.prefill(qm.params, tc, torch.from_numpy(prompts), tc_)
    rels = [float(np.abs(tl.numpy() - np.asarray(jl)).max() / np.abs(np.asarray(jl)).max())]
    jdec = jax.jit(lambda p, t, c, pos: jtr.decode_step(p, jc, t, c, pos))
    for i in range(N_NEW - 1):
        tok = want[:, i:i + 1]
        jl, jc_ = jdec(jq, jnp.asarray(tok), jc_, jnp.int32(12 + i))
        tl, tc_ = ttr.decode_step(qm.params, tc, torch.from_numpy(tok.copy()), tc_, 12 + i)
        rels.append(float(np.abs(tl.numpy() - np.asarray(jl)).max() / np.abs(np.asarray(jl)).max()))
    assert max(rels) <= 5e-2, rels
    assert np.array_equal(got, want), (got, want)


def test_int8_kv_cache_generation_matches_reference():
    """``kv_scales`` switches both packages to the dense static-int8 cache."""
    jc, tc, jp, tparams, calib, prompts = _setup("gqa")
    jq = tp.jax_pack_lm(jp, jc)
    jscales = jkv(jp, jc, jnp.asarray(calib))
    tscales = tkv(tparams, tc, torch.from_numpy(calib))
    np.testing.assert_allclose(tscales[0], jscales[0], rtol=1e-5)
    want = _jax_generate(jc, jq, prompts, kv_scales=jscales)
    qm = api.quantize(tc, tparams, api.QuantScheme(fmt="elp4"), device="cpu")
    setup = ServeSetup(cfg=tc, mesh=None, max_len=12 + N_NEW, batch=3, kv_bits=8)
    got = static_generate(setup, qm.params, {"tokens": torch.from_numpy(prompts)}, N_NEW,
                          kv_scales=tscales)
    assert np.array_equal(got.numpy(), want)


def test_report_and_front_door():
    jc, tc, jp, tparams, _, prompts = _setup("gqa")
    qm = api.quantize(tc, tparams, api.QuantScheme(fmt="elp4"), device="cpu")
    r = qm.report
    n_block = sum(int(np.prod(np.asarray(jp["blocks"][k]).shape))
                  for k in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"))
    # a4 nibble codes: half a byte per weight, plus one float32 sf per slice
    assert r.packed_weight_bytes == n_block // 2 + 7 * jc.n_layers * 4
    assert r.raw_bytes == sum(int(np.asarray(v).nbytes) for v in jax.tree.leaves(jp))
    assert r.energy_nj is None and r.compression > 1
    # forward: a fresh-cache prefill, the last position's logits
    logits = qm.forward(prompts)
    assert tuple(logits.shape) == (3, 1, jc.vocab)
    with pytest.raises(ValueError, match="CNN execution overrides"):
        qm.forward(prompts, impl="tiled")
    # sampling draws from the torch.Generator: reproducible for one seed
    a = qm.generate(prompts, 4, greedy=False, generator=torch.Generator().manual_seed(0))
    b = qm.generate(prompts, 4, greedy=False, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and int(a.max()) < jc.vocab
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        qm.serve([(prompts[0], 4)])
    with pytest.raises(ValueError, match="per_slice"):
        api.quantize(tc, tparams, api.QuantScheme(granularity="per_channel"), device="cpu")
    with pytest.raises(ValueError, match="dynamic"):
        api.quantize(tc, tparams, api.QuantScheme(act="dynamic"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeSetup(cfg=tc, mesh=object(), max_len=8, batch=1)


def test_lm_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = tp.lm_configs("gqa")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.init_params(tc, 0)
    params = ttr.init_params(tc, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.quantize(tc, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.init_cache(tc, 1, 8)

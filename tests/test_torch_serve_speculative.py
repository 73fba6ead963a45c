"""The port's speculative decoding against the JAX package's, on the CPU.

Both drafters (``"model"``: a second, a4 packed tier; ``"ngram"``: the
engine's verified-token history) must emit exactly what non-speculative
serving of the verify tier emits, and what the reference speculative
engine emits, with the same acceptance counts (they depend only on the
tokens). Also held: the W-wide verify forward against W single-token
steps, budget clamping, eviction mid-round, validation, and
``QuantScheme.speculative`` through ``api.quantize`` with its verify tier
saved and loaded across packages (``verify_params/``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from repro import api as japi  # noqa: E402
from repro.configs.base import ArchConfig as JCfg  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.configs.base import ArchConfig as TCfg  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    ServeEngine,
    ServeSetup,
    build_draft_run,
    build_verify_step,
)

KW = dict(name="spec-t", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
          d_ff=128, vocab=128, head_dim=16, dtype_str="float32")
JC, TC = JCfg(**KW), TCfg(**KW)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the test runner puts several workers on
    one host, where oversubscribed torch threads slow small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees():
    """(JAX float, port float, JAX a4 draft, port a4 draft) of the same weights."""
    jp = jtr.init_params(JC, jax.random.PRNGKey(0))
    jq = tp.jax_pack_lm(jp, JC)
    return (jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"), jq,
            params_from_numpy(tp.packed_to_numpy(jq), device="cpu"))


def _prompts(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TC.vocab, size=s).astype(np.int32) for s in sizes]


@pytest.fixture(scope="module")
def plain_out(trees):
    """Non-speculative serving of the float tier: the stream every drafter must reproduce."""
    reqs = list(zip(_prompts((8, 16, 8, 16, 8), seed=4), (9, 6, 12, 5, 7)))
    return reqs, ServeEngine(TC, trees[1], n_slots=2, max_len=32).serve(reqs)


# ---------------------------------------------------------------------------
# Model level
# ---------------------------------------------------------------------------
def test_wide_verify_matches_sequential_steps(trees):
    """One W-wide decode_step over per-row positions == W single-token steps."""
    tparams = trees[1]
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, TC.vocab, (2, 8)))
    run = torch.from_numpy(rng.integers(0, TC.vocab, (2, 4)))
    caches = [ttr.init_cache(TC, 2, 16, device="cpu") for _ in range(2)]
    for c in caches:
        ttr.prefill(tparams, TC, prompt, c)
    pos = torch.tensor([8, 8])
    wide, _ = ttr.decode_step(tparams, TC, run, caches[0], pos)
    for j in range(4):
        step, _ = ttr.decode_step(tparams, TC, run[:, j:j + 1], caches[1], pos + j)
        torch.testing.assert_close(wide[:, j:j + 1], step, rtol=1e-5, atol=1e-5)


def test_verify_and_draft_steps(trees):
    tparams = trees[1]
    setup = ServeSetup(cfg=TC, mesh=None, max_len=16, batch=2)
    prompt = torch.from_numpy(np.random.default_rng(2).integers(0, TC.vocab, (2, 6)))
    cache = ttr.init_cache(TC, 2, 16, device="cpu")
    logits, _ = ttr.prefill(tparams, TC, prompt, cache)
    first = logits.argmax(-1).to(torch.int32)
    dcache = ttr.init_cache(TC, 2, 16, device="cpu")
    ttr.prefill(tparams, TC, prompt, dcache)
    pos = torch.tensor([6, 6])
    run, _ = build_draft_run(setup)(tparams, first, dcache, pos, 4)
    assert tuple(run.shape) == (2, 4) and torch.equal(run[:, :1], first)
    vtok, acc, ptok, _ = build_verify_step(setup)(tparams, run, cache, pos)
    # the draft tier is the verify tier here: every draft is accepted
    assert acc.tolist() == [4, 4] and torch.equal(vtok[:, :3], run[:, 1:])
    assert torch.equal(ptok[:, 0], vtok[:, 3])


# ---------------------------------------------------------------------------
# Engine parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("drafter,spec_k,cache", [("model", 3, "dense"), ("model", 4, "paged"),
                                                  ("ngram", 4, "dense"), ("ngram", 3, "paged")])
def test_speculative_engine_matches_plain_and_reference(trees, plain_out, drafter, spec_k,
                                                        cache):
    jp, tparams, jq, tq = trees
    reqs, want = plain_out
    kw = dict(n_slots=2, max_len=32, spec_k=spec_k, spec_draft=drafter, kv_cache=cache,
              page_size=8)
    teng = ServeEngine(TC, tparams, draft_params=tq if drafter == "model" else None, **kw)
    jeng = JEngine(JC, jp, mesh=None, draft_params=jq if drafter == "model" else None, **kw)
    got, jgot = teng.serve(reqs), jeng.serve(reqs)
    for g, w, j in zip(got, want, jgot):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, j)
    ts, js = teng.stats(), jeng.stats()
    assert ts["speculative"] == js["speculative"]
    assert ts["decode_steps"] == js["decode_steps"] and ts["cache"] == js["cache"]
    assert ts["speculative"]["rounds"] > 0


def test_draft_crossing_budget_truncates_and_eviction_mid_round(trees):
    tparams, tq = trees[1], trees[3]
    prompts = _prompts((8, 8), seed=9)
    eng = ServeEngine(TC, tparams, n_slots=2, max_len=32, spec_k=4, draft_params=tq)
    outs = eng.serve([(prompts[0], 2), (prompts[1], 3)])
    assert [o.size for o in outs] == [2, 3]
    ref = ServeEngine(TC, tparams, n_slots=1, max_len=32).serve([(prompts[1], 6)])[0]
    rid = eng.submit(prompts[0], 20)
    eng.step()
    eng.step()
    partial = eng.evict(rid)
    assert 0 < partial.size < 20
    rid2 = eng.submit(prompts[1], 6)
    eng.run()
    np.testing.assert_array_equal(eng.result(rid2), ref)


def test_ctor_validation_and_sampled_rejected(trees):
    tparams, tq = trees[1], trees[3]
    with pytest.raises(ValueError, match="spec_k"):
        ServeEngine(TC, tparams, draft_params=tq)
    with pytest.raises(ValueError, match=">= 2"):
        ServeEngine(TC, tparams, spec_k=1, draft_params=tq)
    with pytest.raises(ValueError, match="draft_params"):
        ServeEngine(TC, tparams, spec_k=3)
    with pytest.raises(ValueError, match="ngram"):
        ServeEngine(TC, tparams, spec_k=3, spec_draft="ngram", draft_params=tq)
    with pytest.raises(ValueError, match="spec_draft"):
        ServeEngine(TC, tparams, spec_k=3, spec_draft="nope")
    eng = ServeEngine(TC, tparams, spec_k=3, spec_draft="ngram")
    with pytest.raises(ValueError, match="greedy-only"):
        eng.submit(_prompts((4,))[0], 2, key=torch.Generator())


# ---------------------------------------------------------------------------
# QuantScheme.speculative through api.quantize, and the artifact
# ---------------------------------------------------------------------------
def test_scheme_json_roundtrip():
    for drafter in ("model", "ngram"):
        s = api.QuantScheme.speculative(draft="elp4", K=6, drafter=drafter)
        s2 = api.QuantScheme.from_json(s.to_json())
        assert s2 == s and s2.spec_k == 6 and s2.spec_draft == drafter
        assert s.to_json() == japi.QuantScheme.speculative(draft="elp4", K=6,
                                                           drafter=drafter).to_json()
    with pytest.raises(ValueError, match="BOTH"):
        api.QuantScheme(fmt="elp4", spec_k=4)


@pytest.mark.parametrize("verify", ["float", "elp_bsd_b7"])
def test_speculative_quantize_generate_and_serve(trees, plain_out, verify):
    tparams = trees[1]
    reqs, want = plain_out
    qm = api.quantize(TC, tparams, api.QuantScheme.speculative(draft="elp4", K=4, verify=verify),
                      device="cpu")
    assert qm.verify_params is not None
    if verify == "float":
        assert qm.verify_params["blocks"]["wq"] is tparams["blocks"]["wq"]
        for g, w in zip(qm.serve(reqs, n_slots=2, max_len=32), want):
            np.testing.assert_array_equal(g, w)
    plain = api.quantize(TC, tparams, api.QuantScheme(fmt=verify), device="cpu") \
        if verify != "float" else None
    prompts = np.stack(_prompts((8, 8), seed=23))
    got = qm.generate(prompts, 6)
    verify_tree = tparams if plain is None else plain.params
    ref = ServeEngine(TC, verify_tree, n_slots=2, max_len=14).serve([(p, 6) for p in prompts])
    np.testing.assert_array_equal(got.numpy(), np.stack(ref))


def test_speculative_artifacts_cross_packages(trees, tmp_path):
    """A JAX-saved speculative artifact loads in the port and serves the same
    tokens, and the port's loads in the JAX package, both tiers bit-identical."""
    jp, tparams = trees[0], trees[1]
    scheme = dict(draft="elp4", K=4)
    jq = japi.quantize(JC, jp, japi.QuantScheme.speculative(**scheme))
    jq.save(str(tmp_path / "jax"))
    got = api.load(str(tmp_path / "jax"), device="cpu")
    assert got.scheme.spec_k == 4 and got.verify_params is not None
    np.testing.assert_array_equal(got.verify_params["blocks"]["w1"].numpy(),
                                  np.asarray(jq.verify_params["blocks"]["w1"]))
    np.testing.assert_array_equal(got.params["blocks"]["w1"].codes.numpy(),
                                  np.asarray(jq.params["blocks"]["w1"].codes))
    prompts = np.stack(_prompts((8, 8), seed=23))
    want_tokens = np.asarray(jq.generate({"tokens": jnp.asarray(prompts)}, max_new_tokens=5))
    np.testing.assert_array_equal(got.generate(prompts, 5).numpy(), want_tokens)

    tq = api.quantize(TC, tparams, api.QuantScheme.speculative(**scheme), device="cpu")
    tq.save(str(tmp_path / "torch"))
    back = japi.load(str(tmp_path / "torch"))
    assert back.scheme == japi.QuantScheme.speculative(**scheme)
    np.testing.assert_array_equal(np.asarray(back.verify_params["blocks"]["wq"]),
                                  tparams["blocks"]["wq"].numpy())
    np.testing.assert_array_equal(np.asarray(back.params["blocks"]["wq"].codes),
                                  tq.params["blocks"]["wq"].codes.numpy())
    again = api.load(str(tmp_path / "torch"), device="cpu")
    np.testing.assert_array_equal(again.generate(prompts, 5).numpy(), want_tokens)

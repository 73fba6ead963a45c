"""Every config the port registers, against the JAX package, on the CPU.

Each config runs at ``reduced()`` (float32, 2 layers, d_model 64; for an
MoE config 8 experts, top-2; for internvl2 8 frontend embeddings; for
seamless a frame embedding per token, as the JAX package's data pipeline
gives an enc-dec batch; mamba2 and recurrentgemma at their reduced state
and window) with the same weights in both packages (a JAX key, carried
across as numpy) and the same numpy inputs:

  * prefill and decode-step logits through each package's ``get_model``
    (1e-4 of max |logit|: float32 sums in another order, as the dense
    LM's parity tests hold them), with a frontend batch for ``vlm`` and
    ``audio``;
  * ``param_count`` and ``active_param_count`` of the full configs, equal;
  * greedy ``static_generate`` tokens identical for reduced olmoe, kimi,
    internvl2 (with a frontend), mamba2, recurrentgemma and seamless (with
    frames), float and a4-packed; for the last three also
    ``QuantizedModel.generate`` (a4 codes, float activations, the only
    scheme the reference serves them with: ``act="static"`` and
    ``act="dynamic"`` are refused in both packages);
  * the port's ``ServeEngine`` tokens identical to the JAX engine's for
    reduced olmoe, on the dense cache and on the paged static-int8 one;
  * ``lm_token_energy`` equal (float and packed trees);
  * ``api.quantize`` with static activations: the same tap sites and the
    same scales stamped on every packed leaf (the MoE expert stacks take
    ``ffn_in`` for ``we1``/``we3`` and nothing for ``we2``, as in the
    reference), ``QuantizedModel.generate`` tokens identical, and zero
    runtime range reductions in the static MoE decode step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from repro import api as japi  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.engine import ServeSetup as JSetup  # noqa: E402
from repro.serve.engine import static_generate as jstatic  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels.ops import PackedWeight, tree_leaves  # noqa: E402
from repro_torch.models import get_model as tget_model  # noqa: E402
from repro_torch.serve.engine import ServeEngine, ServeSetup, static_generate  # noqa: E402

B, S, N_NEW = 2, 12, 5
REL = 1e-4
GENERATED = ("olmoe_1b_7b", "kimi_k2_1t_a32b", "internvl2_26b", "mamba2_780m",
             "recurrentgemma_2b", "seamless_m4t_large_v2")
RECURRENT_ENCDEC = ("mamba2_780m", "recurrentgemma_2b", "seamless_m4t_large_v2")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the test runner puts several workers on
    one host, where oversubscribed torch threads slow small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


@pytest.fixture(scope="module")
def trees():
    """Per arch: (JAX cfg, port cfg, JAX float, port float, JAX a4, port a4), built once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jc, tc = jget(arch).reduced(), tget(arch).reduced()
            jp, tparams = tp.lm_params(jc)
            jq = tp.jax_pack_lm(jp, jc)
            cache[arch] = (jc, tc, jp, tparams, jq,
                           params_from_numpy(tp.packed_to_numpy(jq), device="cpu"))
        return cache[arch]

    return get


def _batch(cfg, seed=0, b=B, s=S):
    """Numpy token ids and, for a frontend config, patch embeddings (an enc-dec
    config: one frame embedding a token, as ``repro.data.pipeline`` gives them)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family in ("encdec", "audio"):
        batch["frontend"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    elif cfg.frontend_tokens:
        batch["frontend"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _prompt_len(cfg, batch):
    """Cache positions a prompt fills: only a ``vlm`` frontend sits in the decoder's cache."""
    return batch["tokens"].shape[1] + (batch["frontend"].shape[1] if cfg.family == "vlm" else 0)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_logits_match_reference(trees, arch):
    jc, tc, jp, tparams, _, _ = trees(arch)
    batch = _batch(jc)
    n = _prompt_len(jc, batch)
    japi_, tapi_ = jget_model(jc), tget_model(tc)
    jcache = japi_.init_cache(jc, B, n + 4)
    tcache = tapi_.init_cache(tc, B, n + 4, device="cpu")
    want, jcache = jax.jit(lambda p, bt, c: japi_.prefill(p, jc, bt, c))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcache)
    got, tcache = tapi_.prefill(tparams, tc, {k: torch.from_numpy(v) for k, v in batch.items()},
                                tcache)
    assert tuple(got.shape) == (B, 1, tc.vocab)
    _close(got, want)
    tok = np.asarray(want).argmax(-1).astype(np.int32)
    want, _ = jax.jit(lambda p, t, c: japi_.decode_step(p, jc, t, c, jnp.int32(n)))(
        jp, jnp.asarray(tok), jcache)
    got, _ = tapi_.decode_step(tparams, tc, torch.from_numpy(tok), tcache, n)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_reference(arch):
    for jc, tc in ((jget(arch), tget(arch)), (jget(arch).reduced(), tget(arch).reduced())):
        assert tc == type(tc)(**dataclasses.asdict(jc))  # field for field
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()


@pytest.mark.parametrize("packed", [False, True], ids=["float", "a4"])
@pytest.mark.parametrize("arch", GENERATED)
def test_greedy_static_generate_matches_reference(trees, arch, packed):
    jc, tc, jp, tparams, jq, tq = trees(arch)
    if packed:
        jp, tparams = jq, tq
    batch = _batch(jc, seed=1)
    max_len = _prompt_len(jc, batch) + N_NEW
    want = jstatic(JSetup(cfg=jc, mesh=None, max_len=max_len, batch=B), jp,
                   {k: jnp.asarray(v) for k, v in batch.items()}, N_NEW)
    got = static_generate(ServeSetup(cfg=tc, mesh=None, max_len=max_len, batch=B), tparams,
                          {k: torch.from_numpy(v) for k, v in batch.items()}, N_NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", RECURRENT_ENCDEC)
def test_quantized_generate_matches_reference_and_refuses_act_quant(trees, arch):
    """``api.quantize`` (a4 codes, float activations) then ``QuantizedModel.generate``
    (through ``batch_generate``, which takes ``static_generate`` for these
    families): the same tokens as the JAX package's. Static and dynamic
    activations are refused where the reference refuses them."""
    jc, tc, jp, tparams, _, _ = trees(arch)
    kw = dict(fmt="elp_bsd_a4", act="float")
    jq = japi.quantize(jc, jp, japi.QuantScheme(**kw))
    tq = tapi.quantize(tc, tparams, tapi.QuantScheme(**kw), device="cpu")
    batch = _batch(jc, seed=6)
    want = jq.generate({k: jnp.asarray(v) for k, v in batch.items()}, N_NEW)
    got = tq.generate(batch, N_NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tq.adapter.forward(tq.params, batch).shape == (B, 1, tc.vocab)
    calib = np.zeros((1, 2, 8), np.int32)
    for quant, scheme, err in ((japi.quantize, japi.QuantScheme, NotImplementedError),
                               (tapi.quantize, tapi.QuantScheme, NotImplementedError)):
        params = jp if quant is japi.quantize else tparams
        extra = {} if quant is japi.quantize else {"device": "cpu"}
        with pytest.raises(err, match="tap contract"):
            quant(jc if quant is japi.quantize else tc, params, scheme(act="static"),
                  calib_data=calib, **extra)
        with pytest.raises(ValueError, match="dynamic"):
            quant(jc if quant is japi.quantize else tc, params, scheme(act="dynamic"), **extra)
    with pytest.raises(NotImplementedError, match="activation taps"):
        tq.adapter.tapped_forward(tq.params)


@pytest.mark.parametrize("layout", ["dense", "paged_int8"])
def test_engine_tokens_match_reference_engine_olmoe(trees, layout):
    """Mixed prompt lengths, arrivals mid-flight, fewer slots than requests,
    a4 packed experts: the port's engine gives the JAX engine's tokens."""
    jc, tc, jp, _, jq, tq = trees("olmoe_1b_7b")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jc.vocab, s).astype(np.int32) for s in (8, 20, 8, 20)]
    max_new = (7, 5, 4, 6)
    kw = dict(n_slots=2, max_len=32)
    if layout == "paged_int8":
        from repro.calib import calibrate_kv_cache

        calib = jnp.asarray(rng.integers(0, jc.vocab, (2, 2, 16)).astype(np.int32))
        kw.update(kv_cache="paged", page_size=8, kv_scales=calibrate_kv_cache(jp, jc, calib))
    outs = {}
    for name, eng in (("jax", JEngine(jc, jq, mesh=None, **kw)),
                      ("torch", ServeEngine(tc, tq, **kw))):
        r0 = eng.submit(prompts[0], max_new[0])
        r1 = eng.submit(prompts[1], max_new[1])
        for _ in range(3):
            eng.step()
        rest = [eng.submit(p, n) for p, n in zip(prompts[2:], max_new[2:])]
        eng.run()
        outs[name] = [eng.result(r) for r in (r0, r1, *rest)]
    for a, b in zip(outs["jax"], outs["torch"]):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_token_energy_matches_reference(trees, arch):
    from repro.core.energy import lm_token_energy as jenergy
    from repro_torch.core.energy import lm_token_energy as tenergy

    jc, tc, jp, tparams, jq, tq = trees(arch)
    for a, b in ((jp, tparams), (jq, tq)):
        want, got = jenergy(jc, a, act_bits=8), tenergy(tc, b, act_bits=8)
        assert got["fmt"] == want["fmt"] and got["macs_per_token"] == want["macs_per_token"]
        for key in ("compute_nj", "memory_nj", "total_nj"):
            assert got[key] == pytest.approx(float(want[key]), rel=1e-12)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "internvl2_26b"])
def test_static_quantize_stamps_and_generate_match_reference(trees, arch):
    jc, tc, jp, tparams, _, _ = trees(arch)
    rng = np.random.default_rng(3)
    calib = rng.integers(0, jc.vocab, (2, 2, 16)).astype(np.int32)
    kw = dict(fmt="elp_bsd_a4", act="static", act_bits=8)
    jq = japi.quantize(jc, jp, japi.QuantScheme(**kw), calib_data=jnp.asarray(calib))
    tq = tapi.quantize(tc, tparams, tapi.QuantScheme(**kw), calib_data=calib, device="cpu")
    jsites = dict(jq.table.sites)
    tsites = dict(tq.table.sites)
    assert sorted(tsites) == sorted(jsites)
    if jc.is_moe:
        assert "ffn_hidden" not in tsites
    for name, s in tsites.items():
        assert s.amax == pytest.approx(float(jsites[name].amax), rel=1e-4), name
    jleaves = {k: v for k, v in jq.params["blocks"].items() if hasattr(v, "codes")}
    tleaves = {k: v for k, v in tq.params["blocks"].items() if isinstance(v, PackedWeight)}
    assert sorted(tleaves) == sorted(jleaves)
    for name, leaf in tleaves.items():
        want = jleaves[name].act_scale
        assert (leaf.act_scale is None) == (want is None), name
        if want is not None:
            assert leaf.act_scale == pytest.approx(float(want), rel=1e-4), name
        assert np.array_equal(leaf.codes.numpy(), np.asarray(jleaves[name].codes)), name
    if jc.is_moe:
        assert tleaves["we1"].act_scale is not None and tleaves["we2"].act_scale is None
    batch = _batch(jc, seed=4)
    want = jq.generate({k: jnp.asarray(v) for k, v in batch.items()}, N_NEW)
    got = tq.generate(batch, N_NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if jc.is_moe:  # token-only prompts serve through the engine, as generate does
        served = tq.serve([(t, N_NEW) for t in batch["tokens"]], n_slots=2)
        np.testing.assert_array_equal(np.stack(served), got.numpy())


def test_static_moe_decode_step_counts_no_range_reductions(trees):
    """Static 8-bit activations and the static int8 cache on the MoE decode step:
    no runtime range reduction (the router's sort and softmax are none)."""
    from repro_torch.calib.runner import calibrate_kv_cache, count_range_reductions
    from repro_torch.models import transformer as ttr

    _, tc, _, tparams, _, _ = trees("olmoe_1b_7b")
    rng = np.random.default_rng(5)
    calib = torch.from_numpy(rng.integers(0, tc.vocab, (2, 2, 16)))
    qm = tapi.quantize(tc, tparams, tapi.QuantScheme(fmt="elp4", act="static"),
                       calib_data=calib, device="cpu")
    scales = calibrate_kv_cache(tparams, tc, calib)
    cache = ttr.init_cache(tc, 2, 16, kv_scales=scales, device="cpu")
    tok = torch.from_numpy(rng.integers(0, tc.vocab, (2, 1)))
    assert count_range_reductions(
        lambda: ttr.decode_step(qm.params, tc, tok, cache, torch.tensor([3, 5]))) == 0
    dynamic = ttr.init_cache(tc, 2, 16, quant=True, device="cpu")
    assert count_range_reductions(
        lambda: ttr.decode_step(qm.params, tc, tok, dynamic, 4)) == 2 * tc.n_layers


def test_engine_rejects_frontend_requests_and_packs_experts(trees):
    _, tc, _, _, _, tq = trees("internvl2_26b")
    with pytest.raises(ValueError, match="token-only"):
        ServeEngine(tc, tq)
    with pytest.raises(ValueError, match="moe_impl"):
        ServeSetup(cfg=tc, mesh=None, max_len=8, batch=1, moe_impl="tp")
    _, oc, _, _, _, oq = trees("olmoe_1b_7b")
    experts = [leaf for leaf in tree_leaves(oq["blocks"]) if isinstance(leaf, PackedWeight)
               and leaf.codes.ndim == 4]
    assert len(experts) == 3
    assert all(tuple(leaf.sf.shape) == (oc.n_layers, oc.n_experts, 1, 1) for leaf in experts)
    assert not isinstance(oq["blocks"]["router"], PackedWeight)
    dispatch = ServeEngine(oc, oq, n_slots=2, max_len=16).kernel_dispatch()
    assert {v["impl"] for v in dispatch.values()} == {"fused_decode_matmul/plain",
                                                      "moe_dense/dequantize"}

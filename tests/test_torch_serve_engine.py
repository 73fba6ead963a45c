"""The port's continuous-batching ``ServeEngine`` against the JAX package's, on the CPU.

Both packages start from the same weights (the reference tests'
``engine-t`` config, a JAX key, carried across as numpy; float and a4
packed) and serve the same requests: greedy tokens must be identical to
the reference ``ServeEngine`` and to the port's own ``static_generate``,
one request at a time. Also held: the slot scheduler, slot reuse after
finish and eviction, capacity checks, ``QuantizedModel.generate`` routed
through ``batch_generate``, the deprecated ``runtime.serve_loop`` shim,
the engine's stats, and the zero range-reduction contract
(``calib.runner.count_range_reductions``) on the static-calibrated CNN
forward and LM decode step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_parity as tp  # noqa: E402
from repro.configs.base import ArchConfig as JCfg  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.configs.base import ArchConfig as TCfg  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels.ops import PackedWeight  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    ServeEngine,
    ServeSetup,
    batch_generate,
    build_serve_fns,
    static_generate,
)
from repro_torch.serve.scheduler import Request, SlotScheduler  # noqa: E402

KW = dict(name="engine-t", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
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
    """(JAX float, port float, JAX a4 packed, port a4 packed) trees of the same weights."""
    jp = jtr.init_params(JC, jax.random.PRNGKey(0))
    jq = tp.jax_pack_lm(jp, JC)
    return (jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"), jq,
            params_from_numpy(tp.packed_to_numpy(jq), device="cpu"))


def _prompts(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TC.vocab, size=s).astype(np.int32) for s in sizes]


def _static_ref(p, prompt, max_new):
    setup = ServeSetup(cfg=TC, mesh=None, max_len=prompt.size + max_new, batch=1)
    return static_generate(setup, p, {"tokens": torch.from_numpy(prompt[None])},
                           max_new)[0].numpy()


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------
def _req(i):
    return Request(rid=i, prompt=np.zeros(1, np.int32), max_new_tokens=1)


def test_scheduler_fifo_lowest_slot_first():
    s = SlotScheduler(2)
    for i in range(3):
        s.submit(_req(i))
    assert [(slot, r.rid) for slot, r in s.ready()] == [(0, 0), (1, 1)]
    assert s.queued == 1 and s.busy


def test_scheduler_finish_makes_slot_immediately_reusable():
    s = SlotScheduler(1)
    a, b = _req(0), _req(1)
    s.submit(a), s.submit(b)
    assert [r.rid for _, r in s.ready()] == [0]
    assert list(s.ready()) == []
    s.finish(0)
    assert a.done and [(sl, r.rid) for sl, r in s.ready()] == [(0, 1)]


def test_scheduler_cancel_queued_and_validation():
    s = SlotScheduler(1)
    a, b = _req(0), _req(1)
    s.submit(a), s.submit(b)
    list(s.ready())
    s.cancel(b)
    assert b.done and s.queued == 0
    with pytest.raises(ValueError, match="at least one slot"):
        SlotScheduler(0)


def test_request_resolves_lazy_device_entries_once():
    r = Request(rid=0, prompt=np.zeros(2, np.int32), max_new_tokens=5)
    vec = torch.tensor([[7], [9]], dtype=torch.int32)
    r.out.extend([3, (vec, 1), (vec, 0)])
    assert r.advance(torch.tensor([[1, 2], [4, 5]]), 1, 2, 5) == 2  # clamped to remaining
    assert r.tokens().tolist() == [3, 9, 7, 4, 5] and r.remaining == 0


# ---------------------------------------------------------------------------
# Token parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("packed", [False, True], ids=["float", "a4"])
def test_continuous_matches_reference_engine_and_static(trees, packed):
    """Mixed lengths, arrivals mid-flight, fewer slots than requests: every
    request's tokens equal the reference engine's and the port's static
    generation of that request alone."""
    jp, tparams = (trees[2], trees[3]) if packed else (trees[0], trees[1])
    prompts = _prompts((8, 20, 8, 20))
    max_new = (7, 5, 4, 6)
    outs = {}
    for name, eng in (("jax", JEngine(JC, jp, n_slots=2, max_len=32, mesh=None)),
                      ("torch", ServeEngine(TC, tparams, n_slots=2, max_len=32))):
        r0 = eng.submit(prompts[0], max_new[0])
        r1 = eng.submit(prompts[1], max_new[1])
        for _ in range(3):
            eng.step()
        r2 = eng.submit(prompts[2], max_new[2])
        r3 = eng.submit(prompts[3], max_new[3])
        eng.run()
        outs[name] = [eng.result(r) for r in (r0, r1, r2, r3)]
        st = eng.stats()
        outs[name + "_steps"] = (st["decode_steps"], st["prefills"], st["tokens_generated"])
    for p, n, a, b in zip(prompts, max_new, outs["jax"], outs["torch"]):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, _static_ref(tparams, p, n))
    assert outs["torch_steps"] == outs["jax_steps"]


def test_serve_trace_with_arrivals(trees):
    _, tparams = trees[0], trees[1]
    prompts = _prompts((8, 20, 8))
    eng = ServeEngine(TC, tparams, n_slots=2, max_len=32)
    outs = eng.serve(list(zip(prompts, (6, 4, 5))), arrivals=[0, 0, 4])
    for got, (p, n) in zip(outs, zip(prompts, (6, 4, 5))):
        np.testing.assert_array_equal(got, _static_ref(tparams, p, n))
    again = eng.serve(list(zip(prompts, (6, 4, 5))), arrivals=[0, 0, 4])
    for a, b in zip(outs, again):
        np.testing.assert_array_equal(a, b)
    assert not eng._requests
    with pytest.raises(ValueError, match="entries for"):
        eng.serve([(prompts[0], 2)], arrivals=[0, 1])


def test_slot_reuse_after_finish_and_evict_is_clean(trees):
    tparams = trees[1]
    prompts = _prompts((20, 8), seed=3)
    want = ServeEngine(TC, tparams, n_slots=1, max_len=48).serve([(prompts[1], 7)])[0]
    outs = ServeEngine(TC, tparams, n_slots=1, max_len=48).serve(
        [(prompts[0], 9), (prompts[1], 7)])
    np.testing.assert_array_equal(outs[1], want)
    eng = ServeEngine(TC, tparams, n_slots=1, max_len=48)
    rid = eng.submit(prompts[0], 25)
    for _ in range(4):
        eng.step()
    partial = eng.evict(rid)
    assert 0 < partial.size < 25 and eng._requests[rid].truncated
    rid2 = eng.submit(prompts[1], 7)
    eng.run()
    np.testing.assert_array_equal(eng.result(rid2), want)


def test_capacity_overflow_rejected_at_submit(trees):
    eng = ServeEngine(TC, trees[1], n_slots=1, max_len=16)
    with pytest.raises(ValueError, match="per-slot capacity"):
        eng.submit(_prompts((12,))[0], 50)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(np.zeros(0, np.int32), 1)
    (out,) = eng.serve([(_prompts((12,))[0], 4)])
    assert out.size == 4 and eng.stats()["requests_truncated"] == 0


def test_packed_engine_serves_codes(trees):
    tq = trees[3]
    eng = ServeEngine(TC, tq, n_slots=2, max_len=32)
    leaves = [leaf for leaf in eng.params["blocks"].values() if isinstance(leaf, PackedWeight)]
    assert len(leaves) == 7 and all(leaf.codes.dtype == torch.uint8 for leaf in leaves)
    disp = eng.kernel_dispatch()
    assert sum(v["count"] for v in disp.values()) == 7
    assert all(k.startswith("2x") and v["impl"] == "fused_decode_matmul/plain"
               for k, v in disp.items())
    cost = eng.decode_cost()
    assert cost["flops"] > 0 and cost["bytes_accessed"] > 0 and cost["collective_bytes"] == 0


def test_stats_keys_match_reference(trees):
    jp, tparams = trees[0], trees[1]
    reqs = [(p, 3) for p in _prompts((8, 8))]
    jeng = JEngine(JC, jp, n_slots=2, max_len=16, mesh=None)
    teng = ServeEngine(TC, tparams, n_slots=2, max_len=16)
    jeng.serve(reqs), teng.serve(reqs)
    js, ts = jeng.stats(), teng.stats()
    assert sorted(ts) == sorted(js)
    assert ts["cache"] == js["cache"] and ts["mesh"] is None
    for key in ("steps", "decode_steps", "prefills", "tokens_generated", "requests_completed"):
        assert ts[key] == js[key], key
    assert ts["energy_nj_per_token"] == pytest.approx(js["energy_nj_per_token"], rel=1e-12)
    assert sorted(ts["straggler"]) == sorted(js["straggler"])
    assert ts["straggler"]["steps"] == js["straggler"]["steps"]


# ---------------------------------------------------------------------------
# Front doors
# ---------------------------------------------------------------------------
def test_generate_routes_through_the_engine(trees):
    jp, tparams = trees[0], trees[1]
    prompts = np.stack(_prompts((8, 8, 8), seed=6))
    qm = api.quantize(TC, tparams, api.QuantScheme(fmt="elp4"), device="cpu")
    got = qm.generate(prompts, 5)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 5)
    setup = ServeSetup(cfg=TC, mesh=None, max_len=13, batch=3)
    want = static_generate(setup, qm.params, {"tokens": torch.from_numpy(prompts)}, 5)
    assert torch.equal(got, want)
    assert torch.equal(batch_generate(TC, qm.params, {"tokens": torch.from_numpy(prompts)}, 5),
                       want)
    served = qm.serve([(p, 5) for p in prompts], n_slots=2)
    assert all(np.array_equal(s, w) for s, w in zip(served, want.numpy()))
    with pytest.raises(ValueError, match="static loop"):
        batch_generate(TC, qm.params, {"tokens": torch.from_numpy(prompts)}, 5, greedy=False,
                       generator=torch.Generator().manual_seed(0), spec_k=2)


def test_serve_loop_shim_warns_and_matches(trees):
    from repro_torch.runtime import serve_loop

    tparams = trees[1]
    prompts = torch.from_numpy(np.stack(_prompts((8, 8), seed=2)))
    setup = ServeSetup(cfg=TC, mesh=None, max_len=14, batch=2)
    with pytest.warns(DeprecationWarning, match="serve_loop.generate"):
        got = serve_loop.generate(setup, tparams, {"tokens": prompts}, 6)
    assert torch.equal(got, static_generate(setup, tparams, {"tokens": prompts}, 6))
    with pytest.warns(DeprecationWarning, match="make_serve_fns"):
        prefill, decode = serve_loop.make_serve_fns(setup)
    ref_prefill, _ = build_serve_fns(setup)
    cache = ttr_cache(setup)
    a, _ = prefill(tparams, {"tokens": prompts}, cache)
    b, _ = ref_prefill(tparams, {"tokens": prompts}, ttr_cache(setup))
    assert torch.equal(a, b)
    # sampled calls keep the static loop's whole-batch stream
    with pytest.warns(DeprecationWarning):
        drawn = serve_loop.generate(setup, tparams, {"tokens": prompts}, 4, greedy=False,
                                    generator=torch.Generator().manual_seed(1))
    assert torch.equal(drawn, static_generate(setup, tparams, {"tokens": prompts}, 4,
                                              greedy=False,
                                              generator=torch.Generator().manual_seed(1)))


def ttr_cache(setup):
    from repro_torch.models import transformer as ttr

    return ttr.init_cache(setup.cfg, setup.batch, setup.max_len, device="cpu")


def test_setup_and_engine_reject_unported_options(trees):
    from repro_torch.models.moe import moe_apply

    from repro_torch.models.context import ParallelCtx

    tparams = trees[1]
    # the lockstep loop and the engine serve over more than one rank, the recurrent
    # and enc-dec families' lockstep loop on a model axis of more than one too
    # (test_torch_tp_recurrent.py); flash-decode runs there; without a mesh it has
    # nothing to shard (no context), as in the JAX package
    assert ServeSetup(cfg=TCfg(**{**KW, "family": "hybrid"}), mesh=tp.TwoRankMesh(), max_len=8,
                      batch=1).pctx().model_size == 2
    pctx = ServeSetup(cfg=TC, mesh=tp.TwoRankMesh(), max_len=8, batch=1,
                      flash_decode=True).pctx()
    assert pctx.flash_decode and pctx.model_size == 2
    assert ServeSetup(cfg=TC, mesh=None, max_len=8, batch=1, flash_decode=True).pctx() is None
    # MoE models serve (the dense form without a mesh); over a mesh the experts
    # must be the rank's shard of them
    with pytest.raises(ValueError, match="this rank's shard"):
        moe_apply({"router": torch.zeros(TC.d_model, 4), "we1": torch.zeros(4, 1, 1),
                   "we3": torch.zeros(4, 1, 1), "we2": torch.zeros(4, 1, 1)},
                  torch.zeros(2, TC.d_model), TCfg(**{**KW, "n_experts": 4, "topk": 2}),
                  pctx=ParallelCtx(mesh=tp.TwoRankMesh()))
    # the engine on model rank 1 of two, with flash-decode: its blocks of the
    # weights, and every KV head for its half of the positions
    eng = ServeEngine(TC, tparams, n_slots=2, max_len=8, mesh=tp.TwoRankMesh(1),
                      flash_decode=True)
    assert eng.params["blocks"]["wq"].shape[-1] == TC.n_heads * TC.hd // 2
    assert tuple(eng._cache["k"].shape) == (TC.n_layers, 2, 4, TC.n_kv_heads, TC.hd)
    assert eng.stats()["mesh"] == {"data": 1, "model": 2}
    with pytest.raises(ValueError, match="DeviceMesh"):
        ServeEngine(TC, tparams, mesh="everywhere")
    # "auto" lays a mesh only over a process group of more than one rank: none
    # without a group, make_mesh's over a group of 4
    import torch.distributed as dist

    import repro_torch.runtime.elastic as elastic
    from repro_torch.serve.engine import _resolve_mesh

    assert ServeEngine(TC, tparams, mesh="auto").mesh is None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dist, "is_initialized", lambda: True)
        mp.setattr(dist, "get_world_size", lambda group=None: 4)
        mp.setattr(elastic, "make_mesh", lambda **kw: ("mesh", kw))
        assert _resolve_mesh("auto", "cpu", 16) == ("mesh", {"target_model": 16,
                                                            "device": "cpu"})
    with pytest.raises(ValueError, match="families"):
        ServeEngine(TCfg(**{**KW, "family": "ssm"}), tparams)


# ---------------------------------------------------------------------------
# The zero range-reduction contract (DESIGN.md §6)
# ---------------------------------------------------------------------------
def test_static_cnn_forward_counts_no_range_reductions():
    from repro_torch.calib.runner import calibrate_cnn, count_range_reductions
    from repro_torch.models import cnn

    spec = cnn.ALEXNET_MINI
    params = cnn.init_params(spec, 0, device="cpu")
    rng = np.random.default_rng(0)
    images = torch.from_numpy(
        rng.standard_normal((2, 8, spec.input_hw, spec.input_hw, spec.input_ch)).astype(np.float32))
    table, _ = calibrate_cnn(params, spec, images, bits=8, compensate=False)
    x = images[0]
    dyn = count_range_reductions(lambda xx: cnn.forward(params, spec, xx, 8), x)
    static = count_range_reductions(lambda xx: cnn.forward(params, spec, xx, calib=table), x)
    assert dyn == len(table.sites) and static == 0
    assert count_range_reductions(lambda: torch.maximum(x, x).relu().amax()) == 1


def test_lm_decode_step_counts_no_range_reductions(trees):
    """The static int8 cache and static 8-bit activations: no runtime range;
    the dynamic int8 cache takes one max per K and V write per layer."""
    from repro_torch.calib.runner import calibrate_kv_cache, count_range_reductions
    from repro_torch.models import transformer as ttr

    tparams = trees[1]
    rng = np.random.default_rng(1)
    calib = torch.from_numpy(rng.integers(0, TC.vocab, (2, 2, 16)))
    qm = api.quantize(TC, tparams, api.QuantScheme(fmt="elp4", act="static"),
                      calib_data=calib, device="cpu")
    scales = calibrate_kv_cache(tparams, TC, calib)
    tok = torch.from_numpy(rng.integers(0, TC.vocab, (2, 1)))
    static = ttr.init_cache(TC, 2, 16, kv_scales=scales, device="cpu")
    dynamic = ttr.init_cache(TC, 2, 16, quant=True, device="cpu")
    pos = torch.tensor([3, 5])
    assert count_range_reductions(lambda: ttr.decode_step(qm.params, TC, tok, static, pos)) == 0
    assert count_range_reductions(
        lambda: ttr.decode_step(qm.params, TC, tok, dynamic, pos)) == 2 * TC.n_layers
    eng = ServeEngine(TC, qm.params, n_slots=2, max_len=16, kv_cache="paged", page_size=4,
                      kv_scales=scales)
    eng.submit(np.arange(5, dtype=np.int32), 3)
    eng.step()
    assert count_range_reductions(eng.step) == 0

"""The port's serving and training entry points over a one-rank mesh, against the JAX package.

In-process: one ``gloo`` rank (``elastic.make_mesh(device="cpu")`` starts it
on a ``FileStore``) and its ``(1, 1)`` ``("data", "model")`` mesh; the JAX
side gets ``jax.make_mesh((1, 1), ...)`` on its one CPU device. On reduced
float32 qwen3 and olmoe configs (the same weights, a JAX key carried across
as numpy) the port's ``ServeEngine(mesh=..., flash_decode=True)`` gives the
JAX engine's tokens with the same mesh and flash-decode (dense cache, paged
static-int8 cache, ngram speculative decoding: held against the JAX dense
run, whose tokens speculative decoding reproduces), and the port's meshless
engine's. Every prompt is at most 8 tokens and every step at most 8 rows,
so the expert-parallel capacity (at least 8 a bucket) drops nothing and
the meshless dense MoE is the same function. The mesh path really ran:
flash-decode issued ``all_reduce`` s and the expert exchange
``all_to_all`` s. Also: the lockstep loop over the mesh on the dense
static-int8 cache, decode steps on the dynamic int8 cache (flash-decode on
codes and scales) against the JAX package's, and the launchers run end to
end on the host.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from repro.calib import calibrate_kv_cache  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.context import ParallelCtx as JCtx  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve import ServeSetup as JSetup  # noqa: E402
from repro.serve import static_generate as jstatic  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.context import ParallelCtx  # noqa: E402
from repro_torch.runtime import collectives  # noqa: E402
from repro_torch.serve.engine import ServeEngine, ServeSetup, static_generate  # noqa: E402

ARCHS = ("qwen3_8b", "olmoe_1b_7b")
RUNS = {"dense": {}, "paged_int8": {"kv_cache": "paged", "page_size": 4},
        "ngram": {"spec_k": 3, "spec_draft": "ngram"}}
# the JAX engine run each port run is held against: speculative decoding is
# token-identical to plain serving, so the ngram run shares the dense run's
REFERENCE_RUN = {"dense": "dense", "paged_int8": "paged_int8", "ngram": "dense"}
MAX_LEN = 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test runner puts several workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meshes():
    from repro_torch.runtime.elastic import make_mesh

    auto = (jax.sharding.AxisType.Auto,) * 2  # GSPMD's sharding propagation, as the reference
    with tp.cpu_group():
        yield jax.make_mesh((1, 1), ("data", "model"), axis_types=auto), make_mesh(device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jc = dataclasses.replace(jget(request.param).reduced(), dtype_str="float32")
    tc = dataclasses.replace(tget(request.param).reduced(), dtype_str="float32")
    jp, tparams = tp.lm_params(jc, seed=2)
    rng = np.random.default_rng(3)
    batches = jnp.asarray(rng.integers(0, jc.vocab, size=(1, 2, 8)).astype(np.int32))
    scales = tuple(np.asarray(s) for s in calibrate_kv_cache(jp, jc, batches))
    reqs = [(rng.integers(0, jc.vocab, size=n).astype(np.int32), m)
            for n, m in ((5, 6), (8, 4), (3, 7), (6, 5))]
    return {"name": request.param, "jc": jc, "tc": tc, "jp": jp, "tp": tparams,
            "scales": scales, "reqs": reqs, "jax_tokens": {}}


def _engine_kw(model, run):
    kw = dict(RUNS[run], n_slots=2, max_len=MAX_LEN)
    if run == "paged_int8":
        kw["kv_scales"] = model["scales"]
    return kw


def _jax_tokens(jmesh, model, run):
    """The JAX engine's tokens for ``run``'s reference run, served once per arch."""
    ref = REFERENCE_RUN[run]
    if ref not in model["jax_tokens"]:
        eng = JEngine(model["jc"], model["jp"], mesh=jmesh, flash_decode=True,
                      **_engine_kw(model, ref))
        model["jax_tokens"][ref] = [np.asarray(t) for t in eng.serve(model["reqs"])]
    return model["jax_tokens"][ref]


@pytest.mark.parametrize("run", list(RUNS))
def test_mesh_engine_matches_jax_and_meshless(meshes, model, run):
    jmesh, tmesh = meshes
    kw = _engine_kw(model, run)
    reqs = model["reqs"]
    want = _jax_tokens(jmesh, model, run)
    collectives.reset()
    eng = ServeEngine(model["tc"], model["tp"], mesh=tmesh, flash_decode=True, **kw)
    got = eng.serve(reqs)
    issued = dict(collectives.ISSUED)
    plain = ServeEngine(model["tc"], model["tp"], mesh=None, **kw).serve(reqs)
    for g, w, p in zip(got, want, plain):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)
    assert eng.stats()["mesh"] == {"data": 1, "model": 1}
    assert eng.setup.pctx().moe_impl == "ep" and eng.setup.pctx().flash_decode
    assert issued["all_reduce"] > 0
    assert (issued["all_to_all"] > 0) == (model["tc"].family == "moe")


def test_static_generate_over_mesh_matches_jax(meshes, model):
    """The lockstep loop on the dense static-int8 cache, flash-decode over the mesh."""
    jmesh, tmesh = meshes
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, model["jc"].vocab, size=(2, 6)).astype(np.int32)
    jsetup = JSetup(cfg=model["jc"], mesh=jmesh, max_len=16, batch=2, flash_decode=True,
                    kv_bits=8)
    want = jstatic(jsetup, model["jp"], {"tokens": jnp.asarray(tokens)}, 5,
                   kv_scales=tuple(jnp.asarray(s) for s in model["scales"]))
    setup = ServeSetup(cfg=model["tc"], mesh=tmesh, max_len=16, batch=2, flash_decode=True,
                       kv_bits=8)
    collectives.reset()
    got = static_generate(setup, model["tp"], {"tokens": torch.from_numpy(tokens)}, 5,
                          kv_scales=model["scales"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert collectives.ISSUED["all_reduce"] > 0


def test_dynamic_int8_cache_decode_matches_jax(meshes):
    """Flash-decode on the dynamic int8 cache's codes and scales (qwen3 reduced)."""
    jmesh, tmesh = meshes
    jc = dataclasses.replace(jget("qwen3_8b").reduced(), dtype_str="float32")
    tc = dataclasses.replace(tget("qwen3_8b").reduced(), dtype_str="float32")
    jp, tparams = tp.lm_params(jc, seed=5)
    tokens = np.random.default_rng(6).integers(0, jc.vocab, size=(2, 9)).astype(np.int32)
    jpctx = JCtx(mesh=jmesh, batch_axes=("data",), model_axis="model", flash_decode=True)
    tpctx = ParallelCtx(mesh=tmesh, batch_axes=("data",), model_axis="model", flash_decode=True)
    jcache = jtr.init_cache(jc, 2, 16, quant=True)
    tcache = ttr.init_cache(tc, 2, 16, quant=True, device="cpu")
    ref = ttr.init_cache(tc, 2, 16, quant=True, device="cpu")
    with jmesh:
        _, jcache = jtr.prefill(jp, jc, jnp.asarray(tokens[:, :6]), jcache, pctx=jpctx)
    t6 = torch.from_numpy(tokens[:, :6])
    ttr.prefill(tparams, tc, t6, tcache, pctx=tpctx)
    ttr.prefill(tparams, tc, t6, ref)
    collectives.reset()
    for i in range(6, 9):
        with jmesh:
            want, jcache = jtr.decode_step(jp, jc, jnp.asarray(tokens[:, i:i + 1]), jcache, i,
                                           pctx=jpctx)
        step = torch.from_numpy(tokens[:, i:i + 1])
        got, _ = ttr.decode_step(tparams, tc, step, tcache, i, pctx=tpctx)
        plain, _ = ttr.decode_step(tparams, tc, step, ref, i)
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert np.abs(got.numpy() - want).max() <= 1e-5 * scale
        assert (got - plain).abs().max().item() <= 1e-5 * scale
    assert collectives.ISSUED["all_reduce"] == 2 * 3 * tc.n_layers


def test_launchers_run_on_the_host(tmp_path):
    from repro_torch.launch import serve, train

    out = serve.main(["--arch", "qwen3_8b", "--smoke", "--device", "cpu", "--flash-decode",
                      "--requests", "4", "--max-new", "6", "--metrics-out",
                      str(tmp_path / "metrics.json")])
    assert len(out["outputs"]) == 4 and out["stats"]["mesh"] is None
    assert (tmp_path / "metrics.json").exists()
    out = serve.main(["--arch", "olmoe_1b_7b", "--smoke", "--device", "cpu", "--static",
                      "--max-new", "3"])
    assert tuple(out["tokens"].shape) == (4, 3)
    out = train.main(["--arch", "qwen3_8b", "--smoke", "--device", "cpu", "--steps", "3",
                      "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path / "ckpt")])
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert out["mesh"] is None

"""The port's paged KV cache against the JAX package's, on the CPU.

Three layers:

  * :class:`repro_torch.serve.paging.PageTable` replays the same
    admit/register/release sequences as the reference allocator, with the
    same table, refcounts, prefix hits and occupancy after every op, plus
    its own allocator semantics (sharing, release, scratch parking,
    exhaustion);
  * the paged layout functions (``init_paged_cache``, ``_cache_set_paged``,
    ``_paged_view``) against the reference's on the same data, bit for bit;
  * the paged engine: int8 cache codes bit-identical to the reference
    engine's after the same admissions, tokens identical to the reference
    engine, to the port's dense engine and to the dense static-int8
    ``static_generate(kv_scales=...)``, and the same prefix hits.

The config is the reference tests' ``engine-t`` (2 layers, d_model 64).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_parity as tp  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ArchConfig as JCfg  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.paging import PageTable as JPageTable  # noqa: E402
from repro_torch.configs.base import ArchConfig as TCfg  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serve.engine import ServeEngine, ServeSetup, static_generate  # noqa: E402
from repro_torch.serve.paging import PageTable  # noqa: E402

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
def params():
    jp = jtr.init_params(JC, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def kv_scales(params):
    from repro.calib import calibrate_kv_cache

    batches = jax.random.randint(jax.random.PRNGKey(7), (3, 2, 32), 0, JC.vocab)
    k, v = calibrate_kv_cache(params[0], JC, batches)
    return np.asarray(k), np.asarray(v)


def _shared_prefix_reqs(n, seed=0, prefix_len=16, max_new=8):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, JC.vocab, prefix_len)
    return [(np.concatenate([prefix, rng.integers(0, JC.vocab, 4 + i)]).astype(np.int32),
             max_new) for i in range(n)]


# ---------------------------------------------------------------------------
# PageTable: replayed against the reference allocator
# ---------------------------------------------------------------------------
def _ops(seed, n_ops=40, n_slots=3):
    """A seeded admit/register/release sequence over prompts that share prefixes."""
    rng = np.random.default_rng(seed)
    bases = [rng.integers(0, 50, 40).astype(np.int32) for _ in range(3)]
    live, ops = set(), []
    for _ in range(n_ops):
        free = [s for s in range(n_slots) if s not in live]
        if free and (not live or rng.random() < 0.6):
            slot = int(rng.choice(free))
            base = bases[rng.integers(0, 3)]
            cut = int(rng.integers(1, 40))
            prompt = np.concatenate([base[:cut], rng.integers(50, 60, rng.integers(0, 6))])
            ops.append(("admit", slot, prompt.astype(np.int32)))
            live.add(slot)
        else:
            slot = int(rng.choice(sorted(live)))
            ops.append(("release", slot, None))
            live.discard(slot)
    return ops


def _state(pt):
    return (pt.table.copy(), pt.refs.copy(), pt.prefix_hits, pt.pages_used, pt.pages_shared,
            pt.admissions, pt.pages_allocated, sorted(pt._free))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("page_size", [4, 8])
def test_page_table_replay_matches_reference(seed, page_size):
    geom = dict(n_slots=3, max_len=48, page_size=page_size)
    n_pages = 3 * (-(-48 // page_size)) + 3
    jpt, tpt = JPageTable(**geom, n_pages=n_pages), PageTable(**geom, n_pages=n_pages)
    for op, slot, prompt in _ops(seed):
        if op == "admit":
            assert tpt.admit(slot, prompt) == jpt.admit(slot, prompt)
            tpt.register(slot, prompt)
            jpt.register(slot, prompt)
        else:
            tpt.release(slot)
            jpt.release(slot)
        for a, b in zip(_state(tpt), _state(jpt)):
            np.testing.assert_array_equal(a, b)
    assert tpt.prefix_hits == jpt.prefix_hits
    np.testing.assert_array_equal(tpt.to_device().numpy(), np.asarray(jpt.to_device()))
    np.testing.assert_array_equal(tpt.to_device(1).numpy(), np.asarray(jpt.to_device(1)))


def test_prefix_sharing_refcounts_and_release():
    pt = PageTable(n_slots=3, max_len=32, page_size=8, n_pages=16)
    prompt = np.arange(20, dtype=np.int32)  # 2 full pages + 4 tokens
    assert pt.admit(0, prompt) == 0 and pt.pages_used == 4
    pt.register(0, prompt)
    assert pt.admit(1, prompt.copy()) == 16 and pt.prefix_hits == 2 and pt.pages_shared == 2
    assert set(pt.table[0][2:]).isdisjoint(set(pt.table[1][2:]))
    pt.release(0)
    assert pt.pages_shared == 0 and pt.pages_used == 4
    pt.release(1)
    assert pt.pages_used == 0 and pt.admit(2, prompt.copy()) == 0  # de-indexed


def test_release_parks_row_on_scratch_exhaustion_and_validation():
    pt = PageTable(n_slots=2, max_len=16, page_size=8, n_pages=8)
    pt.admit(0, np.arange(10, dtype=np.int32))
    pt.release(0)
    assert (pt.table[0] == pt.scratch[0]).all() and pt.pages_used == 0
    small = PageTable(n_slots=2, max_len=32, page_size=8, n_pages=7)
    small.admit(0, np.arange(20, dtype=np.int32))
    with pytest.raises(RuntimeError, match="exhausted"):
        small.admit(1, np.arange(100, 120, dtype=np.int32))
    with pytest.raises(ValueError, match="n_pages"):
        PageTable(n_slots=2, max_len=32, page_size=8, n_pages=5)


def test_to_device_is_a_copy():
    pt = PageTable(n_slots=2, max_len=16, page_size=4, n_pages=10)
    pt.admit(0, np.arange(6, dtype=np.int32))
    snap = pt.to_device()
    before = snap.clone()
    pt.table[:] = -1
    assert torch.equal(snap, before) and snap.dtype == torch.int64


# ---------------------------------------------------------------------------
# The layout functions, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vector_pos", [False, True])
def test_paged_write_and_view_match_reference(vector_pos):
    rng = np.random.default_rng(0)
    page, pmax, b, s = 4, 5, 3, 3
    pool = rng.standard_normal((b * pmax + b, page, 2, 8)).astype(np.float32)
    pages = rng.permutation(b * pmax).reshape(b, pmax).astype(np.int32)
    u = rng.standard_normal((b, s, 2, 8)).astype(np.float32)
    jpos = jnp.asarray([1, 6, 13], jnp.int32) if vector_pos else jnp.int32(5)
    tpos = torch.tensor([1, 6, 13]) if vector_pos else 5
    want = jtr._cache_set_paged(jnp.asarray(pool), jnp.asarray(u), jpos, jnp.asarray(pages))
    got = ttr._cache_set_paged(torch.from_numpy(pool.copy()), torch.from_numpy(u), tpos,
                               torch.from_numpy(pages).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ttr._paged_view(got, torch.from_numpy(pages).long()).numpy(),
        np.asarray(jtr._paged_view(want, jnp.asarray(pages))))


def test_init_paged_cache_matches_reference(kv_scales):
    for scales in (None, kv_scales):
        want = jtr.init_paged_cache(JC, 3, 40, page_size=8, kv_scales=scales)
        got = ttr.init_paged_cache(TC, 3, 40, page_size=8, kv_scales=scales, device="cpu")
        assert sorted(got) == sorted(want)
        for key in want:
            assert tuple(got[key].shape) == want[key].shape
            assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype) or key == "pages"
        assert ttr.cache_layout(got) == jtr.cache_layout(want)


# ---------------------------------------------------------------------------
# The paged engine
# ---------------------------------------------------------------------------
def test_paged_int8_codes_bit_identical_after_admissions(params, kv_scales):
    """The same admissions into both engines' int8 page pools: the same codes."""
    jp, tparams = params
    reqs = _shared_prefix_reqs(3, seed=1)
    kw = dict(n_slots=3, max_len=48, kv_cache="paged", page_size=8, kv_scales=kv_scales)
    jeng = JEngine(JC, jp, mesh=None, **kw)
    teng = ServeEngine(TC, tparams, **kw)
    for prompt, n in reqs:
        jeng.submit(prompt, n)
        teng.submit(prompt, n)
    jeng.step()  # three admissions, then one decode step
    teng.step()
    for key in ("k", "v"):
        want = np.asarray(jeng._cache[key])
        got = teng._cache[key].numpy()
        assert got.dtype == np.int8 and np.count_nonzero(want) > 0
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(teng._pager.table, jeng._pager.table)
    assert teng.cache_stats() == jeng.cache_stats()


def test_paged_engines_token_parity(params, kv_scales):
    """Float and int8 paged engines against the reference engines and the
    port's own references: the dense engine (float) and the dense
    static-int8 static_generate (int8)."""
    jp, tparams = params
    reqs = _shared_prefix_reqs(5, seed=3)
    dense = ServeEngine(TC, tparams, n_slots=2, max_len=64).serve(reqs)
    kw = dict(n_slots=2, max_len=64, kv_cache="paged", page_size=8)
    for scales in (None, kv_scales):
        jeng = JEngine(JC, jp, mesh=None, kv_scales=scales, **kw)
        teng = ServeEngine(TC, tparams, kv_scales=scales, **kw)
        want, got = jeng.serve(reqs), teng.serve(reqs)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)
        st = teng.cache_stats()
        assert st == jeng.cache_stats()
        assert st["prefix_hits"] > 0 and st["pages_used"] == 0
        if scales is None:
            for a, b in zip(dense, got):
                np.testing.assert_array_equal(b, a)
    setup = ServeSetup(cfg=TC, mesh=None, max_len=64, batch=1)
    for (prompt, n), out in zip(reqs, got):
        ref = static_generate(setup, tparams, {"tokens": torch.from_numpy(prompt[None])}, n,
                              kv_scales=kv_scales)
        np.testing.assert_array_equal(ref[0].numpy(), out)


def test_paged_eviction_frees_pages_and_reuses_slot(params):
    _, tparams = params
    eng = ServeEngine(TC, tparams, n_slots=1, max_len=64, kv_cache="paged", page_size=8)
    rng = np.random.default_rng(11)
    r1 = eng.submit(rng.integers(0, TC.vocab, 20).astype(np.int32), 30)
    eng.step()
    assert eng.cache_stats()["pages_used"] == eng._pager.pmax
    eng.evict(r1)
    assert eng.cache_stats()["pages_used"] == 0
    prompt = rng.integers(0, TC.vocab, 12).astype(np.int32)
    r2 = eng.submit(prompt, 6)
    eng.run()
    ref = ServeEngine(TC, tparams, n_slots=1, max_len=64).serve([(prompt, 6)])
    np.testing.assert_array_equal(eng.result(r2), ref[0])


def test_engine_validation_errors(params):
    _, tparams = params
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(TC, tparams, kv_bits=8)
    with pytest.raises(ValueError, match="kv_scales"):
        ServeEngine(TC, tparams, kv_cache="paged", kv_bits=8)
    with pytest.raises(ValueError, match="int8"):
        ServeEngine(TC, tparams, kv_cache="paged", kv_bits=4,
                    kv_scales=(np.ones((2, 2)), np.ones((2, 2))))
    with pytest.raises(ValueError, match="kv_cache"):
        ServeEngine(TC, tparams, kv_cache="chunked")
    # a paged engine over a model axis of two ranks: the pool keeps the rank's KV
    # heads (flash-decode or not), the page table and the static scales stay whole
    scales = (np.ones((TC.n_layers, TC.n_kv_heads)), np.ones((TC.n_layers, TC.n_kv_heads)))
    eng = ServeEngine(TC, tparams, kv_cache="paged", page_size=4, kv_scales=scales,
                      flash_decode=True, mesh=tp.TwoRankMesh(1), n_slots=2, max_len=8)
    assert eng._cache["k"].shape[3] == TC.n_kv_heads // 2
    assert tuple(eng._cache["k_scale"].shape) == (TC.n_layers, TC.n_kv_heads)

"""The port's sharding rules and mesh policy against the JAX package's.

For every registered config at full size, the port's ``param_specs`` (float
and packed a4 trees), ``zero1_specs_tree``, ``cache_specs_tree`` (dense,
paged, static int8, sequence-first) and ``input_spec`` equal the JAX
package's on four mesh shapes, a ``PartitionSpec`` read as a tuple. The
rules read only axis sizes, so the JAX side gets the duck-typed mesh of
``tests/test_sharding_rules.py`` and abstract trees from ``jax.eval_shape``;
the port side gets shape-only trees on the ``meta`` device. No process
group is started.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.api_schemes import pack_lm_params as jpack  # noqa: E402
from repro.configs import ARCH_IDS, get_config as jget  # noqa: E402
from repro.core.elp_bsd import PRESET_FORMATS  # noqa: E402
from repro.models import get_model as jmodel  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.runtime import elastic as jel  # noqa: E402
from repro.runtime import sharding as jshr  # noqa: E402
from repro_torch.api_schemes import pack_lm_params as tpack  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import get_model as tmodel  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.runtime import elastic as tel  # noqa: E402
from repro_torch.runtime import sharding as tshr  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the test runner puts several workers on
    one host, where oversubscribed torch threads slow small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    """Duck-typed mesh: the rules read only .shape."""

    def __init__(self, shape: dict):
        self.shape = shape


MESHES = ({"data": 1, "model": 1}, {"data": 2, "model": 4}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16})
BATCH, MAX_LEN, PAGE = 16, 4096, 16
FMT = "elp_bsd_a4"
TRANSFORMER_FAMILIES = ("dense", "moe", "vlm")


def _jkey(k) -> str | None:
    if hasattr(k, "key"):
        return str(k.key)
    if hasattr(k, "name"):
        return str(k.name)
    return str(k.idx)


def jflat(specs) -> dict:
    """{path: spec tuple} of a JAX spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(_jkey(k) for k in path): tuple(s) for path, s in leaves}


def tflat(specs, tree) -> dict:
    """{path: spec tuple} of a port spec tree, walked along ``tree``'s structure."""
    out = {}

    def visit(path, _, spec):
        out["/".join(path)] = spec

    def walk(t, s, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k], path + (str(k),))
        elif isinstance(t, (tuple, list)):
            for i, (a, b) in enumerate(zip(t, s)):
                walk(a, b, path + (str(i),))
        else:
            tshr.map_with_path(lambda p, leaf, sp: visit(path + p, leaf, sp), t, s)

    walk(tree, specs, ())
    return out


@pytest.fixture(scope="module", params=ARCH_IDS)
def trees(request):
    """Abstract (JAX) and shape-only (port) trees of one config at full size."""
    name = request.param
    jc, tc = jget(name), tget(name)
    japi, tapi = jmodel(jc), tmodel(tc)
    jp = jax.eval_shape(lambda: japi.init_params(jc, jax.random.PRNGKey(0)))
    tp = tapi.init_params(tc, 0, device="meta")
    fmt = PRESET_FORMATS[FMT]
    jq = jax.eval_shape(lambda p: jpack(p, jc, fmt), jp)
    tq = tpack(tp, tc, FMT)
    caches = {"dense": (jax.eval_shape(lambda: japi.init_cache(jc, BATCH, MAX_LEN)),
                        tapi.init_cache(tc, BATCH, MAX_LEN, device="meta"))}
    if jc.family in TRANSFORMER_FAMILIES:
        n = jc.n_dec_layers or jc.n_layers
        js = jnp.ones((n, jc.n_kv_heads), jnp.float32)
        ts = torch.ones((n, tc.n_kv_heads), dtype=torch.float32, device="meta")
        caches["static"] = (
            jax.eval_shape(lambda: jtr.init_cache(jc, BATCH, MAX_LEN, kv_scales=(js, js))),
            ttr.init_cache(tc, BATCH, MAX_LEN, kv_scales=(ts, ts), device="meta"))
        caches["paged"] = (
            jax.eval_shape(lambda: jtr.init_paged_cache(jc, BATCH, MAX_LEN, page_size=PAGE)),
            ttr.init_paged_cache(tc, BATCH, MAX_LEN, page_size=PAGE, device="meta"))
        caches["paged_static"] = (
            jax.eval_shape(lambda: jtr.init_paged_cache(jc, BATCH, MAX_LEN, page_size=PAGE,
                                                        kv_scales=(js, js))),
            ttr.init_paged_cache(tc, BATCH, MAX_LEN, page_size=PAGE, kv_scales=(ts, ts),
                                 device="meta"))
    return {"name": name, "params": (jp, tp), "packed": (jq, tq), "caches": caches}


def _equal(got: dict, want: dict, what: str) -> None:
    assert sorted(got) == sorted(want), what
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, f"{what}: {bad}"


def test_param_specs_equal_float_and_packed(trees):
    for kind in ("params", "packed"):
        jp, tp = trees[kind]
        for shape in MESHES:
            want = jflat(jshr.param_specs(jp, FakeMesh(shape)))
            got = tflat(tshr.param_specs(tp, FakeMesh(shape)), tp)
            _equal(got, want, f"{trees['name']} {kind} {shape}")


def test_zero1_specs_equal(trees):
    for kind in ("params", "packed"):
        jp, tp = trees[kind]
        for shape in MESHES:
            m = FakeMesh(shape)
            want = jflat(jshr.zero1_specs_tree(jshr.param_specs(jp, m), jp, m))
            got = tflat(tshr.zero1_specs_tree(tshr.param_specs(tp, m), tp, m), tp)
            _equal(got, want, f"{trees['name']} {kind} zero1 {shape}")


def test_cache_specs_equal(trees):
    for layout, (jcache, tcache) in trees["caches"].items():
        for shape in MESHES:
            for prefer_seq in (False, True):
                m = FakeMesh(shape)
                want = jflat(jshr.cache_specs_tree(jcache, m, prefer_seq=prefer_seq))
                got = tflat(tshr.cache_specs_tree(tcache, m, prefer_seq=prefer_seq), tcache)
                _equal(got, want, f"{trees['name']} {layout} {shape} prefer_seq={prefer_seq}")


def test_input_spec_equal():
    for shape in MESHES:
        m = FakeMesh(shape)
        for dims in ((1, 128), (2, 64), (8, 4096), (16, 7), (48, 3, 5), (256, 4096), (512, 1),
                     (3,), (1024,)):
            assert tshr.input_spec(dims, m) == tuple(jshr.input_spec(dims, m)), (shape, dims)
            want = jax.tree.map(tuple, jshr.input_specs_tree(
                {"tokens": jax.ShapeDtypeStruct(dims, jnp.int32)}, m),
                is_leaf=lambda x: isinstance(x, P))
            assert tshr.input_specs_tree({"tokens": torch.empty(dims, device="meta")}, m) == want
    # a DeviceMesh-like object with named dims reads the same sizes
    assert tshr.mesh_shape({"data": 2, "model": 4}) == {"data": 2, "model": 4}
    assert tshr.batch_axes(FakeMesh(MESHES[3])) == jshr.batch_axes(FakeMesh(MESHES[3]))


def test_choose_mesh_shape_equal():
    for t in (1, 2, 4, 8, 16):
        for n in range(1, 1025):
            assert tel.choose_mesh_shape(n, t) == jel.choose_mesh_shape(n, t), (n, t)


def test_named_placements():
    from torch.distributed.tensor import Replicate, Shard

    m = FakeMesh({"pod": 2, "data": 16, "model": 16})
    tree = {"w": (None, ("pod", "data"), "model"), "b": ()}
    got = tshr.named(m, tree)
    assert got["w"] == (Shard(1), Shard(1), Shard(2))
    assert got["b"] == (Replicate(), Replicate(), Replicate())

"""The port's MoE FFN (``models/moe.py``) and expert-stack packing against the JAX package.

The same numpy inputs through both packages on the CPU, in float32:
routing (expert ids equal, gates within 1e-6), the batched expert FFN and
the dense MoE (within 1e-5 of max |output|: float32 sums in another
order), with float and with a4-packed expert stacks, and the
``[L, E, K', N]`` codes and ``[L, E, 1, 1]`` scale factors of a packed
expert stack (bit-identical).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_parity as tp  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.runtime.quantized_params import quantize_stacked as jquantize_stacked  # noqa: E402
from repro_torch.core.elp_bsd import resolve_format  # noqa: E402
from repro_torch.interop import packed_from_numpy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.runtime.quantized_params import quantize_stacked  # noqa: E402

E, D, FF, T = 8, 32, 48, 10
REL = 1e-5


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


def _cfgs(kind="swiglu", n_experts=E, topk=2):
    from repro.configs.base import ArchConfig as JCfg
    from repro_torch.configs.base import ArchConfig as TCfg

    kw = dict(name="m", family="moe", n_layers=2, d_model=D, n_heads=4, n_kv_heads=4,
              d_ff=FF, vocab=64, head_dim=8, mlp_kind=kind, n_experts=n_experts, topk=topk,
              dtype_str="float32")
    return JCfg(**kw), TCfg(**kw)


def _experts(seed=0, layers=None):
    rng = np.random.default_rng(seed)
    lead = (E,) if layers is None else (layers, E)
    w1, w3 = (rng.standard_normal((*lead, D, FF)).astype(np.float32) / np.sqrt(D)
              for _ in range(2))
    w2 = rng.standard_normal((*lead, FF, D)).astype(np.float32) / np.sqrt(FF)
    return w1, w3, w2


def _pack_both(w):
    """The JAX package's packed stack and the port's, of the same numpy weight (a4)."""
    jpw = jquantize_stacked(jnp.asarray(w), "elp_bsd_a4")
    tpw = quantize_stacked(torch.from_numpy(w), resolve_format("elp_bsd_a4"))
    return jpw, tpw


@pytest.mark.parametrize("ties", [False, True])
def test_router_gates_match_reference(ties):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((T, D)).astype(np.float32)
    router = rng.standard_normal((D, E)).astype(np.float32)
    if ties:  # equal logits: the lower expert index must come first, as in lax.top_k
        router[:, 5] = router[:, 2]
        router[:, 7] = router[:, 2]
        x[:, :] = np.abs(x)
    jg, ji = jmoe.router_gates(jnp.asarray(x), jnp.asarray(router), 3)
    tg, ti = tmoe.router_gates(torch.from_numpy(x), torch.from_numpy(router), 3)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.abs(tg.numpy() - np.asarray(jg)).max() <= 1e-6


def test_router_ties_keep_the_lower_index_first():
    x = torch.ones(4, 2)
    router = torch.tensor([[1.0, 2.0, 2.0, 0.5, 2.0], [0.0, 0.0, 0.0, 0.0, 0.0]])
    gates, ids = tmoe.router_gates(x, router, 3)
    assert ids.tolist() == [[1, 2, 4]] * 4
    assert torch.allclose(gates, torch.full((4, 3), 1.0 / 3))


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
@pytest.mark.parametrize("packed", [False, True])
def test_expert_ffn_matches_reference(kind, packed):
    w1, w3, w2 = _experts()
    h = np.random.default_rng(2).standard_normal((E, T, D)).astype(np.float32)
    if packed:
        (j1, t1), (j3, t3), (j2, t2) = (_pack_both(w) for w in (w1, w3, w2))
    else:
        (j1, j3, j2), (t1, t3, t2) = ((jnp.asarray(w) for w in (w1, w3, w2)),
                                      (torch.from_numpy(w) for w in (w1, w3, w2)))
    want = jmoe._expert_ffn(jnp.asarray(h), j1, j3, j2, kind)
    got = tmoe._expert_ffn(torch.from_numpy(h), t1, t3, t2, kind)
    _close(got, want)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n_experts,topk", [(E, 2), (E, 8), (4, 1)])
def test_moe_dense_matches_reference(packed, n_experts, topk):
    jc, tc = _cfgs(n_experts=n_experts, topk=topk)
    rng = np.random.default_rng(3)
    w1, w3, w2 = (w[:n_experts] for w in _experts(4))
    router = rng.standard_normal((D, n_experts)).astype(np.float32) / np.sqrt(D)
    x = rng.standard_normal((T, D)).astype(np.float32)
    jp = {"router": jnp.asarray(router)}
    tpar = {"router": torch.from_numpy(router)}
    for name, w in (("we1", w1), ("we3", w3), ("we2", w2)):
        if packed:
            jp[name], tpar[name] = _pack_both(w)
        else:
            jp[name], tpar[name] = jnp.asarray(w), torch.from_numpy(w)
    want = jmoe.moe_dense(jp, jnp.asarray(x), jc)
    got = tmoe.moe_apply(tpar, torch.from_numpy(x), tc)
    _close(got, want)


def test_moe_over_a_mesh_raises():
    """Over a mesh the MoE is expert parallel (``moe_ep``): each rank holds its shard
    of the experts, and gated ones; whole stacks or GELU experts raise before any
    collective. (Its results are held in test_torch_distributed.py.)"""
    from repro_torch.models.context import ParallelCtx

    _, tc = _cfgs()
    pctx = ParallelCtx(mesh=tp.TwoRankMesh())
    whole = {"router": torch.zeros(D, E), "we1": torch.zeros(E, D, FF),
             "we3": torch.zeros(E, D, FF), "we2": torch.zeros(E, FF, D)}
    with pytest.raises(ValueError, match="this rank's shard"):
        tmoe.moe_apply(whole, torch.zeros(T, D), tc, pctx=pctx)
    with pytest.raises(ValueError, match="gated"):
        tmoe.moe_apply({**whole, "we3": None}, torch.zeros(T, D), tc, pctx=pctx)
    with pytest.raises(ValueError, match="do not divide"):
        tmoe.moe_apply(whole, torch.zeros(T, D), _cfgs(n_experts=3)[1], pctx=pctx)


def test_expert_stack_codes_and_sf_bit_identical():
    w1, _, w2 = _experts(5, layers=2)
    for w in (w1, w2):
        jpw, tpw = _pack_both(w)
        assert tuple(tpw.codes.shape) == tuple(jpw.codes.shape) == (2, E, (w.shape[2] + 1) // 2,
                                                                     w.shape[3])
        assert tuple(tpw.sf.shape) == tuple(jpw.sf.shape) == (2, E, 1, 1)
        assert np.array_equal(tpw.codes.numpy(), np.asarray(jpw.codes))
        assert np.array_equal(tpw.sf.numpy(), np.asarray(jpw.sf))
        assert tpw.shape == jpw.shape and tpw.n_layers == 2
        # a layer view is the [E, K', N] stack, sharing storage, decoded whole
        view = tpw.layer(1)
        assert view.codes.data_ptr() == tpw.codes[1].data_ptr()
        assert tuple(view.sf.shape) == (E, 1, 1)
        jview = jax.tree.map(lambda a: a[1], jpw)
        assert np.array_equal(tops.dequantize(view).numpy(), np.asarray(jops.dequantize(jview)))


def test_packed_expert_stack_carries_across_and_ignores_act_scale():
    """A JAX-packed expert stack carried across as numpy serves the same FFN; a
    static act scale stamped on it changes nothing (the reference's _dq ignores it)."""
    w1, w3, w2 = _experts(6)
    h = np.random.default_rng(7).standard_normal((E, T, D)).astype(np.float32)
    jw = [jquantize_stacked(jnp.asarray(w), "elp_bsd_a4") for w in (w1, w3, w2)]
    tw = [packed_from_numpy(np.asarray(p.codes), np.asarray(p.sf), p.fmt_name, p.nibble, p.shape,
                            device="cpu") for p in jw]
    stamped = [dataclasses.replace(p, act_scale=0.01, act_bits=8) for p in tw]
    want = jmoe._expert_ffn(jnp.asarray(h), *jw, "swiglu")
    got = tmoe._expert_ffn(torch.from_numpy(h), *tw, "swiglu")
    _close(got, want)
    assert torch.equal(tmoe._expert_ffn(torch.from_numpy(h), *stamped, "swiglu"), got)


def test_reduced_olmoe_block_params_and_layout():
    """A seeded reduced olmoe tree has the reference's leaves and shapes; its experts
    the reference's init scale (fan-in E)."""
    from repro.configs import get_config as jget
    from repro.models import transformer as jtr
    from repro_torch.configs import get_config as tget
    from repro_torch.models import transformer as ttr

    jc, tc = jget("olmoe_1b_7b").reduced(), tget("olmoe_1b_7b").reduced()
    jp = jax.eval_shape(lambda: jtr.init_params(jc, jax.random.PRNGKey(0)))
    tpar = ttr.init_params(tc, 0, device="cpu")
    jshapes = {k: tuple(v.shape) for k, v in jp["blocks"].items()}
    tshapes = {k: tuple(v.shape) for k, v in tpar["blocks"].items()}
    assert tshapes == jshapes
    std = float(tpar["blocks"]["we1"].std())
    # truncated at +-2 sigma: std 0.88 of 1/sqrt(E)
    assert abs(std - 0.88 / np.sqrt(tc.n_experts)) < 0.05 / np.sqrt(tc.n_experts)

"""The training loop's data, schedule, optimizer and gradient codecs, port against
the JAX package, on the CPU.

* ``LmDataset`` batches bit-identical (tokens, labels and frontend arrays) for
  a dense config, a ``vlm`` config (frontend patches, tokens cut to make room)
  and an ``encdec`` config (frontend frames), over several steps;
  ``shard_batch`` without a mesh moves them unchanged.
* ``warmup_cosine`` equal over warmup, decay and the floor.
* ``adamw.update``, three steps on the same gradients: masters, moments and
  parameters within 1e-6 of each leaf's max (float32 sums in another order
  in the global norm; the moments' arithmetic is elementwise), for float32
  and bfloat16 parameters; ``global_norm`` and the clip alike.
* ``int8`` and ``elp4`` codes and scales bit-identical; error-feedback
  residuals within 1e-7 of max |x| over three steps.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import ArchConfig as JCfg  # noqa: E402
from repro.data.pipeline import LmDataset as JLm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compress as jcomp  # noqa: E402
from torch_parity import cpu_group  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs.base import ArchConfig as TCfg  # noqa: E402
from repro_torch.data.pipeline import LmDataset as TLm  # noqa: E402
from repro_torch.data.pipeline import shard_batch  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import compress as tcomp  # noqa: E402

DENSE = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
             d_ff=64, vocab=64, head_dim=8, dtype_str="float32")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the test runner puts several workers on
    one host, and oversubscribed torch threads made these small ops 20-50x
    slower (the lm_ptq case: 12 s alone, 222 s beside five other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(which):
    if which == "dense":
        return JCfg(**DENSE), TCfg(**DENSE)
    return jget(which).reduced(), tget(which).reduced()


@pytest.mark.parametrize("which", ["dense", "internvl2_26b", "seamless_m4t_large_v2"])
def test_lm_dataset_batches_bit_identical(which):
    jc, tc = _cfgs(which)
    assert (tc.family, tc.frontend_tokens) == (jc.family, jc.frontend_tokens)
    jd, td = JLm(jc, seq_len=24, batch=3, seed=4), TLm(tc, seq_len=24, batch=3, seed=4)
    for step in (0, 1, 7, 50_000):
        jb, tb = jd.np_batch(step), td.np_batch(step)
        assert sorted(jb) == sorted(tb)
        if which != "dense":
            assert "frontend" in tb
        for k in jb:
            assert tb[k].dtype == jb[k].dtype and tb[k].shape == jb[k].shape
            np.testing.assert_array_equal(tb[k], jb[k])
    moved = shard_batch(tb, device="cpu")
    for k in tb:
        np.testing.assert_array_equal(moved[k].numpy(), tb[k])
    # over a (3, 1) mesh the rank at data index 2 gets the third row
    third = shard_batch(tb, mesh=_ThirdOfThree(), device="cpu")
    for k in tb:
        np.testing.assert_array_equal(third[k].numpy(), tb[k][2:3])


class _ThirdOfThree:
    """The rank at data index 2 of a (3, 1) ("data", "model") mesh, as slicing reads it."""

    mesh_dim_names, shape = ("data", "model"), (3, 1)

    def get_coordinate(self):
        return [2, 0]


def test_warmup_cosine_equal():
    steps = np.arange(0, 130, dtype=np.int32)
    for peak, warmup, total in ((3e-3, 20, 100), (6e-4, 0, 50)):
        want = np.asarray(jax.vmap(jadamw.warmup_cosine(peak, warmup, total))(jnp.asarray(steps)))
        got = tadamw.warmup_cosine(peak, warmup, total)(torch.from_numpy(steps)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _tree(rng, dtype=np.float32):
    return {"a": rng.normal(size=(5, 7)).astype(dtype),
            "blocks": {"w": rng.normal(size=(2, 3, 4)).astype(dtype),
                       "ln": rng.normal(size=(2, 3)).astype(dtype)}}


def _leaves(tree):
    return [tree["a"], tree["blocks"]["ln"], tree["blocks"]["w"]]


def _close_leaves(got, want, rel):
    for g, w in zip(_leaves(got), _leaves(want)):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else np.asarray(g, np.float32)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * max(np.abs(w).max(), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_three_steps(dtype):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                          torch.bfloat16)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p0)
    tp = {"a": torch.from_numpy(p0["a"]).to(tdt),
          "blocks": {k: torch.from_numpy(v).to(tdt) for k, v in p0["blocks"].items()}}
    cfg_j, cfg_t = jadamw.AdamWConfig(grad_clip=2.0), tadamw.AdamWConfig(grad_clip=2.0)
    js, ts = jadamw.init_state(jp), tadamw.init_state(tp)
    jsched, tsched = jadamw.warmup_cosine(1e-2, 1, 10), tadamw.warmup_cosine(1e-2, 1, 10)
    for step in range(3):
        g = _tree(np.random.default_rng(10 + step))
        jg = jax.tree.map(lambda a: jnp.asarray(a, jdt), g)
        tg = {"a": torch.from_numpy(g["a"]).to(tdt),
              "blocks": {k: torch.from_numpy(v).to(tdt) for k, v in g["blocks"].items()}}
        np.testing.assert_allclose(float(tadamw.global_norm(tg)), float(jadamw.global_norm(jg)),
                                   rtol=1e-6)
        jc, jn = jadamw.clip_by_global_norm(jg, cfg_j.grad_clip)
        tc, tn = tadamw.clip_by_global_norm(tg, cfg_t.grad_clip)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _close_leaves(tc, jc, 1e-6)
        jlr, tlr = jsched(js["step"]), tsched(ts["step"])
        jp, js = jadamw.update(jg, js, cfg_j, jlr, jdt)
        tp, ts = tadamw.update(tg, ts, cfg_t, tlr, tdt)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for key in ("m", "v", "master"):
            _close_leaves(ts[key], js[key], 1e-6)
        assert all(t.dtype == tdt for t in _leaves(tp))
        _close_leaves(tp, jp, 1e-6)
    # the masters never alias the parameters
    assert tp["a"].data_ptr() != ts["master"]["a"].data_ptr()


@pytest.mark.parametrize("size", [256 * 3, 1000])
@pytest.mark.parametrize("codec", ["int8", "elp4"])
def test_gradient_codecs_bit_identical_with_feedback(codec, size):
    rng = np.random.default_rng(size)
    quant = {"int8": (jcomp._quant_int8, tcomp._quant_int8),
             "elp4": (jcomp._quant_elp4, tcomp._quant_elp4)}[codec]
    x = (rng.normal(size=(size,)) * np.exp(rng.normal(size=(size,)))).astype(np.float32)
    (jq, js), (tq, ts) = quant[0](jnp.asarray(x)), quant[1](torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    shape = (size // 8, 8) if size % 8 == 0 else (size,)
    jerr = jcomp.init_error_state({"g": jnp.zeros(shape)})
    terr = tcomp.init_error_state({"g": torch.zeros(shape)})
    for step in range(3):
        g = rng.normal(size=shape).astype(np.float32)
        jgq, jerr = jcomp.tree_quantize_with_feedback({"g": jnp.asarray(g)}, jerr, codec)
        tgq, terr = tcomp.tree_quantize_with_feedback({"g": torch.from_numpy(g)}, terr, codec)
        scale = np.abs(g).max()
        np.testing.assert_allclose(tgq["g"].numpy(), np.asarray(jgq["g"]), rtol=0,
                                   atol=1e-7 * scale)
        np.testing.assert_allclose(terr["g"].numpy(), np.asarray(jerr["g"]), rtol=0,
                                   atol=1e-7 * scale)
    assert tcomp.compression_ratio(codec) == jcomp.compression_ratio(codec)
    with pytest.raises(ValueError, match="codec"):
        tcomp.quantize_with_feedback(torch.zeros(3), torch.zeros(3), "fp8")
    # the mean over a one-rank group is the codec's round trip (4 ranks:
    # test_torch_distributed.py)
    dq = {"int8": jcomp._dequant_int8, "elp4": jcomp._dequant_elp4}[codec]
    want = np.asarray(dq(jq, js, x.shape, x.size))
    with cpu_group() as group:
        got = tcomp.compressed_mean(torch.from_numpy(x), group, codec)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7 * np.abs(x).max())

"""The saved artifact and its pieces, port against the JAX package, on the CPU.

* ``encode_to_codes`` / ``pack_codes`` / ``unpack_codes`` / ``bitpack``:
  bytes identical to the JAX package's, every Table II format.
* ``CheckpointManager``: the same leaf keys as the JAX package's
  ``_flatten`` (dict keys sorted, sequence indices, ``.codes``/``.sf``);
  a round trip restores every leaf bit for bit (bfloat16 included) and
  each package reads the other's steps; keep/prune; a corrupt newest
  step is skipped.
* ``QuantizedModel.save``/``load``: an artifact saved by the JAX package
  loads in the port (same checksums, logits within 1e-4 of max |logit|
  with float activations, argmax identical); a port round trip is
  bit-identical, static table and report included, and the JAX package
  reads it; a flipped byte, a missing leaf or a wrong version raises
  ``ArtifactError``; a speculative scheme never loads.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.convert  # noqa: E402,F401  (repro.core re-exports a function named convert)
from repro import api as japi  # noqa: E402
from repro.checkpoint import manager as jmgr  # noqa: E402
from repro.core import elp_bsd as jelp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.checkpoint import manager as tmgr  # noqa: E402
from repro_torch.core import convert as tconvert  # noqa: E402
from repro_torch.core import elp_bsd as telp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

jconvert = __import__("sys").modules["repro.core.convert"]
FMT_NAMES = sorted(telp.PRESET_FORMATS)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the test runner puts several workers on
    one host, where oversubscribed torch threads slow small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", FMT_NAMES)
@pytest.mark.parametrize("n", [1, 7, 64, 1001])
def test_pack_codes_bytes_identical(name, n):
    jf, tf = jelp.PRESET_FORMATS[name], telp.PRESET_FORMATS[name]
    rng = np.random.default_rng(n)
    idx = rng.integers(0, len(tf.levels()), size=n)
    codes = telp.encode_to_codes(idx, tf)
    np.testing.assert_array_equal(codes, jelp.encode_to_codes(idx, jf))
    buf = telp.pack_codes(codes, tf)
    np.testing.assert_array_equal(buf, jelp.pack_codes(codes, jf))
    assert buf.dtype == np.uint8 and buf.size == telp.storage_bytes(n, tf)
    np.testing.assert_array_equal(telp.unpack_codes(buf, n, tf), jelp.unpack_codes(buf, n, jf))
    np.testing.assert_array_equal(telp.unpack_codes(buf, n, tf), codes)


@pytest.mark.parametrize("name", FMT_NAMES)
@pytest.mark.parametrize("shape", [(3, 3, 5, 7), (33, 10)])
def test_bitpack_bytes_identical(name, shape):
    w = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    jc = jconvert.convert_tensor(jnp.asarray(w), name)
    tc = tconvert.convert_tensor(torch.from_numpy(w), name)
    np.testing.assert_array_equal(tconvert.bitpack(tc), jconvert.bitpack(jc))


def _tree(seed=0):
    """A nested tree with every leaf kind: float32, bfloat16, int32, a packed weight,
    a list, a tuple and a None."""
    g = torch.Generator().manual_seed(seed)
    pw, _ = tops.pack_weight(torch.randn(9, 6, generator=g), "elp_bsd_a4")
    return {
        "zeta": torch.randn(3, 4, generator=g),
        "alpha": {"w": pw, "h": torch.randn(5, generator=g).to(torch.bfloat16)},
        "blocks": [torch.arange(4, dtype=torch.int32), (torch.randn(2, generator=g), None)],
    }


def _assert_same_tree(a, b):
    fa, fb = tmgr._flatten(a), tmgr._flatten(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k


def test_flatten_keys_match_reference():
    tree = _tree()
    jtree = {
        "zeta": np.zeros(1),
        "alpha": {"w": jops.PackedWeight(np.zeros(1, np.uint8), np.zeros(1, np.float32),
                                         "elp_bsd_a4", True, (9, 6)), "h": np.zeros(1)},
        "blocks": [np.zeros(1), (np.zeros(1), None)],
    }
    assert list(tmgr._flatten(tree)) == list(jmgr._flatten(jtree)[0]) == [
        "alpha/h", "alpha/w/.codes", "alpha/w/.sf", "blocks/0", "blocks/1/0", "zeta"]


def test_checkpoint_round_trip_keep_and_corrupt_step(tmp_path):
    mgr = tmgr.CheckpointManager(str(tmp_path), keep=2)
    trees = [_tree(s) for s in range(3)]
    for step, tree in enumerate(trees):
        mgr.save(step * 10, tree)
    assert mgr.all_steps() == [10, 20]
    step, back = mgr.restore_latest(_tree(9))
    assert step == 20
    _assert_same_tree(back, trees[2])
    assert isinstance(back["blocks"][1], tuple) and back["blocks"][1][1] is None
    # a corrupt newest step is skipped: the previous one restores
    with open(tmp_path / "step_0000000020" / "arrays.npz", "r+b") as f:
        f.seek(40)
        f.write(b"\xff" * 64)
    step, back = mgr.restore_latest(_tree(9))
    assert step == 10
    _assert_same_tree(back, trees[1])
    os.remove(tmp_path / "step_0000000010" / "manifest.json")
    assert mgr.restore_latest(_tree(9)) is None


def test_checkpoints_read_across_packages(tmp_path):
    tree = _tree(1)
    tmgr.CheckpointManager(str(tmp_path / "port"), keep=1).save(3, tree)
    jex = jax.tree.map(lambda t: np.zeros(1), {"zeta": 0, "alpha": {"h": 0}, "blocks": [0, (0,)]})
    jex["alpha"]["w"] = jops.PackedWeight(np.zeros(1, np.uint8), np.zeros(1, np.float32),
                                          "elp_bsd_a4", True, (9, 6))
    step, jback = jmgr.CheckpointManager(str(tmp_path / "port"), keep=1,
                                         async_save=False).restore_latest(jex)
    assert step == 3 and jback["alpha"]["h"].dtype == jnp.bfloat16
    for k, v in jmgr._flatten(jback)[0].items():
        want = tmgr._flatten(tree)[k]
        np.testing.assert_array_equal(np.asarray(v, np.float32), want.float().numpy())
    jm = jmgr.CheckpointManager(str(tmp_path / "jax"), keep=1, async_save=False)
    jm.save(5, jback)
    step, back = tmgr.CheckpointManager(str(tmp_path / "jax")).restore_latest(_tree(9))
    assert step == 5
    _assert_same_tree(back, tree)


@pytest.fixture(scope="module")
def jax_artifacts(tmp_path_factory):
    """ALEXNET_MINI with JAX-initialised weights, quantized and saved by the JAX
    package (float and static activations), and the same weights as numpy."""
    root = tmp_path_factory.mktemp("jax_artifacts")
    spec = jcnn.ALEXNET_MINI
    params = jcnn.init_params(spec, jax.random.PRNGKey(0))
    imgs = np.random.default_rng(0).normal(size=(2, 8, 32, 32, 3)).astype(np.float32)
    out = {"np": {k: np.asarray(v) for k, v in params.items()}, "imgs": imgs}
    for act in ("float", "static"):
        qm = japi.quantize(spec, params, japi.QuantScheme(fmt="elp_bsd_a4", act=act),
                           calib_data=jnp.asarray(imgs) if act == "static" else None)
        qm.save(str(root / act))
        out[act] = (str(root / act), qm)
    return out


def _x(n=6, seed=5):
    return np.random.default_rng(seed).normal(size=(n, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("act", ["float", "static"])
def test_jax_saved_artifact_loads_in_port(jax_artifacts, act):
    path, jq = jax_artifacts[act]
    tq = tapi.load(path, device="cpu")
    assert tq.scheme.to_json() == jq.scheme.to_json()
    assert tq.report.to_json() == jq.report.to_json()
    assert tq.adapter.spec == tcnn.ALEXNET_MINI
    for k, v in jq.params.items():
        if k.endswith("_w"):
            np.testing.assert_array_equal(tq.params[k].codes.numpy(), np.asarray(v.codes))
            assert tq.params[k].source_shape == v.source_shape
    if act == "static":
        assert tq.table.names() == jq.table.names()
        assert [s.amax for _, s in tq.table.sites] == [s.amax for _, s in jq.table.sites]
    x = _x()
    want = np.asarray(jq.forward(jnp.asarray(x)))
    got = tq.forward(x).numpy()
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    if act == "float":
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("act", ["float", "dynamic", "static"])
def test_port_round_trip_is_bit_identical_and_reads_in_jax(jax_artifacts, act, tmp_path):
    kw = {"calib_data": jax_artifacts["imgs"]} if act == "static" else {}
    qm = tapi.quantize(tcnn.ALEXNET_MINI, jax_artifacts["np"],
                       tapi.QuantScheme(fmt="elp_bsd_b7", act=act, act_bits=6), device="cpu", **kw)
    qm.save(str(tmp_path / "a"))
    back = tapi.QuantizedModel.load(str(tmp_path / "a"), device="cpu")
    _assert_same_tree(back.params, qm.params)
    assert (back.scheme, back.report, back.table) == (qm.scheme, qm.report, qm.table)
    x = _x()
    assert torch.equal(back.forward(x), qm.forward(x))
    jq = japi.load(str(tmp_path / "a"))
    assert jq.scheme.to_json() == qm.scheme.to_json()
    for k, v in jq.params.items():
        if k.endswith("_w"):
            np.testing.assert_array_equal(np.asarray(v.codes), qm.params[k].codes.numpy())


def _saved(jax_artifacts, tmp_path):
    qm = tapi.quantize(tcnn.ALEXNET_MINI, jax_artifacts["np"], tapi.QuantScheme(), device="cpu")
    path = str(tmp_path / "art")
    qm.save(path)
    return path


def _step_dir(path):
    return os.path.join(path, "params", "step_0000000000")


def test_flipped_byte_raises(jax_artifacts, tmp_path):
    path = _saved(jax_artifacts, tmp_path)
    npz = os.path.join(_step_dir(path), "arrays.npz")
    with np.load(npz) as z:
        arrs = {k: z[k].copy() for k in z.files}
    arrs["conv2_w__.codes"].reshape(-1)[7] ^= 0x10
    np.savez(npz, **arrs)
    with pytest.raises(tapi.ArtifactError, match="checksum mismatch for leaf 'conv2_w/.codes'"):
        tapi.load(path, device="cpu")


def test_missing_leaf_raises(jax_artifacts, tmp_path):
    path = _saved(jax_artifacts, tmp_path)
    mf = os.path.join(path, "manifest.json")
    with open(mf) as f:
        doc = json.load(f)
    doc["checksums"]["fc4_b/extra"] = "0" * 64
    with open(mf, "w") as f:
        json.dump(doc, f)
    with pytest.raises(tapi.ArtifactError, match="do not match the manifest"):
        tapi.load(path, device="cpu")
    del doc["checksums"]["fc4_b/extra"]
    del doc["tree"]["items"]["fc3_b"]
    with open(mf, "w") as f:
        json.dump(doc, f)
    with pytest.raises(tapi.ArtifactError, match="do not match the manifest"):
        tapi.load(path, device="cpu")


def test_wrong_version_missing_files_and_speculative_scheme_raise(jax_artifacts, tmp_path):
    path = _saved(jax_artifacts, tmp_path)
    mf = os.path.join(path, "manifest.json")
    with open(mf) as f:
        doc = json.load(f)
    for version in (2, None):
        with open(mf, "w") as f:
            json.dump({**doc, "format_version": version}, f)
        with pytest.raises(tapi.ArtifactError, match="format_version"):
            tapi.load(path, device="cpu")
    spec_scheme = dict(doc["scheme"], spec_verify="float", spec_k=4)
    with open(mf, "w") as f:
        json.dump({**doc, "scheme": spec_scheme}, f)
    with pytest.raises(tapi.ArtifactError, match="verify tier"):
        tapi.load(path, device="cpu")
    with open(mf, "w") as f:
        json.dump({**doc, "scheme": spec_scheme, "verify_tree": doc["tree"],
                   "verify_checksums": doc["checksums"]}, f)
    # a declared verify tier whose checkpoint is not there
    with pytest.raises(tapi.ArtifactError, match="verify-tier checkpoint"):
        tapi.load(path, device="cpu")
    with open(mf, "w") as f:
        json.dump(doc, f)
    os.remove(os.path.join(_step_dir(path), "arrays.npz"))
    with pytest.raises(tapi.ArtifactError, match="missing or unreadable"):
        tapi.load(path, device="cpu")
    os.remove(mf)
    with pytest.raises(tapi.ArtifactError, match="unreadable QuantizedModel manifest"):
        tapi.load(path, device="cpu")


def test_scheme_report_and_model_json_round_trip():
    s = tapi.QuantScheme(fmt="elp8", act="static", block_sizes=(64, 128, 256), ac=0.02)
    doc = s.to_json()
    assert doc == japi.QuantScheme.from_json(doc).to_json()
    assert tapi.QuantScheme.from_json(doc) == s
    with pytest.raises(ValueError, match="unknown QuantScheme fields"):
        tapi.QuantScheme.from_json({**doc, "bogus": 1})
    from repro_torch.api_schemes import CnnAdapter, LmAdapter
    from repro_torch.configs import get_config

    for spec in (tcnn.ALEXNET, tcnn.VGG_MINI):
        mj = CnnAdapter(spec).model_json()
        assert CnnAdapter.model_from_json(json.loads(json.dumps(mj))) == spec
        assert mj == japi.CnnAdapter(getattr(jcnn, spec.name.upper())).model_json()
    cfg = get_config("qwen3_8b")
    assert LmAdapter.model_from_json(json.loads(json.dumps(LmAdapter(cfg).model_json()))) == cfg
    r = tapi.ConversionReport("elp_bsd_a4", "dynamic", 6, 100, 20, 16, 12, 0.9, 0.85, 1.5)
    assert tapi.ConversionReport.from_json(json.loads(json.dumps(r.to_json()))) == r
    assert abs(r.accuracy_loss - 0.05) < 1e-12 and r.compression == 5.0


def test_new_entry_points_default_to_the_card(jax_artifacts, tmp_path, monkeypatch):
    """``load`` and the experiments' entry points run on the card unless asked for
    the CPU; without one they raise instead of carrying on on the host."""
    from repro_torch.experiments import common

    path = _saved(jax_artifacts, tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tapi.load(path), lambda: tapi.QuantizedModel.load(path),
                 lambda: common.make_eval_fn(tcnn.ALEXNET_MINI),
                 lambda: common.calib_images(tcnn.ALEXNET_MINI, n_batches=1),
                 lambda: common.train_mini_cnn(tcnn.ALEXNET_MINI, steps=1, cache=False)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert tapi.load(path, device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# LM artifacts with 4-D expert stacks and a frontend projection
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lm_models():
    """Reduced olmoe and internvl2: JAX params from a key, the same as numpy,
    calibration token batches and a forward batch (a frontend for internvl2)."""
    import torch_parity as tp
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget

    out = {}
    for arch in ("olmoe_1b_7b", "internvl2_26b"):
        jc, tc = jget(arch).reduced(), tget(arch).reduced()
        jp, tparams = tp.lm_params(jc)
        rng = np.random.default_rng(8)
        calib = rng.integers(0, jc.vocab, (2, 2, 16)).astype(np.int32)
        batch = {"tokens": rng.integers(0, jc.vocab, (2, 10)).astype(np.int32)}
        if jc.frontend_tokens:
            batch["frontend"] = rng.standard_normal(
                (2, jc.frontend_tokens, jc.d_model)).astype(np.float32)
        out[arch] = (jc, tc, jp, tparams, calib, batch)
    return out


def _lm_leaves_equal(tparams, jparams):
    want = jmgr._flatten(jparams)[0]
    got = tmgr._flatten(tparams)
    assert list(got) == list(want)
    for key, leaf in got.items():
        np.testing.assert_array_equal(tmgr.leaf_to_numpy(leaf), np.asarray(want[key]),
                                      err_msg=key)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "internvl2_26b"])
@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_lm_artifact_reads_across_packages(lm_models, arch, saved_by, tmp_path):
    """A packed static-act LM saved by either package loads in the other: every leaf
    (the [L, E, K', N] expert codes and [L, E, 1, 1] sf, frontend_proj) bit-identical,
    the stamped act scales equal, and the forward equal to the saving package's
    model carried across (port) or within 1e-4 of max |logit| (JAX, float32 sums
    in another order)."""
    from repro_torch.interop import params_from_numpy

    jc, tc, jp, tparams, calib, batch = lm_models[arch]
    kw = dict(fmt="elp_bsd_a4", act="static", act_bits=8)
    path = str(tmp_path / "lm")
    if saved_by == "jax":
        saved = japi.quantize(jc, jp, japi.QuantScheme(**kw), calib_data=jnp.asarray(calib))
        saved.save(path)
        tq = tapi.load(path, device="cpu")
        jq = saved
        carried = params_from_numpy(jax.tree.map(np.asarray, saved.params), device="cpu")
        assert torch.equal(tq.forward(batch), tq.adapter.forward(carried, batch))
    else:
        tq = tapi.quantize(tc, tparams, tapi.QuantScheme(**kw), calib_data=calib, device="cpu")
        tq.save(path)
        jq = japi.load(path)
        back = tapi.load(path, device="cpu")
        _assert_same_tree(back.params, tq.params)
        assert torch.equal(back.forward(batch), tq.forward(batch))
    assert tq.adapter.cfg == tc and jq.scheme.to_json() == tq.scheme.to_json()
    _lm_leaves_equal(tq.params, jq.params)
    if jc.is_moe:
        we1 = tq.params["blocks"]["we1"]
        assert we1.codes.ndim == 4 and tuple(we1.sf.shape) == (tc.n_layers, tc.n_experts, 1, 1)
    for name, leaf in tq.params["blocks"].items():
        if isinstance(leaf, tops.PackedWeight):
            want = jq.params["blocks"][name].act_scale
            assert leaf.act_scale == (None if want is None else pytest.approx(want)), name
    want = np.asarray(jq.forward({k: jnp.asarray(v) for k, v in batch.items()}))
    got = tq.forward(batch).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# ---------------------------------------------------------------------------
# The recurrent and enc-dec families: a4 codes, float activations
# ---------------------------------------------------------------------------
RECURRENT_ENCDEC = ("mamba2_780m", "recurrentgemma_2b", "seamless_m4t_large_v2")
# the float32 leaves of a bfloat16 model
F32_LEAVES = {"mamba2_780m": ("blocks", ("A_log", "D", "dt_bias")),
              "recurrentgemma_2b": ("rec", ("lam", "ba", "bx")),
              "seamless_m4t_large_v2": ("decoder", ())}


def _recurrent_batch(jc, seed=9):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, jc.vocab, (2, 10)).astype(np.int32)}
    if jc.family in ("encdec", "audio"):
        batch["frontend"] = rng.standard_normal((2, 10, jc.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", RECURRENT_ENCDEC)
@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_recurrent_encdec_artifact_reads_across_packages(arch, saved_by, tmp_path):
    """An a4 artifact (float activations) of reduced mamba2, recurrentgemma or
    seamless saved by either package loads in the other: every leaf
    bit-identical, and greedy ``generate`` gives the saving package's tokens."""
    import torch_parity as tp
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget

    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    jp, tparams = tp.lm_params(jc)
    kw = dict(fmt="elp_bsd_a4", act="float")
    path = str(tmp_path / "lm")
    batch = _recurrent_batch(jc)
    if saved_by == "jax":
        jq = japi.quantize(jc, jp, japi.QuantScheme(**kw))
        jq.save(path)
        tq = tapi.load(path, device="cpu")
    else:
        tq = tapi.quantize(tc, tparams, tapi.QuantScheme(**kw), device="cpu")
        tq.save(path)
        jq = japi.load(path)
        _assert_same_tree(tapi.load(path, device="cpu").params, tq.params)
    assert tq.adapter.cfg == tc
    _lm_leaves_equal(tq.params, jq.params)
    want = np.asarray(jq.generate({k: jnp.asarray(v) for k, v in batch.items()}, 4))
    np.testing.assert_array_equal(tq.generate(batch, 4).numpy(), want)


@pytest.mark.parametrize("arch", RECURRENT_ENCDEC)
def test_bf16_model_keeps_float32_leaves_across_packages(arch, tmp_path):
    """A bfloat16 model's float32 leaves stay float32, and its bfloat16 leaves stay
    bfloat16 bit for bit: carried across by ``params_from_numpy``, through the port's
    save and load, and as the JAX package reads the port's artifact."""
    import dataclasses

    from repro.configs import get_config as jget
    from repro.models import get_model as jget_model
    from repro_torch.configs import get_config as tget
    from repro_torch.interop import params_from_numpy

    jc = dataclasses.replace(jget(arch).reduced(), dtype_str="bfloat16")
    tc = dataclasses.replace(tget(arch).reduced(), dtype_str="bfloat16")
    jp = jget_model(jc).init_params(jc, jax.random.PRNGKey(1))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    want = jmgr._flatten(jp)[0]
    for key, leaf in tmgr._flatten(tparams).items():
        ref = np.asarray(want[key])
        if ref.dtype.name == "bfloat16":
            ref = ref.view(np.int16)  # leaf_to_numpy's view of a bfloat16 tensor
        np.testing.assert_array_equal(tmgr.leaf_to_numpy(leaf), ref, err_msg=key)
    group, names = F32_LEAVES[arch]
    for name, leaf in tparams[group].items():
        assert leaf.dtype == (torch.float32 if name in names else torch.bfloat16), name
    tq = tapi.quantize(tc, tparams, tapi.QuantScheme(fmt="elp_bsd_a4"), device="cpu")
    path = str(tmp_path / "bf16")
    tq.save(path)
    back = tapi.load(path, device="cpu")
    _assert_same_tree(back.params, tq.params)
    jq = japi.load(path)
    for key, leaf in jmgr._flatten(jq.params)[0].items():
        got = tmgr._flatten(back.params)[key]
        assert str(got.dtype).removeprefix("torch.") == str(leaf.dtype), key
    if arch == "mamba2_780m":
        from repro_torch.models import mamba2

        assert mamba2.init_state(tc, 2, device="cpu")[1].dtype == torch.float32

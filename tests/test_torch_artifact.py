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
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
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

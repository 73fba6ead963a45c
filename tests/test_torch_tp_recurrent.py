"""The recurrent and enc-dec families over a model axis of 4 ``gloo`` ranks
against the JAX package's GSPMD runs on 4 fake CPU devices.

One JAX subprocess (``--xla_force_host_platform_device_count=4``) and one
``torch.multiprocessing.spawn`` of 4 ranks (one torch thread a rank) run every
case on the same seeded numpy inputs (``tests/torch_tp_recurrent_ranks.py``):

* serving an ``ssm`` config (8 SSD heads, ``in_proj`` split across its
  segments), a ``hybrid`` one (rec, rec, attn; one KV head; the ring wraps past
  its window) and an ``audio`` one (vocab 63, 6 frames) on ``(1, 4)`` and
  ``(2, 2)`` (float weights) and on ``(1, 4)`` (a4 codes, float activations):
  the prefill and 4 greedy steps, each step's logits within 1e-5 of max
  |logit| of the reference's, its tokens and ``static_generate``'s equal to
  the reference's, each call's collectives by kind the counts that
  ``chip_smoke.py`` holds the card's runs to, each rank's blocks
  of the parameters and of the state of the shapes the layout gives;
* ``TrainSetup`` on ``(1, 4)`` for each config, for an ``ssm`` and a
  ``hybrid`` one whose conv channels (162) and recurrence width (66) the axis
  does not divide (every rank then runs them whole, and their gradients must
  be summed once), and on ``(2, 2)`` with ``seq_parallel`` for the ``audio``
  one, against the reference's
  single-device step on the whole batch: loss, learning rate and gradient norm
  within 1e-5 relative, the parameters after 2 steps within 1e-5 of each
  leaf's max |w|;
* ``launch.train`` and ``launch.serve --static`` on the reduced mamba2 config
  over the default model axis (16, halved to 4), every rank alike.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import chip_smoke  # noqa: E402
import torch_tp_recurrent_ranks as R  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
REL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch.multiprocessing as mp

    d = tmp_path_factory.mktemp("tp_recurrent")
    inputs = str(d / "inputs.npz")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        R.make_inputs(inputs)
    finally:
        torch.set_num_threads(n)
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={R.WORLD}",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    jax_out = str(d / "jax.npz")
    proc = subprocess.Popen([sys.executable, R.__file__, "jax", inputs, jax_out], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        mp.spawn(R.rank_main, args=(R.WORLD, str(d / "store"), inputs, str(d)), nprocs=R.WORLD,
                 join=True)
    finally:
        _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(R.WORLD)]
    return dict(np.load(jax_out)), ranks


def _close(got, want, rel, what=""):
    scale = np.abs(want).max()
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel:g} * {scale:.3e}"


@pytest.mark.parametrize("fam,scheme,mesh", R.SERVE_RUNS)
def test_serving_matches_jax(runs, fam, scheme, mesh):
    jx, ranks = runs
    key = f"serve/{fam}/{scheme}/{mesh}"
    nd, m = R.MESHES[mesh]
    # the counts chip_smoke.py holds the card's runs to, from the config's shapes
    prefill, step = chip_smoke._family_collectives(ArchConfig(**R.CONFIGS[fam]), m)
    for res in ranks:
        row0 = int(res[f"{key}/row0"])
        toks = res[f"{key}/tokens"]
        rows = slice(row0, row0 + toks.shape[0])
        assert toks.shape[0] == R.B // nd
        for i in range(R.STEPS + 1):
            got = res[f"{key}/logits{i}"]
            assert got.shape[-1] == R.CONFIGS[fam]["vocab"]
            _close(got, jx[f"{key}/logits{i}"][rows], REL, f"{key} step {i}")
        np.testing.assert_array_equal(toks, jx[f"{key}/tokens"][rows])
        np.testing.assert_array_equal(res[f"{key}/generated"], jx[f"{key}/tokens"])
        for kind in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all"):
            assert int(res[f"{key}/prefill_issued/{kind}"]) == prefill.get(kind, 0), (key, kind)
            assert int(res[f"{key}/steps_issued/{kind}"]) == R.STEPS * step.get(kind, 0), \
                (key, kind)


def test_blocks_take_the_rules_shapes(runs):
    """Each rank's blocks under the rules, and its state: mamba2's conv channels and
    SSD heads, the hybrid's recurrence channels and its ring's one KV head (whole
    on every rank), the enc-dec model's KV heads and feature-split embedding."""
    _, ranks = runs
    ssm, hyb, aud = (R.CONFIGS[f] for f in R.FAMILIES)
    for res in ranks:
        for mesh, (nd, m) in R.MESHES.items():
            b = R.B // nd

            def shape(fam, name):
                return list(res[f"serve/{fam}/float/{mesh}/{name}"])

            d_in = ssm["expand"] * ssm["d_model"]
            nh, st, L = d_in // ssm["ssm_head_dim"], ssm["ssm_state"], ssm["n_layers"]
            assert shape("ssm", "shape/params/blocks/in_proj") == [
                L, ssm["d_model"], (2 * d_in + 2 * st + nh) // m]
            assert shape("ssm", "shape/params/blocks/conv_w") == [
                L, ssm["conv_width"], (d_in + 2 * st) // m]
            assert shape("ssm", "shape/params/blocks/out_proj") == [L, d_in // m, ssm["d_model"]]
            assert shape("ssm", "state/conv") == [L, b, ssm["conv_width"] - 1, (d_in + 2 * st) // m]
            assert shape("ssm", "state/ssd") == [L, b, nh // m, ssm["ssm_head_dim"], st]
            lru, hd = hyb["lru_width"], hyb["head_dim"]
            assert shape("hybrid", "shape/params/rec/w_rec") == [2, hyb["d_model"], lru // m]
            assert shape("hybrid", "shape/params/rec/wa") == [2, lru, lru // m]
            assert shape("hybrid", "state/h") == [2, b, lru // m]
            assert shape("hybrid", "state/k") == [1, b, hyb["window"], 1, hd]
            assert shape("audio", "shape/params/decoder/xk") == [
                2, aud["d_model"], aud["n_kv_heads"] * aud["head_dim"] // m]
            assert shape("audio", "shape/params/embed") == [aud["vocab"], aud["d_model"] // m]
            assert shape("audio", "state/k") == [2, b, R.MAX_LEN, aud["n_kv_heads"] // m,
                                                 aud["head_dim"]]


@pytest.mark.parametrize("fam,mesh,sp", R.TRAIN_RUNS)
def test_train_step_matches_single_device(runs, fam, mesh, sp):
    jx, ranks = runs
    key0 = f"train/{fam}/{mesh}/{'sp' if sp else 'tp'}"
    prefix = f"train/{fam}/after/"
    want = {k[len(prefix):]: v for k, v in jx.items() if k.startswith(prefix)}
    for res in ranks:
        for i in range(R.TRAIN_STEPS):
            for key in ("loss", "lr", "gnorm"):
                np.testing.assert_allclose(res[f"{key0}/{key}{i}"], jx[f"train/{fam}/{key}{i}"],
                                           rtol=1e-5)
        after = {k.split("/after/")[1]: v for k, v in res.items()
                 if k.startswith(f"{key0}/after/")}
        assert sorted(after) == sorted(want)
        for k in want:
            _close(after[k], want[k], 1e-5, k)
            np.testing.assert_array_equal(after[k], ranks[0][f"{key0}/after/{k}"])
        # the products ran split: partial sums over the model axis, and the
        # sequence-parallel run's reduce-scatters
        assert int(res[f"{key0}/issued/all_reduce"]) > 0
        assert (int(res[f"{key0}/issued/reduce_scatter"]) > 0) == sp


def test_launchers_over_the_model_axis(runs):
    _, ranks = runs
    for res in ranks:
        np.testing.assert_array_equal(res["launch/train_mesh"], [1, R.WORLD])
        assert res["launch/train_losses"].shape == (1,)
        assert np.isfinite(res["launch/train_losses"]).all()
        np.testing.assert_array_equal(res["launch/train_losses"], ranks[0]["launch/train_losses"])
        assert res["launch/serve_tokens"].shape == (4, 3)
        np.testing.assert_array_equal(res["launch/serve_tokens"], ranks[0]["launch/serve_tokens"])
        assert int(res["issued/launch/all_gather"]) > 0  # the model axis split the products

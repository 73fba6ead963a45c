"""The port's mesh layer across 4 ``gloo`` ranks against the JAX package's
``shard_map`` on 4 fake CPU devices.

One JAX subprocess (``--xla_force_host_platform_device_count=4``) and one
``torch.multiprocessing.spawn`` of 4 ranks (a ``FileStore`` under the test's
temporary directory, one torch thread a rank) run every case on the same
seeded numpy inputs (``tests/torch_mesh_ranks.py``); the tests compare what
they wrote:

* ``moe_ep`` on ``(2, 2)`` and ``(1, 4)`` meshes: each shard's slots and drop
  mask bit-identical, the outputs within 1e-5 of max |y|; against the dense
  oracle at capacity factor 8 (no drops), and at 0.5 the output is exactly
  the partial sum of the kept choices' dense contributions;
* ``flash_decode_attention`` on ``(1, 4)`` and ``(2, 2)``: float and int8
  caches, scalar and ``[B]`` positions, a 3-query verify run, a window and
  ``block_s`` streaming, within 1e-5 of max |out|;
* ``compressed_mean`` (int8, elp4): each rank's codes and scales
  bit-identical, the means within 1e-6 of max |mean|;
* the data-parallel ZeRO-1 train step on ``(4, 1)`` and ``(2, 1)``, and an MoE
  LM's through the expert exchange on ``(2, 1)``, against the reference's
  single-device step on the whole batch: loss, learning rate and
  gradient norm within 1e-5 relative, the parameters after 2 steps within
  1e-5 of each leaf's max |w| (the tolerance of ``test_torch_train.py``'s
  one step, at the same AdamW eps of 1e-3);
* ``reshard``/``gather`` round trips (tensor-parallel and ZeRO-1 over
  ``("pod", "data")``) bit-identical, a checkpoint written by ``train`` on
  ``(2, 1)`` restored on ``(1, 1)`` equal, ``shard_batch`` slices, what
  was the boundary of the ported mesh paths (the engine over more than one
  rank, ROADMAP item 4c; mamba2, rglru and enc-dec on a model axis of more
  than one rank, item 4d: none raises), the defaults inside a group of 4 ranks
  (``ServeEngine(mesh="auto")`` serves without a mesh, the train launcher
  trains on a ``(1, 4)`` mesh), and the collectives each part issued.

The tensor-parallel paths themselves are ``tests/test_torch_tensor_parallel.py``'s.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_mesh_ranks as R  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the test runner puts several workers on
    one host, where oversubscribed torch threads slow small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch.multiprocessing as mp

    d = tmp_path_factory.mktemp("mesh")
    inputs = str(d / "inputs.npz")
    R.make_inputs(inputs)
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
    return dict(np.load(jax_out)), ranks, dict(np.load(inputs))


def _close(got, want, rel, what=""):
    scale = np.abs(want).max()
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel:g} * {scale:.3e}"


@pytest.mark.parametrize("mesh", list(R.MOE_MESHES))
@pytest.mark.parametrize("cap", list(R.MOE_CF))
def test_moe_ep_matches_jax(runs, mesh, cap):
    jx, ranks, _ = runs
    key = f"moe/{mesh}/{cap}"
    for res in ranks:
        r = int(res[f"{key}/shard"])
        np.testing.assert_array_equal(res[f"{key}/slot"], jx[f"{key}/slot{r}"])
        np.testing.assert_array_equal(res[f"{key}/dropped"], jx[f"{key}/dropped{r}"])
        out, row0 = res[f"{key}/out"], int(res[f"{key}/row0"])
        _close(out, jx[f"{key}/out"][row0:row0 + out.shape[0]], 1e-5, key)
    dropped = np.concatenate([jx[f"{key}/dropped{r}"] for r in range(R.WORLD)])
    assert dropped.any() == (cap == "tight")


@pytest.mark.parametrize("mesh", list(R.MOE_MESHES))
def test_moe_ep_against_dense(runs, mesh):
    """Ample capacity: the dense oracle. Tight: the partial sum of the kept choices."""
    jx, ranks, _ = runs
    gates, topi, y = jx["moe/gates"], jx["moe/topi"], jx["moe/expert_out"]
    k = topi.shape[1]
    key = f"moe/{mesh}/tight"
    kept = ~np.concatenate([jx[f"{key}/dropped{r}"] for r in range(R.WORLD)]).reshape(-1, k)
    toks = np.arange(topi.shape[0])[:, None]
    partial = (np.where(kept, gates, 0.0)[..., None] * y[topi, toks]).sum(1)
    assert 0 < (~kept).sum() < kept.size
    for res in ranks:
        for cap, want in (("ample", jx["moe/dense"]), ("tight", partial)):
            out, row0 = res[f"moe/{mesh}/{cap}/out"], int(res[f"moe/{mesh}/{cap}/row0"])
            _close(out, want[row0:row0 + out.shape[0]], 1e-5, f"{mesh} {cap}")


@pytest.mark.parametrize("mesh", list(R.FD_MESHES))
@pytest.mark.parametrize("case", list(R.FD_CASES))
def test_flash_decode_matches_jax(runs, mesh, case):
    jx, ranks, _ = runs
    key = f"fd/{mesh}/{case}/out"
    for res in ranks:
        out, row0 = res[key], int(res[f"fd/{mesh}/{case}/row0"])
        assert out.shape[1:] == jx[key].shape[1:]
        _close(out, jx[key][row0:row0 + out.shape[0]], 1e-5, key)


@pytest.mark.parametrize("codec", R.CODECS)
def test_compressed_mean_matches_jax(runs, codec):
    jx, ranks, _ = runs
    for res in ranks:
        r = int(res["cm/rank"])
        np.testing.assert_array_equal(res[f"cm/{codec}/codes"], jx[f"cm/{codec}/codes{r}"])
        np.testing.assert_array_equal(res[f"cm/{codec}/scales"], jx[f"cm/{codec}/scales{r}"])
        _close(res[f"cm/{codec}/mean"], jx[f"cm/{codec}/mean"][r], 1e-6, codec)


@pytest.mark.parametrize("model,mesh", R.TRAIN_CASES)
def test_zero1_train_step_matches_single_device(runs, model, mesh):
    jx, ranks, _ = runs
    n = int(mesh[0])
    key0 = f"train/{model}/{mesh}"
    held = [res for res in ranks if f"{key0}/loss0" in res]
    assert len(held) == n
    for res in held:
        for i in range(R.TRAIN_STEPS):
            for key in ("loss", "lr", "gnorm"):
                np.testing.assert_allclose(res[f"{key0}/{key}{i}"], jx[f"train/{model}/{key}{i}"],
                                           rtol=1e-5)
        after = {k.split("/after/")[1]: v for k, v in res.items() if k.startswith(f"{key0}/after/")}
        want = {k.split("/after/")[1]: v for k, v in jx.items()
                if k.startswith(f"train/{model}/after/")}
        assert sorted(after) == sorted(want)
        for k in want:
            _close(after[k], want[k], 1e-5, k)
            np.testing.assert_array_equal(after[k], held[0][f"{key0}/after/{k}"])
        # ZeRO-1: this rank keeps 1/n of wq's moments (the largest dim that divides)
        shape = res[f"{key0}/m_wq_shape"]
        assert np.prod(shape) * n == np.prod(want["blocks/wq"].shape)


def test_reshard_gather_round_trip(runs):
    _, ranks, inp = runs
    wq, embed = inp["train/dense/params/blocks/wq"], inp["train/dense/params/embed"]
    for res in ranks:
        assert bool(res["layout/tp_round_trip"]) and bool(res["layout/zero1_round_trip"])
        assert np.prod(res["layout/wq_local_shape"]) * 2 == wq.size  # over model 2
        assert np.prod(res["layout/embed_zero1_shape"]) * 4 == embed.size  # over pod x data


def test_checkpoint_saved_2x1_restored_1x1(runs):
    _, ranks, _ = runs
    assert int(ranks[0]["ckpt/step"]) == 2 and bool(ranks[0]["ckpt/equal"])
    losses = ranks[0]["ckpt/resumed_losses"]
    assert losses.shape == (2,) and np.isfinite(losses).all()
    assert all("ckpt/step" not in res for res in ranks[1:])
    assert int(ranks[0]["ckpt/m_wq_local_rows"]) * 2 == int(ranks[1]["ckpt/m_wq_local_rows"]) * 2


def test_shard_batch_slices(runs):
    from repro.configs.base import ArchConfig
    from repro.data.pipeline import LmDataset

    _, ranks, _ = runs
    tokens = LmDataset(ArchConfig(**R.LM_KW), seq_len=R.TRAIN_SEQ, batch=R.TRAIN_BATCH,
                       seed=0).np_batch(0)["tokens"]
    for res in ranks:
        d = int(res["layout/batch_rank"])
        np.testing.assert_array_equal(res["layout/batch_tokens"], tokens[d * 4:(d + 1) * 4])


def test_item_4b_raises(runs):
    """Items 4b, 4c and 4d are ported, and nothing raises for them: the recurrent
    and enc-dec families take a model axis of more than one rank (an enc-dec loss
    under the (2, 2) mesh's context on whole weights equals the meshless one). The
    engine over the 4 ranks of the (4, 1) mesh gives its meshless tokens on every
    rank."""
    _, ranks, _ = runs
    for res in ranks:
        for name in ("ssm", "hybrid", "encdec"):
            assert str(res[f"raises/{name}"]) == "", (name, res[f"raises/{name}"])
        np.testing.assert_allclose(res["raises/encdec_loss"], res["raises/encdec_meshless_loss"],
                                   rtol=1e-5)
        assert bool(res["raises/engine_same"])
        np.testing.assert_array_equal(res["raises/engine_tokens"],
                                      ranks[0]["raises/engine_tokens"])


def test_launch_defaults_in_a_group(runs):
    """Inside a group of 4 ranks the defaults run: ``mesh="auto"`` lays the elastic
    mesh over every rank and serves the meshless tokens, and the train launcher's
    default model axis (the reference's 16, halved until it divides 4) is a (1, 4)
    tensor-parallel mesh."""
    _, ranks, _ = runs
    for res in ranks:
        np.testing.assert_array_equal(res["defaults/serve_mesh"], [1, R.WORLD])
        assert res["defaults/serve_tokens"].shape == (3,)
        np.testing.assert_array_equal(res["defaults/serve_tokens"],
                                      res["defaults/serve_meshless_tokens"])
        np.testing.assert_array_equal(res["defaults/train_mesh"], [1, R.WORLD])
        assert res["defaults/train_losses"].shape == (1,)
        assert np.isfinite(res["defaults/train_losses"]).all()
        np.testing.assert_array_equal(res["defaults/train_losses"],
                                      ranks[0]["defaults/train_losses"])


def test_collectives_issued(runs):
    _, ranks, _ = runs
    for res in ranks:
        assert int(res["issued/moe/all_to_all"]) == 2 * len(R.MOE_MESHES) * len(R.MOE_CF)
        assert int(res["issued/moe/all_gather"]) == len(R.MOE_MESHES) * len(R.MOE_CF)
        assert int(res["issued/fd/all_reduce"]) == 2 * len(R.FD_MESHES) * len(R.FD_CASES)
        assert int(res["issued/cm/all_reduce"]) == len(R.CODECS)
        assert int(res["issued/train/all_reduce"]) > 0 and int(res["issued/train/all_gather"]) > 0
        assert (int(res["issued/train/all_to_all"]) > 0) == (int(res["rank"]) < 2)  # the MoE

"""The port's tensor parallelism over 4 ``gloo`` ranks against the JAX package's
GSPMD run on 4 fake CPU devices.

One JAX subprocess (``--xla_force_host_platform_device_count=4``) and one
``torch.multiprocessing.spawn`` of 4 ranks (a ``FileStore`` under the test's
temporary directory, one torch thread a rank) run every case on the same
seeded numpy inputs (``tests/torch_tp_ranks.py``); the tests compare what
they wrote:

* serving on ``(1, 4)`` and ``(2, 2)`` meshes (``R.SERVE_RUNS``),
  ``ServeSetup``'s prefill and 4 greedy steps for a dense config whose 2 KV
  heads do not divide 4 (with a vocab that divides the model axis and one,
  63, that divides neither), a top-2 MoE through the expert exchange and
  through the dense form, a ``vlm`` with patch embeddings, the a4 codes with
  static 8-bit activations and with float activations, the dense static
  int8 cache: each step's
  logits within 1e-5 of max |logit| (float; 5e-2 for static 8-bit
  activations, the port's caveat on static fake quant) of the reference's,
  its greedy tokens and
  ``static_generate``'s equal to the reference's, each rank's blocks of the
  shapes the rules give;
* the a4 codes with float activations in a wider bfloat16 config, (1, 4)
  against meshless teacher-forced in each package: the port's gap no larger
  than the reference's own (the card's float-activation control, ROADMAP
  queue 3);
* ``batch_generate`` of an ``ssm`` config on the data-only ``(4, 1)`` mesh
  equal to the reference's tokens;
* ``TrainSetup`` on ``(1, 4)`` and ``(2, 2)``, with and without
  ``seq_parallel``, against the reference's single-device step on the whole
  batch: loss, learning rate and gradient norm within 1e-5 relative, the
  parameters after 2 steps within 1e-5 of each leaf's max |w|; the
  sequence-parallel runs issue ``reduce_scatter`` s, the others none;
* a checkpoint written by ``train`` on ``(2, 2)`` restored on ``(1, 1)``
  equal;
* a nibble-packed weight at an odd K (63) resharded row-parallel: each
  rank's logical K (the pad row in the last rank's block), the summed
  partial products against the whole product, the gather back bit-identical;
* the launchers in the group: ``launch.train --seq-parallel`` on the
  default model axis (the reference's 16, halved to 4) and
  ``launch.serve --static`` over it, every rank with the same losses and
  tokens.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_tp_ranks as R  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
FLOAT_REL, STATIC_REL = 1e-5, 5e-2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch.multiprocessing as mp

    d = tmp_path_factory.mktemp("tp")
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
    return dict(np.load(jax_out)), ranks, dict(np.load(inputs))


def _close(got, want, rel, what=""):
    scale = np.abs(want).max()
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel:g} * {scale:.3e}"


@pytest.mark.parametrize("case,mesh", R.SERVE_RUNS)
def test_serving_matches_jax(runs, case, mesh):
    jx, ranks, _ = runs
    key = f"serve/{case}/{mesh}"
    rel = STATIC_REL if R.SERVE_CASES[case][1] == "a4" else FLOAT_REL
    for res in ranks:
        row0 = int(res[f"{key}/row0"])
        toks = res[f"{key}/tokens"]
        rows = slice(row0, row0 + toks.shape[0])
        assert toks.shape[0] == R.B // R.MESHES[mesh][0]
        for i in range(R.STEPS + 1):
            got = res[f"{key}/logits{i}"]
            assert got.shape[-1] == R.CONFIGS[R.SERVE_CASES[case][0]]["vocab"]
            _close(got, jx[f"{key}/logits{i}"][rows], rel, f"{key} step {i}")
        np.testing.assert_array_equal(toks, jx[f"{key}/tokens"][rows])
        np.testing.assert_array_equal(res[f"{key}/generated"], jx[f"{key}/tokens"])
        # the tensor-parallel path ran: partial sums over the model axis
        assert int(res[f"{key}/issued/all_reduce"]) > 0


def test_blocks_take_the_rules_shapes(runs):
    """Each rank's blocks: wq's columns and the KV heads it reads (2 KV heads over 4
    ranks: one each, shared by two ranks), and the packed wo's logical rows (twice
    its packed rows)."""
    _, ranks, _ = runs
    d = R.CONFIGS["dense"]
    hd, layers = d["head_dim"], d["n_layers"]
    for res in ranks:
        for mesh, (nd, m) in R.MESHES.items():
            key = f"serve/dense/{mesh}"
            np.testing.assert_array_equal(res[f"{key}/wq_shape"],
                                          [layers, d["d_model"], d["n_heads"] * hd // m])
            kv_loc = max(d["n_kv_heads"] // m, 1)
            np.testing.assert_array_equal(res[f"{key}/cache_shape"],
                                          [layers, R.B // nd, R.MAX_LEN, kv_loc, hd])
            k, n, rows = res[f"serve/dense_a4_static/{mesh}/wo_local"]
            assert (k, n) == (d["n_heads"] * hd // m, d["d_model"]) and k == 2 * rows


def test_ssm_data_only_mesh_matches_jax(runs):
    jx, ranks, _ = runs
    for res in ranks:
        np.testing.assert_array_equal(res["ssm/tokens"], jx["ssm/tokens"])
        assert int(res["issued/ssm/all_gather"]) == 1  # the rows' tokens, gathered once


@pytest.mark.parametrize("mesh,sp", R.TRAIN_CASES)
def test_train_step_matches_single_device(runs, mesh, sp):
    jx, ranks, _ = runs
    key0 = f"train/{mesh}/{'sp' if sp else 'tp'}"
    want = {k.split("/after/")[1]: v for k, v in jx.items() if k.startswith("train/after/")}
    for res in ranks:
        for i in range(R.TRAIN_STEPS):
            for key in ("loss", "lr", "gnorm"):
                np.testing.assert_allclose(res[f"{key0}/{key}{i}"], jx[f"train/{key}{i}"],
                                           rtol=1e-5)
        after = {k.split("/after/")[1]: v for k, v in res.items()
                 if k.startswith(f"{key0}/after/")}
        assert sorted(after) == sorted(want)
        for k in want:
            _close(after[k], want[k], 1e-5, k)
            np.testing.assert_array_equal(after[k], ranks[0][f"{key0}/after/{k}"])
        m = R.MESHES[mesh][1]
        d = R.CONFIGS["dense"]
        wq = [d["n_layers"], d["d_model"], d["n_heads"] * d["head_dim"]]
        np.testing.assert_array_equal(res[f"{key0}/wq_local"], [wq[0], wq[1], wq[2] // m])
        # ZeRO-1 on top: the moments of the rank's block, split over the data axis too
        assert np.prod(res[f"{key0}/m_wq_local"]) * R.WORLD == np.prod(wq)
        assert (int(res[f"{key0}/issued/reduce_scatter"]) > 0) == sp
        assert int(res[f"{key0}/issued/all_reduce"]) > 0


def test_checkpoint_saved_2x2_restored_1x1(runs):
    _, ranks, _ = runs
    assert int(ranks[0]["ckpt/step"]) == 2 and bool(ranks[0]["ckpt/equal"])
    assert int(ranks[0]["ckpt/n_leaves"]) > 0
    assert all("ckpt/step" not in res for res in ranks[1:])


def test_row_parallel_packed_weight_at_odd_k(runs):
    _, ranks, _ = runs
    for res in ranks:
        for mesh, (nd, m) in R.MESHES.items():
            rows = (R.ODD_K + 1) // 2 // m
            last = int(res["rank"]) % m == m - 1
            k_loc, codes_rows = res[f"odd/{mesh}/local"]
            assert codes_rows == rows and k_loc == 2 * rows - (1 if last else 0)
            assert str(res[f"odd/{mesh}/form"]) == "partial"
            assert float(res[f"odd/{mesh}/err"]) <= 1e-6
            assert bool(res[f"odd/{mesh}/round_trip"])


def test_launchers_over_the_model_axis(runs):
    _, ranks, _ = runs
    for res in ranks:
        np.testing.assert_array_equal(res["launch/train_mesh"], [1, R.WORLD])
        assert res["launch/train_losses"].shape == (1,)
        assert np.isfinite(res["launch/train_losses"]).all()
        np.testing.assert_array_equal(res["launch/train_losses"], ranks[0]["launch/train_losses"])
        assert int(res["issued/launch/reduce_scatter"]) > 0  # --seq-parallel took effect
        assert res["launch/serve_tokens"].shape == (4, 3)
        np.testing.assert_array_equal(res["launch/serve_tokens"], ranks[0]["launch/serve_tokens"])


def test_bf16_gap_against_meshless(runs):
    """A4 codes with float activations in a bfloat16 config of 4 layers at width
    256, teacher-forced on each package's meshless greedy tokens: the port's (1, 4)
    run parts from its meshless one (float32 sums in another order flip bf16
    roundings, which the layers carry on) by no more than the reference's GSPMD
    run parts from its own meshless one (both printed with ``-s``)."""
    jx, ranks, _ = runs
    port = [float(res["bf16/gap"]) for res in ranks]
    ref = float(jx["bf16/gap"])
    print(f"\nbf16 gap, (1, 4) against meshless, max |logit diff| / max |logit|: port "
          f"{port[0]:.3e} (every rank {port}), reference {ref:.3e}")
    assert port == [port[0]] * R.WORLD
    assert 0 < ref and port[0] <= ref

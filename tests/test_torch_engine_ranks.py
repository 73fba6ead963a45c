"""The port's continuous-batching engine over 4 ``gloo`` ranks against the JAX
package's engine on 4 fake CPU devices.

Two JAX subprocesses, one a model (``--xla_force_host_platform_device_count=4``),
and one ``torch.multiprocessing.spawn`` of 4 ranks (a ``FileStore`` under the test's
temporary directory, one torch thread a rank) run every case on the same
seeded numpy inputs (``tests/torch_engine_ranks.py``); the tests compare what
they wrote:

* ``ServeEngine`` on ``(1, 4)``, ``(2, 2)`` and ``(4, 1)`` meshes, reduced
  float32 qwen3 (2 KV heads, which do not divide 4) and olmoe, a staggered
  mixed-length trace of 6 requests into 4 slots: the dense cache, the paged
  static-int8 cache (page 4, a shared prefix), ngram and model-draft
  speculative decoding, and ``flash_decode=True`` on ``(1, 4)`` and
  ``(2, 2)``. Every rank's tokens equal the JAX engine's on the same mesh
  and the port's meshless engine's; prefix hits equal the reference's;
  each rank's cache block has its layout's shape; collectives are counted
  by kind, ``agree`` once a step;
* decode steps over flash-decode's sequence-sharded cache on ``(1, 4)``,
  the dense and the dynamic int8 cache, one token a row and a ``[B]``
  verify run: logits within 1e-5 of max |logit| of the reference's;
* a rank given a different ``submit``: every rank raises
  ``ScheduleDisagreement`` at its first step, in seconds;
* ``launch.serve``'s engine path and ``QuantizedModel.serve(mesh="auto")``
  inside the group: the same tokens on every rank;
* the a4 tree with static 8-bit activations on ``(1, 4)``: the reference's
  tokens.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_engine_ranks as R  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
FD_REL = 1e-5
CASES = [(arch, run, mesh) for arch in R.ARCHS for run, (_, meshes, _) in R.PORT_RUNS.items()
         for mesh in R.meshes_of(arch, run, meshes)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch.multiprocessing as mp

    d = tmp_path_factory.mktemp("engine_ranks")
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
    procs = {arch: subprocess.Popen(
        [sys.executable, R.__file__, "jax", inputs, str(d / f"jax_{arch}.npz"), arch], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for arch in R.ARCHS}
    try:
        mp.spawn(R.rank_main, args=(R.WORLD, str(d / "store"), inputs, str(d)), nprocs=R.WORLD,
                 join=True)
    finally:
        errs = {arch: proc.communicate(timeout=600)[1] for arch, proc in procs.items()}
    jx = {}
    for arch, proc in procs.items():
        assert proc.returncode == 0, errs[arch][-3000:]
        jx.update(np.load(d / f"jax_{arch}.npz"))
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(R.WORLD)]
    return jx, ranks


def _tokens(res, key):
    return [res[f"{key}/{i}"] for i in range(len(R.TRACE))]


@pytest.mark.parametrize("arch,run,mesh", CASES)
def test_engine_matches_jax_and_meshless(runs, arch, run, mesh):
    jx, ranks = runs
    ref = R.PORT_RUNS[run][2]
    want = _tokens(jx, f"{arch}/{ref}/{mesh}")
    for res in ranks:
        key = f"{arch}/{run}/{mesh}"
        got, meshless = _tokens(res, key), _tokens(res, f"{arch}/{run}/none")
        for i, (g, w, p) in enumerate(zip(got, want, meshless)):
            assert len(g) == R.TRACE[i][1]
            np.testing.assert_array_equal(g, w, err_msg=f"{key} request {i} vs JAX")
            np.testing.assert_array_equal(g, p, err_msg=f"{key} request {i} vs meshless")
        np.testing.assert_array_equal(res[f"{key}/mesh"], R.MESHES[mesh])
        if run == "paged":
            assert int(res[f"{key}/prefix_hits"]) == int(jx[f"{arch}/paged/{mesh}/prefix_hits"])
            assert int(res[f"{key}/prefix_hits"]) > 0
        # one agreement a step, nothing else of its kind; the model axis' sums and
        # a dense admission's logits from its row's holders (a paged one runs on
        # every rank)
        steps = int(res[f"{key}/steps"])
        assert int(res[f"{key}/issued/agree"]) == steps
        nd, m = R.MESHES[mesh]
        assert (int(res[f"{key}/issued/all_reduce"]) > 0) == (m > 1 or (nd > 1
                                                                       and run != "paged"))
        if nd > 1:  # the rows' tokens gathered over the data axis
            assert int(res[f"{key}/issued/all_gather"]) > 0
        assert (int(res[f"{key}/issued/all_to_all"]) > 0) == (arch == "olmoe_1b_7b")
        assert not any(int(res[f"{arch}/{run}/none/issued/{k}"])
                       for k in ("all_reduce", "all_gather", "agree", "all_to_all"))


@pytest.mark.parametrize("arch,run,mesh", [c for c in CASES if c[1] in ("dense", "paged",
                                                                        "flash")])
def test_cache_blocks_take_their_layout(runs, arch, run, mesh):
    """A dense cache keeps the rank's rows and KV heads, or with flash-decode on a
    model axis every KV head for its block of the positions; a paged pool is whole
    over the data axis and keeps the rank's KV heads."""
    _, ranks = runs
    cfg = R.config(arch)
    nd, m = R.MESHES[mesh]
    kv = max(cfg.n_kv_heads // m, 1)
    for res in ranks:
        key = f"{arch}/{run}/{mesh}"
        lo, hi = res[f"{key}/rows"]
        assert hi - lo == R.N_SLOTS // nd
        shape = list(res[f"{key}/cache_shape"])
        if run == "paged":
            pmax = -(-R.MAX_LEN // R.PAGE)
            want = [cfg.n_layers, R.N_SLOTS * pmax + R.N_SLOTS, R.PAGE, kv, cfg.hd]
        elif run == "flash" and m > 1:
            want = [cfg.n_layers, R.N_SLOTS // nd, R.MAX_LEN // m, cfg.n_kv_heads, cfg.hd]
        else:
            want = [cfg.n_layers, R.N_SLOTS // nd, R.MAX_LEN, kv, cfg.hd]
        assert shape == want, (key, shape, want)


@pytest.mark.parametrize("kind", R.FD_CACHES)
def test_tp_flash_decode_matches_jax(runs, kind):
    jx, ranks = runs
    cfg = R.config("qwen3_8b")
    for res in ranks:
        np.testing.assert_array_equal(res[f"fd/{kind}/cache_shape"][1:4],
                                      [R.N_SLOTS, R.MAX_LEN // R.WORLD, cfg.n_kv_heads])
        for name in [f"step{i}" for i in range(R.FD_STEPS)] + ["verify"]:
            want = jx[f"fd/{kind}/{name}"]
            got = res[f"fd/{kind}/{name}"]
            assert got.shape == want.shape
            err = np.abs(got.astype(np.float64) - want).max()
            assert err <= FD_REL * np.abs(want).max(), (kind, name, err)
        # a step: the statistics' max and sum a layer, the embedding's and the
        # row-parallel products' sums; the heads and the head's vocab gathered
        issued = {k: int(res[f"fd/{kind}/step_issued/{k}"]) for k in
                  ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")}
        assert issued["all_reduce"] >= 2 * cfg.n_layers and issued["all_gather"] > 0
        assert issued["reduce_scatter"] == issued["all_to_all"] == 0


def test_divergent_submit_raises_the_agreement_error(runs):
    _, ranks = runs
    for res in ranks:
        assert str(res["diverge/error"]).startswith("ScheduleDisagreement"), res["diverge/error"]
        assert int(res["diverge/steps"]) == 0 and float(res["diverge/s"]) < 10.0


def test_entry_points_serve_over_the_group(runs):
    """``launch.serve``'s engine path over the world mesh and
    ``QuantizedModel.serve(mesh="auto")``: a (1, 4) mesh, every rank's tokens the
    same, the auto-meshed artifact's those of serving it without a mesh."""
    _, ranks = runs
    for res in ranks:
        np.testing.assert_array_equal(res["entry/launch_mesh"], [1, R.WORLD])
        for i in range(len(R.TRACE)):
            np.testing.assert_array_equal(res[f"entry/serve_auto/{i}"],
                                          res[f"entry/serve_none/{i}"])
            np.testing.assert_array_equal(res[f"entry/serve_auto/{i}"],
                                          ranks[0][f"entry/serve_auto/{i}"])
        launched = sorted(k for k in res if k.startswith("entry/launch/"))
        assert launched
        for k in launched:
            np.testing.assert_array_equal(res[k], ranks[0][k])


def test_a4_static_engine_matches_jax(runs):
    """The a4 tree with static 8-bit activations on (1, 4): the reference's tokens
    (no near-tie parts them on this trace)."""
    jx, ranks = runs
    for res in ranks:
        for i in range(len(R.TRACE)):
            np.testing.assert_array_equal(res[f"qwen3_8b/a4/{R.A4_MESH}/{i}"],
                                          jx[f"qwen3_8b/a4/{R.A4_MESH}/{i}"])
            np.testing.assert_array_equal(res[f"qwen3_8b/a4/{R.A4_MESH}/{i}"],
                                          res[f"qwen3_8b/a4/none/{i}"])

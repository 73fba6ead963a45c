"""LM training in the port against the JAX package, on the CPU.

* Each family's loss through ``ModelApi.loss_fn`` at its ``reduced()`` config
  (2 layers; 3 for the hybrid's period; float32), the same weights (a JAX
  key, carried across as numpy) and the same ``LmDataset`` batch: the loss
  within 1e-5 relative and every gradient leaf within 1e-4 of its largest
  |g| against ``jax.value_and_grad`` (float32 sums in another order through
  the backward pass).
* ``moe.load_balance_loss`` (the reference defines it; its loss path does not
  call it) within 1e-6 relative, its gradient within 1e-5 of max |g|.
* ``remat`` on gives the loss and gradients of remat off, bit for bit
  (recomputation repeats the same float32 operations).
* One ``make_train_step`` step with ``mesh=None`` against the reference's
  step: loss, learning rate and
  gradient norm within 1e-5 relative, the new parameters within 1e-5 of
  each leaf's max |w|. AdamW's first step moves each weight by about
  ``lr * g / (|g| + eps)``; at the default ``eps`` of 1e-8 a gradient of
  that size turns its float32 noise into an update difference of order
  ``lr`` (1.1e-4 of max |w| read on ``w1``), so the step runs at ``eps``
  1e-3, which bounds that difference by ``lr * noise / eps``. (A compressed
  step is not held here: the int8 and elp4 roundings are discontinuous, so
  gradient noise at a rounding boundary moves a code by a whole step; the
  codecs are held bit-identical on equal inputs in test_torch_optim.py.)
* ``train`` with checkpoints every 2 steps, stopped at 4 and resumed to 6,
  gives the straight run's losses exactly, and records the obs metrics.
  (The error-feedback state of ``compress`` is not checkpointed, in either
  package, so a compressed run resumes from a zero error.)
* The kernel wrappers refuse inputs that require grad while grad mode is
  on (they have no backward), on the CPU path as on the card; the training
  forward never reaches them (``attn_impl="reference"``, float weights).
* The checkpoint writer thread: a save returns before the write, writes the
  values as they were when save was called, and ``wait()`` raises what the
  writer raised.
* ``lm_ptq`` rows on ``lm-ptq`` trained 3 steps by the port's trainer, the
  same weights in both packages (the reference's ``quantize_model`` calls
  under ``jax.jit``): every loss within 1e-5 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.data.pipeline import LmDataset as JLm  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.runtime import train_loop as jtl  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.data.pipeline import shard_batch  # noqa: E402
from repro_torch.models import get_model as tget_model  # noqa: E402
from repro_torch.obs.metrics import Registry  # noqa: E402
from repro_torch.runtime import train_loop as ttl  # noqa: E402

FAMILY_ARCHS = {"dense": "qwen3_8b", "moe": "olmoe_1b_7b", "vlm": "internvl2_26b",
                "ssm": "mamba2_780m", "hybrid": "recurrentgemma_2b",
                "audio": "seamless_m4t_large_v2"}
SEQ, BATCH = 24, 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the test runner puts several workers on
    one host, and oversubscribed torch threads made these small ops 20-50x
    slower (the lm_ptq case: 12 s alone, 222 s beside five other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _close_tree(got, want, rel):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        gv = g[k].detach().float().numpy() if isinstance(g[k], torch.Tensor) else g[k]
        wv = np.asarray(w[k], np.float32)
        err = float(np.abs(gv - wv).max()) if wv.size else 0.0
        assert err <= rel * max(float(np.abs(wv).max()), 1e-30), (k, err, np.abs(wv).max())


def _port_loss_and_grads(params, tc, batch, remat):
    api = tget_model(tc)
    p = {k: v for k, v in _flat(params).items()}
    for v in p.values():
        v.requires_grad_(True)
    loss = api.loss_fn(params, tc, batch, remat=remat)
    grads = torch.autograd.grad(loss, list(p.values()))
    for v in p.values():
        v.requires_grad_(False)
    return loss.detach(), dict(zip(p, grads))


@pytest.fixture(scope="module")
def family_case():
    cache = {}

    def get(family):
        if family not in cache:
            arch = FAMILY_ARCHS[family]
            jc, tc = jget(arch).reduced(), tget(arch).reduced()
            jp, tparams = tp.lm_params(jc)
            nb = JLm(jc, seq_len=SEQ, batch=BATCH, seed=3).np_batch(0)
            jb = {k: jnp.asarray(v) for k, v in nb.items()}
            japi = jget_model(jc)
            jl, jg = jax.jit(jax.value_and_grad(
                lambda p: japi.loss_fn(p, jc, jb, remat=False)))(jp)
            cache[family] = (tc, tparams, shard_batch(nb, device="cpu"), float(jl), jg)
        return cache[family]

    return get


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_family_loss_and_grads_match_reference(family_case, family):
    tc, tparams, batch, jl, jg = family_case(family)
    assert tc.family == family
    loss, grads = _port_loss_and_grads(tparams, tc, batch, remat=False)
    np.testing.assert_allclose(float(loss), jl, rtol=1e-5)
    _close_tree(grads, _flat(jax.tree.map(np.asarray, jg)), 1e-4)


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid", "audio"])
def test_remat_matches_no_remat(family_case, family):
    tc, tparams, batch, _, _ = family_case(family)
    l0, g0 = _port_loss_and_grads(tparams, tc, batch, remat=False)
    l1, g1 = _port_loss_and_grads(tparams, tc, batch, remat=True)
    assert float(l0) == float(l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_train_step_matches_reference(family_case):
    import dataclasses

    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw as tadamw

    tc, _, batch, _, _ = family_case("dense")
    jc = jget("qwen3_8b").reduced()
    jp, tparams = tp.lm_params(jc, seed=1)
    kw = dict(lr_peak=1e-2, warmup=0, total_steps=10, remat=True)
    jsetup = jtl.TrainSetup(cfg=jc, mesh=None, adamw_cfg=jadamw.AdamWConfig(eps=1e-3), **kw)
    tsetup = ttl.TrainSetup(cfg=tc, mesh=None, adamw_cfg=tadamw.AdamWConfig(eps=1e-3), **kw)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jout = jax.jit(jtl.make_train_step(jsetup))(jp, jadamw.init_state(jp), None, jb)
    tout = ttl.make_train_step(tsetup)(tparams, tadamw.init_state(tparams), None, batch)
    for key in ("loss", "lr", "gnorm"):
        np.testing.assert_allclose(float(tout[3][key]), float(jout[3][key]), rtol=1e-5)
    _close_tree(_flat(tout[0]), _flat(jax.tree.map(np.asarray, jout[0])), 1e-5)
    assert int(tout[1]["step"]) == 1
    # data and tensor parallel over a mesh: test_torch_distributed.py,
    # test_torch_tensor_parallel.py and, for the ssm, hybrid and enc-dec families,
    # test_torch_tp_recurrent.py
    assert dataclasses.replace(tsetup, mesh=tp.TwoRankMesh()).pctx().model_size == 2
    ssm = dataclasses.replace(tsetup, cfg=family_case("ssm")[0], mesh=tp.TwoRankMesh())
    assert ssm.pctx().model_size == 2


def test_train_resume_equals_straight_run(tmp_path):
    import dataclasses

    _, tc = tp.lm_configs("gqa")
    setup = ttl.TrainSetup(cfg=tc, lr_peak=3e-3, warmup=2, total_steps=6, remat=True)
    kw = dict(batch_size=2, seq_len=16, log_every=100, log_fn=lambda s: None, device="cpu")
    reg = Registry(enabled=True)
    straight = ttl.train(setup, steps=6, metrics=reg, **kw)
    for codec in ("int8", "elp4"):
        run = ttl.train(dataclasses.replace(setup, compress=codec), steps=2, **kw)
        assert all(np.isfinite(run["losses"])) and run["losses"][0] == straight["losses"][0]
    assert reg.counter("train.steps_total").value == 6
    assert reg.histogram("train.step_s").count == 6
    assert reg.gauge("train.loss").value == straight["losses"][-1]
    assert straight["straggler_report"]
    logs = []
    first = ttl.train(setup, steps=4, ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    assert first["losses"] == straight["losses"][:4]
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4]
    resumed = ttl.train(setup, steps=6, ckpt_dir=str(tmp_path), ckpt_every=2,
                        **{**kw, "log_fn": logs.append})
    assert logs[0] == "[resume] restored step 4"
    assert resumed["losses"] == straight["losses"][4:]
    for k, v in _flat(straight["params"]).items():
        assert torch.equal(_flat(resumed["params"])[k], v), k


def test_async_checkpoint_writer(tmp_path, monkeypatch):
    import repro_torch.checkpoint.manager as mgr_mod

    mgr = CheckpointManager(str(tmp_path), keep=0, async_save=True)
    tree = {"w": torch.arange(6, dtype=torch.float32), "b": torch.ones(2, dtype=torch.bfloat16)}
    mgr.save(1, tree)
    tree["w"].add_(100.0)  # an optimizer step updating in place while the writer runs
    mgr.wait()
    step, back = mgr.restore_latest(tree)
    assert step == 1 and torch.equal(back["w"], torch.arange(6, dtype=torch.float32))
    assert back["b"].dtype == torch.bfloat16

    def fail(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(mgr_mod.np, "savez", fail)
    mgr.save(2, tree)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()  # the error is raised once
    assert mgr.all_steps() == [1]


def test_lm_ptq_rows_match_reference(monkeypatch):
    from benchmarks import lm_ptq as jlm
    from repro_torch.experiments import lm_ptq as tlm

    assert {**tlm.CFG.__dict__, "dtype_str": None} == {**jlm.CFG.__dict__, "dtype_str": None}
    res = ttl.train(ttl.TrainSetup(cfg=tlm.CFG, lr_peak=3e-3, warmup=20, total_steps=200,
                                   remat=False),
                    steps=3, batch_size=16, seq_len=64, log_fn=lambda s: None, device="cpu")
    trained = jax.tree.map(jnp.asarray, {"p": res["params"]},
                           is_leaf=lambda t: isinstance(t, torch.Tensor))["p"]

    def jitted_quantize_model(weights, group_axes, fmt, *, compensate):
        # the same ops under one jax.jit: one compile instead of one per eager op
        fn = jax.jit(lambda w: real_quantize(w, group_axes, fmt, compensate=compensate)[0])
        return fn(weights), None

    real_quantize = jlm.quantize_model
    monkeypatch.setattr(jlm, "train", lambda setup, **kw: {"params": trained})
    monkeypatch.setattr(jlm, "quantize_model", jitted_quantize_model)
    jbase, jrows = jlm.run()
    tbase, trows = tlm.run(params=res["params"], device="cpu")
    np.testing.assert_allclose(tbase, jbase, rtol=1e-5)
    assert sorted(trows) == sorted(jrows)
    for fmt, r in jrows.items():
        for key, want in r.items():
            np.testing.assert_allclose(trows[fmt][key], want, rtol=1e-5, err_msg=f"{fmt} {key}")


@pytest.mark.parametrize("name", ["elp_bsd_matmul", "fused_decode_matmul", "flash_attention"])
def test_kernel_wrappers_refuse_inputs_that_require_grad(name):
    from repro_torch.core.elp_bsd import PRESET_FORMATS
    from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_decode import fused_decode_matmul

    fmt = PRESET_FORMATS["elp_bsd_a4"]
    codes = torch.randint(0, 256, (8, 4), dtype=torch.uint8)
    q = torch.randn(1, 2, 128, 8)
    call = {"elp_bsd_matmul": lambda t: elp_bsd_matmul(t, codes, 0.5, fmt, nibble=True),
            "fused_decode_matmul": lambda t: fused_decode_matmul(t, codes, 0.5, fmt, nibble=True),
            "flash_attention": lambda t: flash_attention(t, q, q)}[name]
    x = (q if name == "flash_attention" else torch.randn(3, 16)).clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match=f"{name} has no backward"):
        call(x)
    with torch.no_grad():
        want = call(x)
    torch.testing.assert_close(call(x.detach()), want, rtol=0, atol=0)


def test_moe_load_balance_loss_matches_reference():
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe

    rng = np.random.default_rng(7)
    x = rng.normal(size=(40, 16)).astype(np.float32)
    router = rng.normal(size=(16, 8)).astype(np.float32)
    jl, jg = jax.value_and_grad(lambda r: jmoe.load_balance_loss(jnp.asarray(x), r, 2, 8))(
        jnp.asarray(router))
    tr = torch.from_numpy(router).requires_grad_(True)
    tl = tmoe.load_balance_loss(torch.from_numpy(x), tr, 2, 8)
    (tg,) = torch.autograd.grad(tl, [tr])
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(jg)).max()))

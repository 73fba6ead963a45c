"""Shared helpers for the parity tests (``test_torch_*.py``).

:func:`run_slice` runs one CNN spec through both packages on the CPU: JAX
parameters from a fixed key carried across as numpy, then
``api.quantize(act="static")`` in each package on the same numpy
calibration images, then each packed model's forward on the same numpy
batch. The LM helpers give both packages the same decoder-LM configs and
the same weights.
"""
import contextlib

import numpy as np


def run_slice(spec_name: str, *, act: str = "static") -> dict:
    import jax
    import jax.numpy as jnp
    import torch

    from repro import api as japi
    from repro.models import cnn as jcnn
    from repro_torch import api as tapi
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import cnn as tcnn

    jspec, tspec = getattr(jcnn, spec_name), getattr(tcnn, spec_name)
    jparams = jcnn.init_params(jspec, jax.random.PRNGKey(0))
    npparams = {k: np.asarray(v) for k, v in jparams.items()}
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(2, 8, 32, 32, 3)).astype(np.float32)
    x = rng.normal(size=(6, 32, 32, 3)).astype(np.float32)
    kw = dict(fmt="elp_bsd_a4", act=act, act_bits=8)
    jq = japi.quantize(jspec, jparams, japi.QuantScheme(**kw), calib_data=jnp.asarray(imgs))
    tparams = params_from_numpy(npparams, device="cpu")
    tq = tapi.quantize(tspec, tparams, tapi.QuantScheme(**kw), calib_data=imgs, device="cpu")
    return {
        "jq": jq,
        "tq": tq,
        "x": x,
        # jitted: one compile instead of one per eager op (same XLA ops)
        "j_logits": np.asarray(jax.jit(lambda q, v: q.forward(v))(jq, jnp.asarray(x))),
        "t_logits": tq.forward(x).numpy(),
        "j_float": np.asarray(jax.jit(lambda p, v: jcnn.forward(p, jspec, v))(jparams,
                                                                          jnp.asarray(x))),
        "t_float": tcnn.forward(tparams, tspec, torch.from_numpy(x)).numpy(),
    }



@contextlib.contextmanager
def cpu_group():
    """The default process group for a block: a one-rank ``gloo`` group
    (``elastic.ensure_group``), destroyed on exit when the block started it, so
    no group outlives its test in the runner's worker."""
    import torch.distributed as dist

    from repro_torch.runtime.elastic import ensure_group

    ours = not dist.is_initialized()
    ensure_group("cpu")
    try:
        yield dist.group.WORLD
    finally:
        if ours:
            dist.destroy_process_group()


class TwoRankMesh:
    """A (1, 2) ("data", "model") mesh as the port's setups, rules and MoE read it
    before any collective: its axis names and sizes, its rank count and the
    coordinate of its model rank ``rank``."""

    mesh_dim_names, shape = ("data", "model"), (1, 2)

    def __init__(self, rank: int = 0):
        self.rank = rank

    def size(self):
        return 2

    def get_coordinate(self):
        return [0, self.rank]


# ---------------------------------------------------------------------------
# Decoder LMs
# ---------------------------------------------------------------------------
# The GQA config of tests/test_calib.py (2 layers, d_model 32, heads 4/2, f32).
GQA_KW = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
              d_ff=64, vocab=64, head_dim=8, dtype_str="float32")
LM_CONFIGS = {
    "gqa": GQA_KW,
    "gqa_qknorm": dict(GQA_KW, name="t-qk", qk_norm=True),
    "qwen3_8b_reduced": "qwen3_8b",
}


def lm_configs(which: str):
    """(JAX ArchConfig, port ArchConfig) of one entry of LM_CONFIGS."""
    from repro.configs import get_config as jget
    from repro.configs.base import ArchConfig as JCfg
    from repro_torch.configs import get_config as tget
    from repro_torch.configs.base import ArchConfig as TCfg

    spec = LM_CONFIGS[which]
    if isinstance(spec, str):
        return jget(spec).reduced(), tget(spec).reduced()
    return JCfg(**spec), TCfg(**spec)


def lm_params(jcfg, seed: int = 0):
    """JAX LM params from a fixed key, and the same tree carried across to the port (CPU)."""
    import jax

    from repro.models import get_model
    from repro_torch.interop import params_from_numpy

    jp = get_model(jcfg).init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def packed_to_numpy(tree):
    """A JAX (packed) tree with numpy leaves; PackedWeights stay records of numpy codes/sf."""
    import jax

    return jax.tree.map(np.asarray, tree)


def jax_pack_lm(jparams, jcfg, fmt="elp_bsd_a4", *, compensate=True, calib=None):
    """The JAX package's ``pack_lm_params`` under one ``jax.jit`` (the same ops as eager,
    one compile instead of one per op and shape)."""
    import jax

    from repro.api_schemes import pack_lm_params

    return jax.jit(lambda p: pack_lm_params(p, jcfg, fmt, compensate=compensate,
                                            calib=calib))(jparams)


# ---------------------------------------------------------------------------
# Trained mini CNNs (the Sec. V search and the Fig. 15 experiments)
# ---------------------------------------------------------------------------
def jax_trained_mini(spec_name: str, steps: int, results_dir) -> dict:
    """The JAX package's ``benchmarks.common.train_mini_cnn`` at ``steps`` (its seed
    and lr), cached under ``results_dir`` instead of ``benchmarks/results``;
    numpy params."""
    from benchmarks import common
    from repro.models import cnn as jcnn

    saved = common.RESULTS
    common.RESULTS = str(results_dir)
    try:
        params = common.train_mini_cnn(getattr(jcnn, spec_name), steps=steps)
    finally:
        common.RESULTS = saved
    return {k: np.asarray(v) for k, v in params.items()}


# ---------------------------------------------------------------------------
# Non-causal flash attention at a ragged key count
# ---------------------------------------------------------------------------
def check_noncausal_ragged_flash(seed: int, b: int, h: int, kvh: int, sq: int, sk: int, hd: int,
                                 block_k: int):
    """Non-causal ``flash_attention`` on the CPU (the plain version) with ``sk`` keys,
    a count that does not tile by the port's 128-row block, against the JAX Pallas
    kernel in interpret mode (heads repeated for it; ``block_k`` divides ``sk``)
    within 2e-5 (float32 sums in another order). Then the control: the same keys
    padded with zero rows to the block give a result far off, so what the check
    holds is the key mask."""
    import jax.numpy as jnp
    import torch

    from repro.kernels.flash_attention import flash_attention as jflash
    from repro_torch.kernels.flash_attention import flash_attention

    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, sq, hd)).astype(np.float32)
    k, v = (rng.normal(size=(b, kvh, sk, hd)).astype(np.float32) for _ in range(2))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False)
    rep = lambda t: jnp.repeat(jnp.asarray(t), h // kvh, axis=1)  # noqa: E731
    want = np.asarray(jflash(jnp.asarray(q), rep(k), rep(v), causal=False, block_q=sq,
                             block_k=block_k, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    pad = (-sk) % 128
    kp, vp = (torch.cat([torch.from_numpy(t), torch.zeros(b, kvh, pad, hd)], 2) for t in (k, v))
    padded = flash_attention(torch.from_numpy(q), kp, vp, causal=False)
    assert (padded - got).abs().max().item() > 100 * 2e-5 * got.abs().max().item()

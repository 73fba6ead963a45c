"""Shared helpers for the parity tests (``test_torch_*.py``).

:func:`run_slice` runs one CNN spec through both packages on the CPU: JAX
parameters from a fixed key carried across as numpy, then
``api.quantize(act="static")`` in each package on the same numpy
calibration images, then each packed model's forward on the same numpy
batch. The LM helpers give both packages the same decoder-LM configs and
the same weights.
"""
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

    from repro.models import transformer as jtr
    from repro_torch.interop import params_from_numpy

    jp = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
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

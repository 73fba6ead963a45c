"""Shared runner for the whole-slice parity tests (``test_torch_slice_*.py``).

Runs one CNN spec through both packages on the CPU: JAX parameters from a
fixed key carried across as numpy, then ``api.quantize(act="static")`` in
each package on the same numpy calibration images, then each packed
model's forward on the same numpy batch.
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


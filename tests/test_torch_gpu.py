"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test asks the ``cuda`` fixture for the card and
skips where there is none. Run them on a machine with an H100:

    python -m pytest -m gpu tests/test_torch_*.py

Tolerance: max |kernel - plain| <= 2e-5 * max |plain| (float32 sums in
another order; split-K adds its partial sums in a fixed order).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.core.elp_bsd import PRESET_FORMATS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul, elp_bsd_matmul_plain  # noqa: E402
from repro_torch.kernels.fused_decode import (  # noqa: E402
    fused_decode_matmul,
    fused_decode_matmul_plain,
)
from repro_torch.models import cnn  # noqa: E402

pytestmark = pytest.mark.gpu
REL_TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(dev, fmt_name, nibble, m, k, n, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, device=dev, generator=g)
    hi = 256 if nibble else 2 ** PRESET_FORMATS[fmt_name].bits_per_weight
    rows = (k + 1) // 2 if nibble else k
    codes = torch.randint(0, hi, (rows, n), device=dev, generator=g, dtype=torch.uint8)
    return x, codes, torch.tensor([0.013], device=dev)


def _close(got, want):
    err = (got - want).abs().max().item()
    assert bool(torch.isfinite(got).all())
    assert err <= REL_TOL * max(want.abs().max().item(), 1e-30), err


LAYOUTS = [(f, False) for f in sorted(PRESET_FORMATS)] + [("elp_bsd_a4", True)]
# (M, K, N): tile multiples, ragged edges (odd K: the nibble pad row),
# split-K sized, and one-element
SHAPES = [(256, 384, 128), (100, 70, 34), (100, 71, 34), (64, 4096, 256), (1, 2, 1)]


@pytest.mark.parametrize("fmt_name,nibble", LAYOUTS)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_tiled_kernel_matches_plain(cuda, fmt_name, nibble, m, k, n):
    x, codes, sf = _case(cuda, fmt_name, nibble, m, k, n)
    fmt = PRESET_FORMATS[fmt_name]
    before = elp_bsd_matmul.launches
    got = elp_bsd_matmul(x, codes, sf, fmt, nibble=nibble)
    torch.cuda.synchronize()
    assert elp_bsd_matmul.launches == before + 1
    _close(got, elp_bsd_matmul_plain(x, codes, sf, fmt, nibble=nibble))


@pytest.mark.parametrize("fmt_name,nibble", LAYOUTS)
@pytest.mark.parametrize("m,k,n", SHAPES + [(256, 12544, 96)])
def test_fused_kernel_matches_plain(cuda, fmt_name, nibble, m, k, n):
    x, codes, sf = _case(cuda, fmt_name, nibble, m, k, n)
    fmt = PRESET_FORMATS[fmt_name]
    before = fused_decode_matmul.launches
    got = fused_decode_matmul(x, codes, sf, fmt, nibble=nibble)
    torch.cuda.synchronize()
    assert fused_decode_matmul.launches == before + 1
    _close(got, fused_decode_matmul_plain(x, codes, sf, fmt, nibble=nibble))


def test_kernels_are_deterministic(cuda):
    x, codes, sf = _case(cuda, "elp_bsd_a4", True, 64, 12544, 512)
    fmt = PRESET_FORMATS["elp_bsd_a4"]
    a = fused_decode_matmul(x, codes, sf, fmt, nibble=True)
    b = fused_decode_matmul(x, codes, sf, fmt, nibble=True)
    assert torch.equal(a, b)
    x2 = torch.cat([x] * 4)
    assert torch.equal(elp_bsd_matmul(x2, codes, sf, fmt, nibble=True),
                       elp_bsd_matmul(x2, codes, sf, fmt, nibble=True))


def test_cuda_wrappers_raise_on_bad_inputs(cuda):
    x, codes, sf = _case(cuda, "elp_bsd_a4", False, 128, 128, 128)
    fmt = PRESET_FORMATS["elp_bsd_a4"]
    with pytest.raises(TypeError, match="uint8"):
        elp_bsd_matmul(x, codes.to(torch.int32), sf, fmt)
    with pytest.raises(ValueError, match="share a device"):
        fused_decode_matmul(x[:4], codes.cpu(), sf, fmt)


@pytest.mark.parametrize("impl", ["tiled", "fused"])
@pytest.mark.parametrize("granularity", ["per_tensor", "per_channel"])
def test_quantized_matmul_card_matches_cpu(cuda, impl, granularity):
    rng = np.random.default_rng(3)
    w = torch.from_numpy((rng.normal(size=(131, 96)) * 0.1).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(7, 131)).astype(np.float32))
    pw, _ = ops.pack_weight(w, "elp_bsd_a4", granularity=granularity)
    want = ops.quantized_matmul(x, pw, impl=impl)
    got = ops.quantized_matmul(x.to(cuda), pw.to(cuda), impl=impl).cpu()
    _close(got, want)


@pytest.mark.parametrize("spec_name", ["ALEXNET_MINI", "VGG_MINI"])
def test_mini_model_on_card_matches_cpu(cuda, spec_name):
    """Conversion on the card packs the same codes as on the CPU, and the
    packed forward on the card matches the CPU's: float activations within
    1e-4 * max |logit|; static 8-bit activations within 5e-2 (rounding
    half-step flips, see chip_smoke.py) with argmax agreeing on >= 99 %."""
    spec = getattr(cnn, spec_name)
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(2, 8, 32, 32, 3)).astype(np.float32)
    x = rng.normal(size=(300, 32, 32, 3)).astype(np.float32)  # fc M > 256: tiled kernel
    params = cnn.init_params(spec, seed=0, device="cpu")
    scheme = api.QuantScheme(fmt="elp_bsd_a4", act="static")
    q_cpu = api.quantize(spec, params, scheme, calib_data=imgs, device="cpu")
    q_card = api.quantize(spec, params, scheme, calib_data=imgs)  # default device: the card
    assert q_card.device.type == "cuda"
    for k, v in q_cpu.params.items():
        if isinstance(v, ops.PackedWeight):
            assert torch.equal(v.codes, q_card.params[k].codes.cpu()), k
    q_gpu = q_cpu.to(cuda)
    n_conv = sum(isinstance(l, cnn.Conv) for l in spec.layers)
    n_fc = sum(isinstance(l, cnn.Fc) for l in spec.layers)
    for act in ("float", "static"):
        calib = q_cpu.table if act == "static" else None
        want = cnn.forward(q_cpu.params, spec, torch.from_numpy(x), calib=calib)
        counts = (elp_bsd_matmul.launches, fused_decode_matmul.launches)
        got = cnn.forward(q_gpu.params, spec, torch.from_numpy(x).to(cuda), calib=calib).cpu()
        # 300 images: every conv and fc GEMM has M > 256, the tiled kernel
        assert (elp_bsd_matmul.launches - counts[0], fused_decode_matmul.launches - counts[1]) \
            == (n_conv + n_fc, 0)
        counts = (elp_bsd_matmul.launches, fused_decode_matmul.launches)
        got_small = cnn.forward(q_gpu.params, spec, torch.from_numpy(x[:8]).to(cuda),
                                calib=calib).cpu()
        # 8 images: the fc layers (and the late convs with B*Ho*Wo <= 256) decode-step
        tiled, fused = (elp_bsd_matmul.launches - counts[0], fused_decode_matmul.launches - counts[1])
        assert fused >= n_fc and tiled + fused == n_conv + n_fc
        rel = 1e-4 if act == "float" else 5e-2
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= rel * scale, act
        assert (got_small - want[:8]).abs().max().item() <= rel * scale, act
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        assert agree >= (1.0 if act == "float" else 0.99), (act, agree)


def test_entry_points_default_to_the_card(cuda):
    params = cnn.init_params(cnn.ALEXNET_MINI, seed=1)
    assert all(v.device.type == "cuda" for v in params.values())
    assert math.isclose(float(params["fc3_w"].std()), float(
        cnn.init_params(cnn.ALEXNET_MINI, seed=1, device="cpu")["fc3_w"].std()), rel_tol=1e-6)

"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test asks the ``cuda`` fixture for the card and
skips where there is none. Run them on a machine with an H100:

    python -m pytest -m gpu tests/test_torch_*.py

Tolerance: max |kernel - plain| <= 2e-5 * max |plain| (float32 sums in
another order; split-K adds its partial sums in a fixed order). The
matmuls' wgmma routes take bf16 x and their bf16x3 routes float32 x split
exactly into three bf16 terms: either way every product is exact in
float32, so the same limit holds. Float32 x reaches the CUDA-core kernels
(``"f32"``) only for a format that is not bf16-exact, so those kernels are
also launched directly here (``launch_checked``).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.core.elp_bsd import PRESET_FORMATS  # noqa: E402
from repro_torch.core.elp_bsd import DigitSpec, ElpBsdFormat  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.elp_bsd_matmul import (  # noqa: E402
    elp_bsd_matmul,
    elp_bsd_matmul_plain,
    launch_checked,
)
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


def _routed(kernel, route, fn):
    """``fn()``'s result, checking that it launched ``kernel`` once, on ``route``."""
    before = (kernel.launches, dict(kernel.launches_by_route))
    got = fn()
    torch.cuda.synchronize()
    assert kernel.launches == before[0] + 1
    assert kernel.launches_by_route == {**before[1], route: before[1][route] + 1}
    return got


@pytest.mark.parametrize("fmt_name,nibble", LAYOUTS)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_tiled_kernel_matches_plain(cuda, fmt_name, nibble, m, k, n):
    """Float32 x through the wrapper: the bf16x3 route."""
    x, codes, sf = _case(cuda, fmt_name, nibble, m, k, n)
    fmt = PRESET_FORMATS[fmt_name]
    got = _routed(elp_bsd_matmul, "bf16x3",
                  lambda: elp_bsd_matmul(x, codes, sf, fmt, nibble=nibble))
    _close(got, elp_bsd_matmul_plain(x, codes, sf, fmt, nibble=nibble))


@pytest.mark.parametrize("fmt_name,nibble", LAYOUTS)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_f32_tiled_kernel_matches_plain(cuda, fmt_name, nibble, m, k, n):
    """The CUDA-core kernel (the "f32" route), launched directly."""
    x, codes, sf = _case(cuda, fmt_name, nibble, m, k, n)
    fmt = PRESET_FORMATS[fmt_name]
    got = launch_checked("elp_bsd_matmul", x, codes, sf, fmt, nibble)
    torch.cuda.synchronize()
    _close(got, elp_bsd_matmul_plain(x, codes, sf, fmt, nibble=nibble))


# (M, K, N) for the bf16 wgmma route: a tile multiple, ragged M and N with
# even and odd K (x rows and code rows off TMA's 16-byte rule: padded copies),
# one element, and split-K (qwen3-8b's wk/wv at the prefill's M)
WGMMA_SHAPES = [(256, 384, 128), (100, 70, 34), (100, 71, 34), (1, 2, 1), (2048, 4096, 1024)]


@pytest.mark.parametrize("fmt_name,nibble", LAYOUTS)
@pytest.mark.parametrize("m,k,n", WGMMA_SHAPES)
def test_wgmma_route_matches_plain(cuda, fmt_name, nibble, m, k, n):
    x, codes, sf = _case(cuda, fmt_name, nibble, m, k, n)
    x = x.to(torch.bfloat16)
    fmt = PRESET_FORMATS[fmt_name]
    before = (elp_bsd_matmul.launches, dict(elp_bsd_matmul.launches_by_route))
    got = elp_bsd_matmul(x, codes, sf, fmt, nibble=nibble, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert elp_bsd_matmul.launches == before[0] + 1
    assert elp_bsd_matmul.launches_by_route == {**before[1], "wgmma": before[1]["wgmma"] + 1}
    _close(got, elp_bsd_matmul_plain(x, codes, sf, fmt, nibble=nibble, out_dtype=torch.float32))


def test_wgmma_route_is_deterministic(cuda):
    x, codes, sf = _case(cuda, "elp_bsd_a4", True, 2048, 4096, 1024)
    x = x.to(torch.bfloat16)
    fmt = PRESET_FORMATS["elp_bsd_a4"]
    first = elp_bsd_matmul(x, codes, sf, fmt, nibble=True, out_dtype=torch.float32)
    for _ in range(3):
        assert torch.equal(elp_bsd_matmul(x, codes, sf, fmt, nibble=True,
                                          out_dtype=torch.float32), first)


def test_wgmma_route_raises_on_bad_inputs(cuda):
    from repro_torch.kernels.elp_bsd_matmul import launch_wgmma

    x, codes, sf = _case(cuda, "elp_bsd_a4", True, 256, 128, 128)
    xb = x.to(torch.bfloat16)
    fmt = PRESET_FORMATS["elp_bsd_a4"]
    with pytest.raises(TypeError, match="uint8"):
        elp_bsd_matmul(xb, codes.to(torch.int32), sf, fmt, nibble=True)
    with pytest.raises(ValueError, match="share a device"):
        elp_bsd_matmul(xb, codes.cpu(), sf, fmt, nibble=True)
    with pytest.raises(ValueError, match="two K rows per byte"):
        elp_bsd_matmul(xb, codes[:10], sf, fmt, nibble=True)
    with pytest.raises(TypeError, match="bfloat16"):
        launch_wgmma(x, codes, sf, fmt, True)
    with pytest.raises(ValueError, match="nibbles hold 4"):
        elp_bsd_matmul(xb, codes, sf, PRESET_FORMATS["elp_bsd_c6"], nibble=True)


@pytest.mark.parametrize("fmt_name,nibble", LAYOUTS)
@pytest.mark.parametrize("m,k,n", SHAPES + [(256, 12544, 96)])
def test_fused_kernel_matches_plain(cuda, fmt_name, nibble, m, k, n):
    """Float32 x through the wrapper: the bf16x3 route."""
    x, codes, sf = _case(cuda, fmt_name, nibble, m, k, n)
    fmt = PRESET_FORMATS[fmt_name]
    got = _routed(fused_decode_matmul, "bf16x3",
                  lambda: fused_decode_matmul(x, codes, sf, fmt, nibble=nibble))
    _close(got, fused_decode_matmul_plain(x, codes, sf, fmt, nibble=nibble))


@pytest.mark.parametrize("fmt_name,nibble", LAYOUTS)
@pytest.mark.parametrize("m,k,n", SHAPES + [(256, 12544, 96)])
def test_f32_fused_kernel_matches_plain(cuda, fmt_name, nibble, m, k, n):
    """The decode-step CUDA-core kernel (the "f32" route), launched directly."""
    x, codes, sf = _case(cuda, fmt_name, nibble, m, k, n)
    fmt = PRESET_FORMATS[fmt_name]
    got = launch_checked("fused_decode", x, codes, sf, fmt, nibble)
    torch.cuda.synchronize()
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


# ---------------------------------------------------------------------------
# The decoder-LM slice: flash attention, stacked packed leaves, prefill/decode
# ---------------------------------------------------------------------------
FLASH_SHAPES = [
    # (B, H, KVH, Sq, Sk, hd, q_offset, block): the JAX tests' shapes, GQA heads,
    # qwen3-8b's head, a prefill after a cached prefix, a ragged small head
    (1, 2, 2, 256, 256, 64, 0, 128),
    (2, 4, 4, 384, 384, 128, 0, 128),
    (2, 8, 2, 256, 256, 128, 0, 128),
    (1, 4, 2, 128, 256, 128, 128, 128),
    (1, 4, 4, 48, 48, 16, 0, 16),
]


def _assert_flash_close(got, want) -> None:
    """Elementwise |got - want| <= rel * |want| + abs_rel * max |want|.

    float32: sums in another order (2e-5 of max |out|). bfloat16: kernel
    and plain version each round a float32 result once, so one bf16 step
    (at most 2^-7 of the value) may separate them, on top of five times the
    float32 noise for the results before rounding.
    """
    rel, abs_rel = (0.0, 2e-5) if want.dtype == torch.float32 else (2.0 ** -7, 1e-4)
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all())
    excess = (got - want).abs() - rel * want.abs() - abs_rel * want.abs().max()
    assert excess.max().item() <= 0, (got - want).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,kvh,sq,sk,hd,q_offset,block", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda, dtype, causal, b, h, kvh, sq, sk, hd, q_offset, block):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    g = torch.Generator(device=cuda).manual_seed(sq + hd)
    q = torch.randn(b, h, sq, hd, device=cuda, generator=g).to(dtype)
    k = torch.randn(b, kvh, sk, hd, device=cuda, generator=g).to(dtype)
    v = torch.randn(b, kvh, sk, hd, device=cuda, generator=g).to(dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, block_q=block, block_k=block,
                          q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and got.dtype == dtype
    _assert_flash_close(got, flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset))


def test_flash_kernel_reads_strided_activations(cuda):
    """q/k/v as [B, H, S, hd] views of [B, S, H, hd] tensors: read in place, output
    in q's strides."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(2, 128, 8, 128, device=cuda, generator=g).to(torch.bfloat16)
    kv = torch.randn(2, 2, 128, 2, 128, device=cuda, generator=g).to(torch.bfloat16)
    qt, kt, vt = q.transpose(1, 2), kv[0].transpose(1, 2), kv[1].transpose(1, 2)
    got = flash_attention(qt, kt, vt)
    assert got.stride() == qt.stride()
    _assert_flash_close(got, flash_attention_plain(qt.contiguous(), kt.contiguous(),
                                                   vt.contiguous()))


def test_flash_wrapper_raises_on_bad_inputs(cuda):
    from repro_torch.kernels.flash_attention import flash_attention

    q = torch.zeros(1, 2, 128, 64, device=cuda)
    with pytest.raises(ValueError, match="tile by the block sizes"):
        flash_attention(q[:, :, :100], q, q)
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention(q, q.half(), q.half())
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(*(torch.zeros(1, 1, 128, 256, device=cuda),) * 3)


@pytest.mark.parametrize("impl", ["tiled", "fused"])
def test_stacked_packed_layer_view_through_both_kernels(cuda, impl):
    """A stacked [L, K', N] leaf's layer view shares the stack's storage and runs
    through each matmul kernel as a single weight, matching its plain version."""
    from repro_torch.runtime.quantized_params import quantize_stacked

    rng = np.random.default_rng(11)
    w = torch.from_numpy((rng.normal(size=(3, 256, 384)) * 0.05).astype(np.float32)).to(cuda)
    pw = quantize_stacked(w, PRESET_FORMATS["elp_bsd_a4"])
    assert tuple(pw.codes.shape) == (3, 128, 384) and tuple(pw.sf.shape) == (3, 1, 1)
    x = torch.randn(300 if impl == "tiled" else 16, 256, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(2))
    for i in range(3):
        view = pw.layer(i)
        assert view.codes.data_ptr() == pw.codes.data_ptr() + i * 128 * 384
        kernel = elp_bsd_matmul if impl == "tiled" else fused_decode_matmul
        before = kernel.launches
        got = ops.quantized_matmul(x, view, impl=impl)
        assert kernel.launches == before + 1
        want = elp_bsd_matmul_plain(x, view.codes, view.sf, view.fmt, nibble=True)
        _close(got, want)


def test_stacked_packed_layer_view_through_wgmma_route(cuda):
    """bf16 activations on a stacked leaf's layer views take the wgmma route."""
    from repro_torch.runtime.quantized_params import quantize_stacked

    rng = np.random.default_rng(12)
    w = torch.from_numpy((rng.normal(size=(3, 256, 384)) * 0.05).astype(np.float32)).to(cuda)
    pw = quantize_stacked(w, PRESET_FORMATS["elp_bsd_a4"])
    x = torch.randn(300, 256, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3)).to(torch.bfloat16)
    for i in range(3):
        view = pw.layer(i)
        before = elp_bsd_matmul.launches_by_route["wgmma"]
        got = ops.quantized_matmul(x, view, impl="tiled", out_dtype=torch.float32)
        assert elp_bsd_matmul.launches_by_route["wgmma"] == before + 1
        want = elp_bsd_matmul_plain(x, view.codes, view.sf, view.fmt, nibble=True,
                                    out_dtype=torch.float32)
        _close(got, want)


@pytest.mark.parametrize("act", ["float", "static"])
def test_lm_prefill_and_decode_on_card_match_cpu(cuda, act):
    """qwen3-8b reduced to 2 layers, packed once on the CPU: prefill and decode
    steps on the card (tiled kernel for the prefill's M = 320 rows, decode-step
    kernel for M = 4, flash kernel for prefill attention) against the same model
    on the CPU (plain versions). Float activations within 1e-4 * max |logit|
    (float32 sums in another order); static 8-bit activations within 5e-2
    (rounding half-step flips, as for the CNNs)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer

    cfg = get_config("qwen3_8b").reduced()
    params = transformer.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(4)
    calib = rng.integers(0, cfg.vocab, (2, 4, 32)).astype(np.int64)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 80)).astype(np.int64))
    qm = api.quantize(cfg, params, api.QuantScheme(fmt="elp4", act=act),
                      calib_data=calib if act == "static" else None, device="cpu")
    qg = qm.to(cuda)
    rel = 1e-4 if act == "float" else 5e-2
    cache_c = transformer.init_cache(cfg, 4, 84, device="cpu")
    cache_g = transformer.init_cache(cfg, 4, 84, device=cuda)
    counts = (elp_bsd_matmul.launches, fused_decode_matmul.launches, flash_attention.launches)
    want, cache_c = transformer.prefill(qm.params, cfg, prompts, cache_c)
    got, cache_g = transformer.prefill(qg.params, cfg, prompts.to(cuda), cache_g)
    assert (elp_bsd_matmul.launches - counts[0], fused_decode_matmul.launches - counts[1],
            flash_attention.launches - counts[2]) == (14, 0, 2)
    assert (got.cpu() - want).abs().max().item() <= rel * want.abs().max().item()
    tok = want.argmax(-1)
    for i in range(3):
        counts = (elp_bsd_matmul.launches, fused_decode_matmul.launches)
        want, cache_c = transformer.decode_step(qm.params, cfg, tok, cache_c, 80 + i)
        got, cache_g = transformer.decode_step(qg.params, cfg, tok.to(cuda), cache_g, 80 + i)
        assert (elp_bsd_matmul.launches - counts[0], fused_decode_matmul.launches - counts[1]) \
            == (0, 14)
        assert (got.cpu() - want).abs().max().item() <= rel * want.abs().max().item(), i
        tok = want.argmax(-1)


# ---------------------------------------------------------------------------
# The tensor-core routes of the decode-step matmul and of flash attention
# ---------------------------------------------------------------------------
# (M, K, N) for the decode-step kernel's wgmma route: qwen3-8b's four block
# matmul shapes at the decode step's M = 16 (split-K, last-split sums), then
# ragged M over its three wgmma widths (N = 16: M 1, 7; 64: 17, 33; 256:
# 100, 256), K and N (x rows and code rows off TMA's 16-byte rule: padded
# copies), and one element.
DECODE_LM_SHAPES = [(16, 4096, 4096), (16, 4096, 1024), (16, 4096, 12288), (16, 12288, 4096)]
DECODE_RAGGED_SHAPES = [(1, 4001, 1000), (7, 130, 34), (17, 4096, 1000), (33, 640, 384),
                        (100, 71, 34), (256, 4096, 512), (1, 2, 1)]


def _decode_wgmma_case(cuda, fmt_name, nibble, m, k, n):
    x, codes, sf = _case(cuda, fmt_name, nibble, m, k, n)
    x = x.to(torch.bfloat16)
    fmt = PRESET_FORMATS[fmt_name]
    before = (fused_decode_matmul.launches, dict(fused_decode_matmul.launches_by_route))
    got = fused_decode_matmul(x, codes, sf, fmt, nibble=nibble, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert fused_decode_matmul.launches == before[0] + 1
    assert fused_decode_matmul.launches_by_route == {**before[1],
                                                     "wgmma": before[1]["wgmma"] + 1}
    _close(got, fused_decode_matmul_plain(x, codes, sf, fmt, nibble=nibble,
                                          out_dtype=torch.float32))


@pytest.mark.parametrize("m,k,n", DECODE_LM_SHAPES)
def test_decode_wgmma_route_matches_plain_at_lm_shapes(cuda, m, k, n):
    _decode_wgmma_case(cuda, "elp_bsd_a4", True, m, k, n)


@pytest.mark.parametrize("fmt_name,nibble", [("elp_bsd_a4", True), ("elp_bsd_a4", False),
                                             ("elp_bsd_c6", False)])
@pytest.mark.parametrize("m,k,n", DECODE_RAGGED_SHAPES)
def test_decode_wgmma_route_matches_plain_ragged(cuda, fmt_name, nibble, m, k, n):
    _decode_wgmma_case(cuda, fmt_name, nibble, m, k, n)


@pytest.mark.parametrize("m,k,n", [(16, 4096, 1024), (16, 12288, 4096), (7, 4001, 1000)])
def test_decode_wgmma_route_is_deterministic(cuda, m, k, n):
    """Two runs bit-identical, the last-split sums of split-K included."""
    x, codes, sf = _case(cuda, "elp_bsd_a4", True, m, k, n)
    x = x.to(torch.bfloat16)
    fmt = PRESET_FORMATS["elp_bsd_a4"]
    first = fused_decode_matmul(x, codes, sf, fmt, nibble=True, out_dtype=torch.float32)
    for _ in range(3):
        assert torch.equal(fused_decode_matmul(x, codes, sf, fmt, nibble=True,
                                               out_dtype=torch.float32), first)


def test_decode_wgmma_route_raises_on_bad_inputs(cuda):
    from repro_torch.kernels.elp_bsd_matmul import launch_wgmma

    x, codes, sf = _case(cuda, "elp_bsd_a4", True, 16, 128, 128)
    xb = x.to(torch.bfloat16)
    fmt = PRESET_FORMATS["elp_bsd_a4"]
    with pytest.raises(TypeError, match="uint8"):
        fused_decode_matmul(xb, codes.to(torch.int32), sf, fmt, nibble=True)
    with pytest.raises(ValueError, match="share a device"):
        fused_decode_matmul(xb, codes.cpu(), sf, fmt, nibble=True)
    with pytest.raises(ValueError, match="two K rows per byte"):
        fused_decode_matmul(xb, codes[:10], sf, fmt, nibble=True)
    with pytest.raises(ValueError, match="exceeds"):
        fused_decode_matmul(torch.cat([xb] * 17), codes, sf, fmt, nibble=True)
    with pytest.raises(TypeError, match="bfloat16"):
        launch_wgmma(x, codes, sf, fmt, True, name="fused_decode_wgmma")
    with pytest.raises(ValueError, match="nibbles hold 4"):
        fused_decode_matmul(xb, codes, sf, PRESET_FORMATS["elp_bsd_c6"], nibble=True)


FLASH_WGMMA_CASES = [
    # (B, H, KVH, Sq, Sk, hd, q_offset, block, causal, bshd): qwen3-8b's prefill
    # call ([B, S, H, hd] views, GQA 4) causal and not; a prefill after a
    # cached prefix; ragged Sq and Sk against the kernel's 64-row tiles; a head
    # narrower than 64 and one between 64 and 128; hd 20, whose rows are off
    # TMA's 16-byte rule (a padded copy)
    (16, 32, 8, 128, 128, 128, 0, 128, True, True),
    (16, 32, 8, 128, 128, 128, 0, 128, False, True),
    (1, 4, 2, 128, 256, 128, 128, 128, True, False),
    (2, 4, 4, 48, 80, 64, 32, 16, True, False),
    (2, 4, 4, 48, 80, 64, 0, 16, False, False),
    (1, 2, 1, 96, 96, 96, 0, 32, True, True),
    (1, 2, 2, 64, 64, 20, 0, 64, True, False),
]


@pytest.mark.parametrize("b,h,kvh,sq,sk,hd,q_offset,block,causal,bshd", FLASH_WGMMA_CASES)
def test_flash_wgmma_route_matches_plain(cuda, b, h, kvh, sq, sk, hd, q_offset, block, causal,
                                         bshd):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    g = torch.Generator(device=cuda).manual_seed(sq + hd + h)
    if bshd:  # [B, S, H, hd] activations viewed as [B, H, S, hd]
        q = torch.randn(b, sq, h, hd, device=cuda, generator=g).to(torch.bfloat16).transpose(1, 2)
        k, v = (torch.randn(b, sk, kvh, hd, device=cuda, generator=g).to(torch.bfloat16)
                .transpose(1, 2) for _ in range(2))
    else:
        q = torch.randn(b, h, sq, hd, device=cuda, generator=g).to(torch.bfloat16)
        k, v = (torch.randn(b, kvh, sk, hd, device=cuda, generator=g).to(torch.bfloat16)
                for _ in range(2))
    before = dict(flash_attention.launches_by_route)
    got = flash_attention(q, k, v, causal=causal, block_q=block, block_k=block,
                          q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_route == {**before, "wgmma": before["wgmma"] + 1}
    assert got.dtype == torch.bfloat16 and got.stride() == q.stride()
    _assert_flash_close(got, flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset))


def test_flash_routes_by_dtype(cuda):
    from repro_torch.kernels.flash_attention import flash_attention

    q = torch.randn(1, 2, 64, 64, device=cuda)
    before = dict(flash_attention.launches_by_route)
    flash_attention(q, q, q, block_q=64, block_k=64)
    flash_attention(*(q.to(torch.bfloat16),) * 3, block_q=64, block_k=64)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_route == {"wgmma": before["wgmma"] + 1,
                                                 "f32": before["f32"] + 1}


# ---------------------------------------------------------------------------
# The bf16x3 routes: float32 x split into three bf16 terms on the tensor cores
# ---------------------------------------------------------------------------
# AlexNet at batch 64: the five convs' im2col GEMMs (M, K, N) and the three
# fc layers, then ragged shapes: conv0's K = 363 and N = 96 at a small M,
# odd K (the nibble pad row), N off the tiles, split-K sized.
ALEXNET_CONVS = [(200704, 363, 96), (50176, 2400, 256), (12544, 2304, 384), (12544, 3456, 384),
                 (12544, 3456, 256)]
ALEXNET_FCS = [(64, 12544, 4096), (64, 4096, 4096), (64, 4096, 1000)]
BF16X3_RAGGED = [(300, 363, 96), (100, 71, 34), (129, 130, 130), (1, 2, 1), (64, 4001, 1000),
                 (7, 4096, 256), (200, 3456, 384)]
# Two digits 9 binary places apart: 2^9 + 1 needs 10 significant bits.
WIDE = ElpBsdFormat((DigitSpec(shifts=(0,)), DigitSpec(shifts=(9,))), name="shifts_0_9")


def _aligned_rows(x):
    """``x`` as a view into rows of a multiple of 16 bytes, as im2col writes them."""
    m, k = x.shape
    buf = torch.zeros(m, -(-k // 4) * 4, device=x.device)
    buf[:, :k] = x
    return buf[:, :k]


@pytest.mark.parametrize("m,k,n", ALEXNET_CONVS + BF16X3_RAGGED)
def test_bf16x3_tiled_route_matches_plain(cuda, m, k, n):
    x, codes, sf = _case(cuda, "elp_bsd_a4", True, m, k, n, seed=k)
    if k % 4:
        x = _aligned_rows(x)
    fmt = PRESET_FORMATS["elp_bsd_a4"]
    got = _routed(elp_bsd_matmul, "bf16x3", lambda: elp_bsd_matmul(x, codes, sf, fmt, nibble=True))
    _close(got, elp_bsd_matmul_plain(x, codes, sf, fmt, nibble=True))


@pytest.mark.parametrize("m,k,n", ALEXNET_FCS + [s for s in BF16X3_RAGGED if s[0] <= 256])
def test_bf16x3_decode_route_matches_plain(cuda, m, k, n):
    x, codes, sf = _case(cuda, "elp_bsd_a4", True, m, k, n, seed=k)
    fmt = PRESET_FORMATS["elp_bsd_a4"]
    got = _routed(fused_decode_matmul, "bf16x3",
                  lambda: fused_decode_matmul(x, codes, sf, fmt, nibble=True))
    _close(got, fused_decode_matmul_plain(x, codes, sf, fmt, nibble=True))


@pytest.mark.parametrize("impl", ["tiled", "fused"])
@pytest.mark.parametrize("fmt_name,nibble", [("elp_bsd_c6", False), ("elp_bsd_a4", False),
                                             ("elp_bsd_d6", False)])
def test_bf16x3_routes_on_u8_codes(cuda, impl, fmt_name, nibble):
    m = 300 if impl == "tiled" else 64
    x, codes, sf = _case(cuda, fmt_name, nibble, m, 2304, 384, seed=9)
    fmt = PRESET_FORMATS[fmt_name]
    kernel = elp_bsd_matmul if impl == "tiled" else fused_decode_matmul
    got = _routed(kernel, "bf16x3", lambda: kernel(x, codes, sf, fmt, nibble=nibble))
    _close(got, elp_bsd_matmul_plain(x, codes, sf, fmt, nibble=nibble))


@pytest.mark.parametrize("impl", ["tiled", "fused"])
def test_bf16x3_per_channel_sf_through_quantized_matmul(cuda, impl):
    g = torch.Generator(device=cuda).manual_seed(8)
    w = torch.randn(2400, 256, device=cuda, generator=g) * 0.05
    x = torch.randn(300 if impl == "tiled" else 64, 2400, device=cuda, generator=g)
    pw, _ = ops.pack_weight(w, "elp_bsd_a4", granularity="per_channel")
    assert pw.sf.numel() == 256
    kernel = elp_bsd_matmul if impl == "tiled" else fused_decode_matmul
    got = _routed(kernel, "bf16x3", lambda: ops.quantized_matmul(x, pw, impl=impl))
    one = torch.ones(1, device=cuda)
    _close(got, elp_bsd_matmul_plain(x, pw.codes, one, pw.fmt, nibble=True) * pw.sf)


@pytest.mark.parametrize("impl", ["tiled", "fused"])
def test_bf16x3_takes_float16_x(cuda, impl):
    x, codes, sf = _case(cuda, "elp_bsd_a4", True, 64, 1024, 256, seed=3)
    x = x.half()
    fmt = PRESET_FORMATS["elp_bsd_a4"]
    kernel = elp_bsd_matmul if impl == "tiled" else fused_decode_matmul
    got = _routed(kernel, "bf16x3", lambda: kernel(x, codes, sf, fmt, nibble=True,
                                                    out_dtype=torch.float32))
    _close(got, elp_bsd_matmul_plain(x, codes, sf, fmt, nibble=True, out_dtype=torch.float32))


@pytest.mark.parametrize("m,k,n", [(200704, 363, 96), (12544, 3456, 384), (64, 12544, 4096),
                                   (64, 4096, 1000)])
def test_bf16x3_routes_are_deterministic(cuda, m, k, n):
    """Two runs bit-identical, split-K sums included."""
    x, codes, sf = _case(cuda, "elp_bsd_a4", True, m, k, n, seed=5)
    if k % 4:
        x = _aligned_rows(x)
    fmt = PRESET_FORMATS["elp_bsd_a4"]
    kernel = fused_decode_matmul if m <= 256 else elp_bsd_matmul
    first = kernel(x, codes, sf, fmt, nibble=True)
    for _ in range(3):
        assert torch.equal(kernel(x, codes, sf, fmt, nibble=True), first)


@pytest.mark.parametrize("impl", ["tiled", "fused"])
def test_format_not_bf16_exact_takes_the_f32_route(cuda, impl):
    """A format whose values need more than bf16's 8 significant bits: the
    CUDA-core kernel through the wrapper, float32 and bf16 x alike."""
    m = 300 if impl == "tiled" else 64
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(m, 256, device=cuda, generator=g)
    codes = torch.randint(0, 2 ** WIDE.bits_per_weight, (256, 96), device=cuda, generator=g,
                          dtype=torch.uint8)
    sf = torch.tensor([0.01], device=cuda)
    kernel = elp_bsd_matmul if impl == "tiled" else fused_decode_matmul
    for xx in (x, x.to(torch.bfloat16)):
        got = _routed(kernel, "f32", lambda: kernel(xx, codes, sf, WIDE, out_dtype=torch.float32))
        _close(got, elp_bsd_matmul_plain(xx, codes, sf, WIDE, out_dtype=torch.float32))


def test_bf16x3_routes_raise_on_bad_inputs(cuda):
    from repro_torch.kernels.elp_bsd_matmul import launch_wgmma

    x, codes, sf = _case(cuda, "elp_bsd_a4", True, 64, 128, 128)
    fmt = PRESET_FORMATS["elp_bsd_a4"]
    for kernel in (elp_bsd_matmul, fused_decode_matmul):
        with pytest.raises(TypeError, match="uint8"):
            kernel(x, codes.to(torch.int32), sf, fmt, nibble=True)
        with pytest.raises(ValueError, match="share a device"):
            kernel(x, codes.cpu(), sf, fmt, nibble=True)
        with pytest.raises(ValueError, match="two K rows per byte"):
            kernel(x, codes[:10], sf, fmt, nibble=True)
        with pytest.raises(ValueError, match="nibbles hold 4"):
            kernel(x, codes, sf, PRESET_FORMATS["elp_bsd_c6"], nibble=True)
    with pytest.raises(ValueError, match="exceeds"):
        fused_decode_matmul(torch.cat([x] * 5), codes, sf, fmt, nibble=True)
    for name in ("elp_bsd_matmul_wgmma", "fused_decode_wgmma"):
        with pytest.raises(TypeError, match="float32 or float16"):
            launch_wgmma(x.to(torch.bfloat16), codes, sf, fmt, True, name=name, route="bf16x3")

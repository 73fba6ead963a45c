"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test asks the ``cuda`` fixture for the card and
skips where there is none. Run them on a machine with an H100:

    python -m pytest -m gpu tests/test_torch_*.py

Tolerance: max |kernel - plain| <= 2e-5 * max |plain| (float32 sums in
another order; split-K adds its partial sums in a fixed order). The
matmuls' wgmma routes take bf16 x and their bf16x3 routes float32 x split
exactly into three bf16 terms: either way every product is exact in
float32, so the same limit holds; so do the digit-plane routes
(``"wgmma_digits"``, ``"bf16x3_digits"``), which take formats that are not
bf16-exact plane by plane. x reaches the CUDA-core kernels (``"f32"``) only
for formats of 4 or more digits (or terms outside bf16's normal range), so
those kernels are also launched directly here (``launch_checked``).
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
    # qwen3-8b's head, a prefill after a cached prefix, a ragged small head, and
    # a long sequence (4096 keys: the P V sum over 64 key tiles)
    (1, 2, 2, 256, 256, 64, 0, 128),
    (2, 4, 4, 384, 384, 128, 0, 128),
    (2, 8, 2, 256, 256, 128, 0, 128),
    (1, 4, 2, 128, 256, 128, 128, 128),
    (1, 4, 4, 48, 48, 16, 0, 16),
    (1, 2, 2, 4096, 4096, 128, 0, 128),
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
    """float32 reaches the bf16x3 route, bf16 the wgmma route."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    g = torch.Generator(device=cuda).manual_seed(sq + hd)
    q = torch.randn(b, h, sq, hd, device=cuda, generator=g).to(dtype)
    k = torch.randn(b, kvh, sk, hd, device=cuda, generator=g).to(dtype)
    v = torch.randn(b, kvh, sk, hd, device=cuda, generator=g).to(dtype)
    before = dict(flash_attention.launches_by_route)
    got = flash_attention(q, k, v, causal=causal, block_q=block, block_k=block,
                          q_offset=q_offset)
    torch.cuda.synchronize()
    r = "bf16x3" if dtype == torch.float32 else "wgmma"
    assert flash_attention.launches_by_route == {**before, r: before[r] + 1}
    assert got.dtype == dtype
    _assert_flash_close(got, flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_strided_activations(cuda, dtype):
    """q/k/v as [B, H, S, hd] views of [B, S, H, hd] tensors: read in place, output
    in q's strides."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(2, 128, 8, 128, device=cuda, generator=g).to(dtype)
    kv = torch.randn(2, 2, 128, 2, 128, device=cuda, generator=g).to(dtype)
    qt, kt, vt = q.transpose(1, 2), kv[0].transpose(1, 2), kv[1].transpose(1, 2)
    got = flash_attention(qt, kt, vt)
    assert got.stride() == qt.stride()
    _assert_flash_close(got, flash_attention_plain(qt.contiguous(), kt.contiguous(),
                                                   vt.contiguous()))


@pytest.mark.parametrize("b,h,kvh,sq,sk,hd,q_offset,block", FLASH_SHAPES[:4])
def test_flash_f32_kernel_launched_directly(cuda, b, h, kvh, sq, sk, hd, q_offset, block):
    """3a, the CUDA-core kernel no call of the wrapper reaches since the bf16x3
    route replaced it, launched directly: still the plain version's function
    (and not counted as a launch)."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(sq + hd + 1)
    q = torch.randn(b, h, sq, hd, device=cuda, generator=g)
    k, v = (torch.randn(b, kvh, sk, hd, device=cuda, generator=g) for _ in range(2))
    before = dict(fa.flash_attention.launches_by_route)
    for causal in (True, False):
        out = torch.empty_like(q)
        fa._launch("f32", q, k, v, out, h // kvh, causal, q_offset)
        torch.cuda.synchronize()
        _assert_flash_close(out, fa.flash_attention_plain(q, k, v, causal=causal,
                                                          q_offset=q_offset))
    assert fa.flash_attention.launches_by_route == before


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
    # olmoe-1b-7b's prefill call: MHA (group 1), 16 heads; internvl2-26b's:
    # group 6, 256 frontend embeddings + 128 text tokens
    (16, 16, 16, 128, 128, 128, 0, 128, True, True),
    (4, 48, 8, 384, 384, 128, 0, 128, True, True),
    # seamless-m4t-large-v2 (hd 64, 16 heads) at 16 x 200 frames + 128 tokens:
    # the encoder's self-attention (queries padded to 256, the 200 keys at their
    # true count), cross-attention at prefill, the decoder's causal self-attention
    (16, 16, 16, 256, 200, 64, 0, 128, False, True),
    (16, 16, 16, 128, 200, 64, 0, 128, False, True),
    (16, 16, 16, 128, 128, 64, 0, 128, True, True),
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
                                                 "bf16x3": before["bf16x3"] + 1,
                                                 "f32": before["f32"]}


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
# Four digits 27 places wide: past the digit planes' three, the CUDA-core route.
WIDE4 = ElpBsdFormat(tuple(DigitSpec(shifts=(s,)) for s in (0, 9, 18, 27)), name="wide4_d4")


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
    """A format whose values need more than bf16's 8 significant bits: with two
    digits (``shifts_0_9``) the digit planes on the tensor cores, with four
    (``wide4_d4``, past the planes' three) the CUDA-core kernel through the
    wrapper; float32 and bf16 x alike."""
    m = 300 if impl == "tiled" else 64
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(m, 256, device=cuda, generator=g)
    sf = torch.tensor([0.01], device=cuda)
    kernel = elp_bsd_matmul if impl == "tiled" else fused_decode_matmul
    for fmt, routes in ((WIDE, ("bf16x3_digits", "wgmma_digits")), (WIDE4, ("f32", "f32"))):
        codes = torch.randint(0, 2 ** fmt.bits_per_weight, (256, 96), device=cuda, generator=g,
                              dtype=torch.uint8)
        for xx, r in zip((x, x.to(torch.bfloat16)), routes):
            got = _routed(kernel, r, lambda: kernel(xx, codes, sf, fmt, out_dtype=torch.float32))
            _close(got, elp_bsd_matmul_plain(xx, codes, sf, fmt, out_dtype=torch.float32))


# ---------------------------------------------------------------------------
# The digit-plane routes: formats that are not bf16-exact, 2-3 digits
# ---------------------------------------------------------------------------
# Table II B's shape with a second digit reaching 2^9; three digits in 7
# bits; three in a nibble.
WIDE_B7 = ElpBsdFormat((DigitSpec(shifts=(0, 1, 2, 3, 4, 5, 6, 7)), DigitSpec(shifts=(0, 3, 6, 9))),
                       name="wide_b7")
WIDE3_D7 = ElpBsdFormat((DigitSpec((0, 1, 2, 3)), DigitSpec((0, 9)), DigitSpec((4, 13))),
                        name="wide3_d7")
WIDE3_N4 = ElpBsdFormat((DigitSpec((0,)), DigitSpec((9,)), DigitSpec((4, 13))), name="wide3_n4")
DIGIT_LAYOUTS = [(WIDE_B7, False), (WIDE3_D7, False), (WIDE, True), (WIDE3_N4, True)]
# M: the decode step (16), AlexNet's fc (64), ragged (37; 200, the
# decode-step kernel's 256-row instance), above the decode-step kernel's 256
# (300) and the LM prefill (2048, K and N of qwen3-8b's wk/wv).
DIGIT_MS = [16, 37, 64, 200, 300, 2048]


def _digit_case(dev, fmt, nibble, m, dtype, seed=0):
    k, n = (4096, 1024) if m == 2048 else (999, 200)
    g = torch.Generator(device=dev).manual_seed(seed + m)
    x = torch.randn(m, k, device=dev, generator=g).to(dtype)
    rows = (k + 1) // 2 if nibble else k
    codes = torch.randint(0, 256 if nibble else 2 ** fmt.bits_per_weight, (rows, n), device=dev,
                          generator=g, dtype=torch.uint8)
    return x, codes, torch.tensor([0.013], device=dev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fmt,nibble", DIGIT_LAYOUTS, ids=lambda v: getattr(v, "name", str(v)))
@pytest.mark.parametrize("impl,m", [("tiled", m) for m in DIGIT_MS]
                         + [("fused", m) for m in DIGIT_MS if m <= 256])
def test_digit_routes_match_plain(cuda, impl, m, fmt, nibble, dtype):
    """Both digit routes of both kernels, D = 2 and 3, u8 and nibble codes
    (odd K: the nibble pad row), against the plain version (float32 decode)."""
    x, codes, sf = _digit_case(cuda, fmt, nibble, m, dtype)
    kernel = elp_bsd_matmul if impl == "tiled" else fused_decode_matmul
    r = ("wgmma" if dtype == torch.bfloat16 else "bf16x3") + "_digits"
    got = _routed(kernel, r, lambda: kernel(x, codes, sf, fmt, nibble=nibble,
                                            out_dtype=torch.float32))
    _close(got, elp_bsd_matmul_plain(x, codes, sf, fmt, nibble=nibble, out_dtype=torch.float32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("impl,m", [("tiled", 2048), ("tiled", 300), ("fused", 16),
                                    ("fused", 64), ("fused", 200)])
def test_digit_routes_are_deterministic(cuda, impl, m, dtype):
    """Four runs bit-identical, split-K sums included (wide_b7 u8, wide3_n4 nibble)."""
    kernel = elp_bsd_matmul if impl == "tiled" else fused_decode_matmul
    for fmt, nibble in ((WIDE_B7, False), (WIDE3_N4, True)):
        x, codes, sf = _digit_case(cuda, fmt, nibble, m, dtype, seed=11)
        first = kernel(x, codes, sf, fmt, nibble=nibble, out_dtype=torch.float32)
        for _ in range(3):
            assert torch.equal(kernel(x, codes, sf, fmt, nibble=nibble,
                                      out_dtype=torch.float32), first)


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


# ---------------------------------------------------------------------------
# The Sec. V search, the Fig. 15(b) eval and the artifact on the card
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trained_minis():
    """Both mini CNNs after 100 steps of the port's trainer on the card, on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.experiments import common

    return {name: {k: v.cpu() for k, v in common.train_mini_cnn(
        getattr(cnn, name), steps=100, cache=False).items()}
        for name in ("ALEXNET_MINI", "VGG_MINI")}


@pytest.mark.parametrize("spec_name", ["ALEXNET_MINI", "VGG_MINI"])
@pytest.mark.parametrize("fmt_name", sorted(PRESET_FORMATS))
def test_packed_mini_eval_on_kernels_matches_plain(cuda, trained_minis, spec_name, fmt_name):
    """Fig. 15(b)'s packed eval (batches of 128: convs on the tiled kernel, fc on
    the decode-step kernel, both bf16x3) against the same packed model on the
    CPU (plain versions): logits within 1e-4 * max |logit| with float
    activations, accuracy within 0.01 (the search's ``ac``) at 8 and 4 bits."""
    from repro_torch.experiments import common

    spec = getattr(cnn, spec_name)
    q_cpu = api.quantize(spec, trained_minis[spec_name], api.QuantScheme(fmt=fmt_name),
                         device="cpu")
    q_gpu = q_cpu.to(cuda)
    x, _ = common.CnnDataset(32, 3, 10, 128).np_batch(10_000)
    n_conv = sum(isinstance(l, cnn.Conv) for l in spec.layers)
    n_fc = sum(isinstance(l, cnn.Fc) for l in spec.layers)
    before = (dict(elp_bsd_matmul.launches_by_route), dict(fused_decode_matmul.launches_by_route))
    got = q_gpu.forward(x).cpu()
    torch.cuda.synchronize()
    assert elp_bsd_matmul.launches_by_route == {**before[0],
                                                "bf16x3": before[0]["bf16x3"] + n_conv}
    assert fused_decode_matmul.launches_by_route == {**before[1],
                                                     "bf16x3": before[1]["bf16x3"] + n_fc}
    want = q_cpu.forward(x)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    eval_cpu = common.make_eval_fn(spec, device="cpu")
    eval_gpu = common.make_eval_fn(spec)
    for bits in (8, 4):
        assert abs(eval_gpu(q_gpu.params, bits) - eval_cpu(q_cpu.params, bits)) <= 0.01, bits


def test_search_and_artifact_on_card_match_cpu(cuda, trained_minis, tmp_path):
    """``api.quantize(..., eval_fn=...)`` on the card picks the CPU's CBW_A with the
    same codes; the saved artifact reloads on the card with a bit-identical forward."""
    from repro_torch.experiments import common

    spec = cnn.ALEXNET_MINI
    scheme = api.QuantScheme(fmt="elp_bsd_a4", act="dynamic", ac=0.01, bw_max=8, bw_min=4)
    q_cpu = api.quantize(spec, trained_minis["ALEXNET_MINI"], scheme,
                         eval_fn=common.make_eval_fn(spec, device="cpu"), device="cpu")
    q_gpu = api.quantize(spec, trained_minis["ALEXNET_MINI"], scheme,
                         eval_fn=common.make_eval_fn(spec))
    assert q_gpu.report.act_bits == q_cpu.report.act_bits
    for k, v in q_cpu.params.items():
        if isinstance(v, ops.PackedWeight):
            assert torch.equal(v.codes, q_gpu.params[k].codes.cpu()), k
    x, _ = common.CnnDataset(32, 3, 10, 128).np_batch(3)
    first = q_gpu.forward(x)
    q_gpu.save(str(tmp_path / "art"))
    back = api.load(str(tmp_path / "art"))
    assert back.device.type == "cuda" and back.report == q_gpu.report
    assert torch.equal(back.forward(x), first)


# ---------------------------------------------------------------------------
# The tiled bf16x3 route over a long K (its float32 register sum)
# ---------------------------------------------------------------------------
def test_bf16x3_tiled_route_long_k_against_float64(cuda):
    """VGG16's fc0 length at M = 2048 (3 K splits): the tiled bf16x3 route's
    distance from the float64 sum stays under half the 2e-5 limit; a whole
    split summed in the wgmma accumulator read 1.04 of it."""
    from repro_torch.kernels.ref import decode_values_shift_add, unpack_nibbles_k

    fmt = PRESET_FORMATS["elp_bsd_a4"]
    m, k, n = 2048, 25088, 256
    g = torch.Generator(device=cuda).manual_seed(0)
    codes = torch.randint(0, 256, ((k + 1) // 2, n), device=cuda, generator=g, dtype=torch.uint8)
    sf = torch.tensor([1.0 / k ** 0.5], device=cuda)
    x = torch.randn(m, k, device=cuda, generator=g)
    before = elp_bsd_matmul.launches_by_route["bf16x3"]
    got = elp_bsd_matmul(x, codes, sf, fmt, nibble=True)
    assert elp_bsd_matmul.launches_by_route["bf16x3"] == before + 1
    w = decode_values_shift_add(unpack_nibbles_k(codes), fmt)[:k].double()
    want = (x.double() @ w * sf.double()).float()
    assert (got - want).abs().max().item() < 0.5 * REL_TOL * want.abs().max().item()


# (M, K): VGG16's fc0 at batch 64 and AlexNet's at 128 (two 64-row launches),
# and a ragged M over four launches.
X3_DECODE_LONG_K = [(64, 25088), (128, 12544), (200, 4608)]


@pytest.mark.parametrize("x_kind", ["normal", "relu"])
@pytest.mark.parametrize("m,k", X3_DECODE_LONG_K)
def test_bf16x3_decode_route_long_k_against_float64(cuda, m, k, x_kind):
    """The decode-step bf16x3 route's distance from the float64 sum stays under
    half the 2e-5 limit at long K, for zero-mean x and for post-ReLU x (whose
    products do not cancel in sign: a whole split summed in the wgmma
    accumulator read 0.756 of the limit at VGG16's fc0)."""
    from repro_torch.kernels.ref import decode_values_shift_add, unpack_nibbles_k

    fmt = PRESET_FORMATS["elp_bsd_a4"]
    n = 1024
    g = torch.Generator(device=cuda).manual_seed(k)
    codes = torch.randint(0, 256, ((k + 1) // 2, n), device=cuda, generator=g, dtype=torch.uint8)
    sf = torch.tensor([1.0 / k ** 0.5], device=cuda)
    x = torch.randn(m, k, device=cuda, generator=g)
    if x_kind == "relu":
        x = torch.relu(x)
    got = _routed(fused_decode_matmul, "bf16x3",
                  lambda: fused_decode_matmul(x, codes, sf, fmt, nibble=True))
    w = decode_values_shift_add(unpack_nibbles_k(codes), fmt)[:k].double()
    want = (x.double() @ w * sf.double()).float()
    assert (got - want).abs().max().item() < 0.5 * REL_TOL * want.abs().max().item()


# ---------------------------------------------------------------------------
# The serving engine on the card against the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_cache", ["dense", "paged"])
def test_engine_on_card_matches_cpu(cuda, kv_cache):
    """Full-width qwen3-8b blocks cut to 2 layers (and a 4096-token vocab),
    a4 packed with float activations: the engine's greedy tokens on the card
    (dense admissions on the tiled route and flash, paged ones on the
    decode-step route) equal the CPU's, with 2 slots and ragged prompts."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeEngine

    cfg = dataclasses.replace(get_config("qwen3_8b"), n_layers=2, vocab=4096)
    params = transformer.init_params(cfg, 0, device="cpu")
    qc = api.quantize(cfg, params, api.QuantScheme(fmt="elp4"), device="cpu")
    qg = qc.to(cuda)
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab, 32)
    reqs = [(np.concatenate([prefix, rng.integers(0, cfg.vocab, s)]).astype(np.int32), n)
            for s, n in ((270, 5), (17, 6), (40, 4))]
    kw = dict(n_slots=2, max_len=320, kv_cache=kv_cache, page_size=16)
    want = ServeEngine(cfg, qc.params, **kw).serve(reqs)
    flash_before = flash_attention.launches
    tiled_before = elp_bsd_matmul.launches_by_route["wgmma"]
    fused_before = fused_decode_matmul.launches_by_route["wgmma"]
    got = ServeEngine(cfg, qg.params, **kw).serve(reqs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert fused_decode_matmul.launches_by_route["wgmma"] > fused_before
    if kv_cache == "dense":
        assert flash_attention.launches == flash_before + 3 * cfg.n_layers
        assert elp_bsd_matmul.launches_by_route["wgmma"] == tiled_before + 7 * cfg.n_layers
    else:
        assert flash_attention.launches == flash_before


# ---------------------------------------------------------------------------
# The MoE and VLM slice: olmoe-1b-7b's and internvl2-26b's block matmul shapes
# ---------------------------------------------------------------------------
# (M, K, N) on the tiled wgmma route: olmoe's wq/wk/wv/wo at its lockstep
# prefill's M = 16 x 128; internvl2's wq/wo, wk/wv, w1/w3, w2 at batch 4 x
# (256 + 128) and frontend_proj at 4 x 256
MOE_VLM_TILED_SHAPES = [(2048, 2048, 2048), (1536, 6144, 6144), (1536, 6144, 1024),
                        (1536, 6144, 16384), (1536, 16384, 6144), (1024, 6144, 6144)]
# and on the decode-step route: olmoe at M = 16 (lockstep) and 8 (engine
# slots), internvl2 at M = 4
MOE_VLM_DECODE_SHAPES = [(16, 2048, 2048), (8, 2048, 2048), (4, 6144, 6144), (4, 6144, 1024),
                         (4, 6144, 16384), (4, 16384, 6144)]


@pytest.mark.parametrize("m,k,n", MOE_VLM_TILED_SHAPES)
def test_wgmma_route_matches_plain_at_moe_vlm_shapes(cuda, m, k, n):
    x, codes, sf = _case(cuda, "elp_bsd_a4", True, m, k, n)
    x = x.to(torch.bfloat16)
    fmt = PRESET_FORMATS["elp_bsd_a4"]
    got = _routed(elp_bsd_matmul, "wgmma",
                  lambda: elp_bsd_matmul(x, codes, sf, fmt, nibble=True, out_dtype=torch.float32))
    _close(got, elp_bsd_matmul_plain(x, codes, sf, fmt, nibble=True, out_dtype=torch.float32))


@pytest.mark.parametrize("m,k,n", MOE_VLM_DECODE_SHAPES)
def test_decode_wgmma_route_matches_plain_at_moe_vlm_shapes(cuda, m, k, n):
    _decode_wgmma_case(cuda, "elp_bsd_a4", True, m, k, n)


def test_olmoe_block_on_card_matches_cpu(cuda):
    """One full-width olmoe-1b-7b layer (64 experts, top-8; float32, vocab cut to
    4096), packed a4 on the card and copied to the CPU: prefill (4 tiled + 1 flash
    launches) and decode steps (4 decode-step launches) on the card against the
    same packed model on the CPU, within 1e-4 * max |logit| (float32 sums in
    another order; the expert products are bmm on both), and the same experts
    chosen for every token."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import moe, transformer

    cfg = dataclasses.replace(get_config("olmoe_1b_7b"), n_layers=1, vocab=4096,
                              dtype_str="float32")
    params = transformer.init_params(cfg, 0, device=cuda)
    qg = api.quantize(cfg, params, api.QuantScheme(fmt="elp4"), device=cuda)
    del params
    qc = qg.to("cpu")
    prompts = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab, (4, 80)))
    ids = {"cpu": [], "cuda": []}
    real = moe.router_gates

    def recording(x2d, router, topk):
        gates, topi = real(x2d, router, topk)
        ids[x2d.device.type].append(topi.cpu())
        return gates, topi

    moe.router_gates = recording
    try:
        cache_c = transformer.init_cache(cfg, 4, 84, device="cpu")
        cache_g = transformer.init_cache(cfg, 4, 84, device=cuda)
        counts = (elp_bsd_matmul.launches, fused_decode_matmul.launches, flash_attention.launches)
        want, cache_c = transformer.prefill(qc.params, cfg, prompts, cache_c)
        got, cache_g = transformer.prefill(qg.params, cfg, prompts.to(cuda), cache_g)
        assert (elp_bsd_matmul.launches - counts[0], fused_decode_matmul.launches - counts[1],
                flash_attention.launches - counts[2]) == (4, 0, 1)
        assert (got.cpu() - want).abs().max().item() <= 1e-4 * want.abs().max().item()
        tok = want.argmax(-1)
        for i in range(3):
            counts = (elp_bsd_matmul.launches, fused_decode_matmul.launches)
            want, cache_c = transformer.decode_step(qc.params, cfg, tok, cache_c, 80 + i)
            got, cache_g = transformer.decode_step(qg.params, cfg, tok.to(cuda), cache_g, 80 + i)
            assert (elp_bsd_matmul.launches - counts[0],
                    fused_decode_matmul.launches - counts[1]) == (0, 4)
            assert (got.cpu() - want).abs().max().item() <= 1e-4 * want.abs().max().item(), i
            tok = want.argmax(-1)
    finally:
        moe.router_gates = real
    assert len(ids["cpu"]) == len(ids["cuda"]) == 4
    for a, b in zip(ids["cpu"], ids["cuda"]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The recurrent and enc-dec slice: mamba2-780m, recurrentgemma-2b, seamless
# ---------------------------------------------------------------------------
# (M, K, N) on the tiled wgmma route at 16 x 128 tokens (seamless's encoder
# and its cross-attention xk/xv at 16 x 200 frames): mamba2's in_proj (N =
# 6448 = 16 x 403, ragged against the 128-column tile) and out_proj;
# recurrentgemma's w_gate/w_rec/w_out/wq/wo, MQA wk/wv, w1/w3 and w2;
# seamless's 1024-wide projections and its 8192-wide GELU MLP
RECURRENT_TILED_SHAPES = [(2048, 1536, 6448), (2048, 3072, 1536), (2048, 2560, 2560),
                          (2048, 2560, 256), (2048, 2560, 7680), (2048, 7680, 2560),
                          (3200, 1024, 1024), (3200, 1024, 8192), (3200, 8192, 1024),
                          (2048, 1024, 1024)]
# and on the decode-step route at M = 16 (lockstep)
RECURRENT_DECODE_SHAPES = [(16, 1536, 6448), (16, 3072, 1536), (16, 2560, 256),
                           (16, 2560, 7680), (16, 7680, 2560), (16, 1024, 1024),
                           (16, 1024, 8192), (16, 8192, 1024)]


@pytest.mark.parametrize("m,k,n", RECURRENT_TILED_SHAPES)
def test_wgmma_route_matches_plain_at_recurrent_shapes(cuda, m, k, n):
    test_wgmma_route_matches_plain_at_moe_vlm_shapes(cuda, m, k, n)


@pytest.mark.parametrize("m,k,n", RECURRENT_DECODE_SHAPES)
def test_decode_wgmma_route_matches_plain_at_recurrent_shapes(cuda, m, k, n):
    _decode_wgmma_case(cuda, "elp_bsd_a4", True, m, k, n)


# Per family: (config, depth overrides, frontend frames, tiled launches a
# prefill, flash launches a prefill, decode-step and tiled launches a step)
RECURRENT_CARD_CASES = {
    "mamba2_780m": (dict(n_layers=2), 0, 4, 0, 4, 0),
    "recurrentgemma_2b": (dict(n_layers=3), 0, 6 * 2 + 7, 0, 6 * 2 + 7, 0),
    "seamless_m4t_large_v2": (dict(n_layers=2, n_dec_layers=2), 200, 1 + 2 * 6 + 2 * 10, 6,
                              2 * 8, 2 * 2),
}


@pytest.mark.parametrize("arch", sorted(RECURRENT_CARD_CASES))
def test_recurrent_encdec_on_card_match_cpu(cuda, arch):
    """Full width, depth cut (mamba2 2 layers; recurrentgemma one period: rec,
    rec, attn; seamless 2 + 2), float32, vocab cut to 4096, packed a4 on the card
    and copied to the CPU: prefill and three decode steps on the card against the
    same packed model on the CPU within 1e-4 * max |logit| (float32 sums in
    another order), with the launches of each call per kernel."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import get_model

    over, frames, tiled, flash, step_fused, step_tiled = RECURRENT_CARD_CASES[arch]
    cfg = dataclasses.replace(get_config(arch), vocab=4096, dtype_str="float32", **over)
    model = get_model(cfg)
    qg = api.quantize(cfg, model.init_params(cfg, 0, device=cuda), api.QuantScheme(fmt="elp4"),
                      device=cuda)
    qc = qg.to("cpu")
    rng = np.random.default_rng(11)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (4, 80)))}
    if frames:
        batch["frontend"] = torch.from_numpy(
            rng.standard_normal((4, frames, cfg.d_model)).astype(np.float32))

    def counts():
        return (elp_bsd_matmul.launches, fused_decode_matmul.launches, flash_attention.launches)

    cache_c = model.init_cache(cfg, 4, 84, device="cpu")
    cache_g = model.init_cache(cfg, 4, 84, device=cuda)
    before = counts()
    want, cache_c = model.prefill(qc.params, cfg, batch, cache_c)
    got, cache_g = model.prefill(qg.params, cfg, {k: v.to(cuda) for k, v in batch.items()},
                                 cache_g)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (tiled, 0, flash)
    assert (got.cpu() - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    tok = want.argmax(-1)
    for i in range(3):
        before = counts()
        want, cache_c = model.decode_step(qc.params, cfg, tok, cache_c, 80 + i)
        got, cache_g = model.decode_step(qg.params, cfg, tok.to(cuda), cache_g, 80 + i)
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(counts(), before)) == (step_tiled, step_fused, 0)
        assert (got.cpu() - want).abs().max().item() <= 1e-4 * want.abs().max().item(), i
        tok = want.argmax(-1)


# ---------------------------------------------------------------------------
# The paper's remaining results and training: VGG16 at batch 64, and the
# training path on the card
# ---------------------------------------------------------------------------
# (M, K, N) of VGG16's distinct im2col GEMMs at batch 64 on the tiled bf16x3
# route (conv1_1's K = 27 and N = 64 ragged against the tiles; conv1_2's
# patches 3 211 264 x 576 float32, 7.4 GB), and its fc0 (K = 25088) on the
# decode-step one; fc1 and fc2 are AlexNet's shapes above.
VGG16_CONVS = [(3211264, 27, 64), (3211264, 576, 64), (802816, 576, 128), (802816, 1152, 128),
               (200704, 1152, 256), (200704, 2304, 256), (50176, 2304, 512),
               (50176, 4608, 512), (12544, 4608, 512)]
VGG16_FCS = [(64, 25088, 4096)]


@pytest.mark.parametrize("m,k,n", VGG16_CONVS)
def test_bf16x3_tiled_route_matches_plain_at_vgg16_shapes(cuda, m, k, n):
    test_bf16x3_tiled_route_matches_plain(cuda, m, k, n)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("m,k,n", VGG16_FCS)
def test_bf16x3_decode_route_matches_plain_at_vgg16_shapes(cuda, m, k, n):
    test_bf16x3_decode_route_matches_plain(cuda, m, k, n)


def test_kernel_wrappers_refuse_inputs_that_require_grad(cuda):
    from repro_torch.kernels.flash_attention import flash_attention

    x, codes, sf = _case(cuda, "elp_bsd_a4", True, 64, 256, 128)
    fmt = PRESET_FORMATS["elp_bsd_a4"]
    q = torch.randn(1, 2, 128, 64, device=cuda, dtype=torch.bfloat16)
    calls = {
        "elp_bsd_matmul": lambda t: elp_bsd_matmul(t, codes, sf, fmt, nibble=True),
        "fused_decode_matmul": lambda t: fused_decode_matmul(t, codes, sf, fmt, nibble=True),
        "flash_attention": lambda t: flash_attention(t, q, q),
    }
    for name, call in calls.items():
        t = (q if name == "flash_attention" else x).clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            call(t)
        with torch.no_grad():
            assert bool(torch.isfinite(call(t)).all())
        assert bool(torch.isfinite(call(t.detach())).all())


def test_train_step_on_card_matches_cpu(cuda):
    """One train step of ``lm-ptq`` (float32, TF32 off) on the card against the port
    on the CPU from the same weights: loss within 1e-4 relative, each parameter
    leaf within 1e-4 of its max |w| (AdamW's first step moves a weight by about
    ``lr``, ``eps`` 1e-3 as in the CPU parity test)."""
    from repro_torch.data.pipeline import LmDataset, shard_batch
    from repro_torch.device import full_f32
    from repro_torch.experiments.lm_ptq import CFG
    from repro_torch.kernels.ops import tree_leaves, tree_map
    from repro_torch.models import get_model
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import TrainSetup, make_train_step

    setup = TrainSetup(cfg=CFG, adamw_cfg=adamw.AdamWConfig(eps=1e-3), lr_peak=1e-2, warmup=0,
                       total_steps=10)
    params = get_model(CFG).init_params(CFG, 0, device="cpu")
    batch = LmDataset(CFG, seq_len=64, batch=16, seed=0).np_batch(0)
    out = {}
    with full_f32():
        for dev in ("cpu", cuda):
            p = tree_map(lambda t: t.to(dev), params)
            out[str(dev)] = make_train_step(setup)(p, adamw.init_state(p), None,
                                                   shard_batch(batch, device=dev))
    cpu, card = out["cpu"], out[str(cuda)]
    assert abs(float(card[3]["loss"]) - float(cpu[3]["loss"])) <= 1e-4 * float(cpu[3]["loss"])
    for a, b in zip(tree_leaves(card[0]), tree_leaves(cpu[0])):
        assert (a.cpu() - b).abs().max().item() <= 1e-4 * b.abs().max().item()

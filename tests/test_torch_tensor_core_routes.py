"""The tensor-core routes of the decode-step matmul and of flash attention, on the CPU.

The CUDA kernels (``csrc/fused_decode_wgmma.cu``, ``csrc/flash_attention_wgmma.cu``)
run only on the card (``tests/test_torch_gpu.py``); here the routing rule is
checked without a launch, the plain versions they are held against there
meet the JAX package's Pallas kernels in interpret mode on bf16 inputs, and
a numpy emulation shows what the flash kernel's split of P into two bf16
halves keeps of a float32 P.

Tolerances: the decode-step product at rtol 1e-5, atol 1e-4 (float32 sums in
another order; bf16 x times a bf16-exact weight is exact in float32 on both
sides, as in ``tests/test_torch_tiled_route.py``). Flash attention on bf16
inputs elementwise at one bf16 step (2^-7 of the value) plus 1e-4 of
max |out|: each side rounds its float32 result to bf16 once.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.elp_bsd import PRESET_FORMATS as JFMT  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.fused_decode import fused_decode_matmul as jfused  # noqa: E402
from repro_torch.core.elp_bsd import PRESET_FORMATS as TFMT  # noqa: E402
from repro_torch.core.elp_bsd import DigitSpec, ElpBsdFormat  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_decode as fd  # noqa: E402

# Two digits 9 binary places apart: 2^9 + 1 needs 10 significant bits.
WIDE = ElpBsdFormat((DigitSpec(shifts=(0,)), DigitSpec(shifts=(9,))), name="shifts_0_9")


def test_decode_route_rule_without_launching():
    a4, c6 = TFMT["elp_bsd_a4"], TFMT["elp_bsd_c6"]
    x = torch.zeros(16, 64)
    assert fd.route(x.to(torch.bfloat16), a4) == "wgmma"
    assert fd.route(x.to(torch.bfloat16), c6) == "wgmma"
    assert fd.route(x, a4) == "bf16x3"
    assert fd.route(x.to(torch.float16), a4) == "bf16x3"
    assert fd.route(x.to(torch.bfloat16), WIDE) == "f32"
    assert fd.route(x, WIDE) == "f32"
    before = (fd.fused_decode_matmul.launches, dict(fd.fused_decode_matmul.launches_by_route))
    out = fd.fused_decode_matmul(x.to(torch.bfloat16), torch.zeros(32, 16, dtype=torch.uint8),
                                 1.0, a4, nibble=True)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (16, 16)
    assert (fd.fused_decode_matmul.launches, fd.fused_decode_matmul.launches_by_route) == before
    assert set(fd.fused_decode_matmul.launches_by_route) == set(fd.ROUTES) == {"wgmma", "bf16x3",
                                                                               "f32"}


def test_flash_route_rule_without_launching():
    b16 = torch.zeros(1, 4, 128, 64, dtype=torch.bfloat16)
    f32 = b16.float()
    assert fa.route(b16, b16[:, :2], b16[:, :2]) == "wgmma"
    assert fa.route(f32, f32, f32) == "f32"
    assert fa.route(b16, f32, f32) == "f32"
    assert fa.route(b16.half(), b16.half(), b16.half()) == "f32"
    before = (fa.flash_attention.launches, dict(fa.flash_attention.launches_by_route))
    out = fa.flash_attention(b16, b16[:, :2], b16[:, :2], q_offset=3)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (1, 4, 128, 64)
    assert (fa.flash_attention.launches, fa.flash_attention.launches_by_route) == before
    assert set(fa.flash_attention.launches_by_route) == set(fa.ROUTES) == {"wgmma", "f32"}


@pytest.mark.parametrize("fmt_name,nibble", [("elp_bsd_a4", True), ("elp_bsd_c6", False)])
@pytest.mark.parametrize("m", [1, 7, 16, 17])
def test_decode_plain_on_bf16_x_matches_pallas(fmt_name, nibble, m):
    """The wgmma route's function: bf16 x, float32 out, the decode step's small M."""
    k, n = 256, 96
    rng = np.random.default_rng(m + 31 * nibble)
    x32 = rng.normal(size=(m, k)).astype(np.float32)
    hi = 256 if nibble else 2 ** TFMT[fmt_name].bits_per_weight
    codes = rng.integers(0, hi, size=(k // 2 if nibble else k, n)).astype(np.uint8)
    sf = np.float32(0.021)
    xj = jnp.asarray(x32).astype(jnp.bfloat16)
    xt = torch.from_numpy(x32).to(torch.bfloat16)
    np.testing.assert_array_equal(xt.float().numpy(), np.asarray(xj.astype(jnp.float32)))
    want = jfused(xj, jnp.asarray(codes), jnp.full((1, 1), sf), JFMT[fmt_name], nibble=nibble,
                  block_n=32, block_k=128, out_dtype=jnp.float32, interpret=True)
    got = fd.fused_decode_matmul(xt, torch.from_numpy(codes), torch.tensor(sf), TFMT[fmt_name],
                                 nibble=nibble, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("q_offset", [0, 64, 128])
def test_flash_plain_bf16_gqa_causal_q_offset_matches_pallas(q_offset):
    """GQA k/v (2 of 8 heads) and queries after a cached prefix: the JAX kernel,
    which takes neither, runs on repeated k/v heads with q_offset leading query
    rows prepended, whose outputs are dropped."""
    rng = np.random.default_rng(40 + q_offset)
    b, h, kvh, sq, hd = 2, 8, 2, 128, 64
    sk = q_offset + sq
    q = rng.normal(size=(b, h, sq, hd)).astype(np.float32)
    k, v = (rng.normal(size=(b, kvh, sk, hd)).astype(np.float32) for _ in range(2))
    lead = rng.normal(size=(b, h, q_offset, hd)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, causal=True, q_offset=q_offset, block_q=64, block_k=64)
    jq = jnp.asarray(np.concatenate([lead, q], axis=2), jnp.bfloat16)
    jk, jv = (jnp.repeat(jnp.asarray(t, jnp.bfloat16), h // kvh, axis=1) for t in (k, v))
    want = np.asarray(jflash(jq, jk, jv, causal=True, block_q=64, block_k=64, interpret=True),
                      np.float32)[:, :, q_offset:]
    got = got.float().numpy()
    limit = 2.0 ** -7 * np.abs(want) + 1e-4 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= limit), np.abs(got - want).max()


def test_p_split_in_two_bf16_halves_keeps_float32_p():
    """P_hi = bf16(P), P_lo = bf16(P - P_hi): P_hi + P_lo is within 2^-17 of P
    (each rounding keeps 8 bits), so (P_hi + P_lo) V, with the tensor cores'
    exact products, is within 2^-16 of P V relative to its largest value; a
    single bf16 P is more than 2^-12 away."""
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(64, 128)).astype(np.float32) * 3
    p = torch.from_numpy(np.exp(logits - logits.max(1, keepdims=True)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(128, 128)).astype(np.float32)).to(torch.bfloat16)
    p_hi = p.to(torch.bfloat16)
    p_lo = (p - p_hi.float()).to(torch.bfloat16)
    assert ((p_hi.double() + p_lo.double() - p.double()).abs() <= 2.0 ** -17 * p.double()).all()
    want = p.double() @ v.double()  # float32 P times V, summed exactly
    split = p_hi.double() @ v.double() + p_lo.double() @ v.double()
    single = p_hi.double() @ v.double()
    scale = want.abs().max().item()
    assert (split - want).abs().max().item() <= 2.0 ** -16 * scale
    assert (single - want).abs().max().item() > 2.0 ** -12 * scale

"""The digit-plane routes' arithmetic, port against the JAX package, on the CPU.

A format whose decoded values are not all exact in bf16 (two digits more
than 7 binary places apart) takes the tensor cores as digit planes: a
code's value is ``Σ_d sign_d · 2^shift_d``, each term an exact bf16, so
``x @ W = Σ_d x @ P_d``. The CUDA kernels (``wgmma_digits``,
``bf16x3_digits``) run only on the card (``tests/test_torch_gpu.py``);
here:

* ``ref.digit_planes`` against the JAX package's ``shift_add_terms``, plane
  by plane, bit for bit, and the planes' float32 sum in digit order against
  its ``decode_values_shift_add``, bit for bit;
* ``ref.plane_words`` driving a numpy twin of the kernels' decode
  (``csrc/hopper.cuh::plane_term2``) to those planes, bit for bit;
* ``ref.elp_bsd_matmul_digits`` (the kernels' arithmetic) against the JAX
  package's tiled and decode-step Pallas kernels in interpret mode, bf16 and
  float32 x, ragged M, K and N: within 2e-5 of max |ref| (float32 sums in
  another order; every product is exact on both sides);
* the route rule without a launch;
* ALEXNET_MINI packed with a wide format in both packages: codes and scale
  factors bit-identical (with Algorithm 1 on one weight), logits within
  1e-4 of max |logit| (the tolerance of
  ``tests/test_torch_slice_alexnet_mini.py``), argmax identical, also with
  the digit routes' arithmetic in place of the plain versions.

The wide formats are user-defined ``ElpBsdFormat`` values, no preset: both
packages' packing walks look a packed weight's format up by name, so the
mini path registers them for the test only (``monkeypatch``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import elp_bsd as jelp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.elp_bsd_matmul import elp_bsd_matmul as jtiled  # noqa: E402
from repro.kernels.fused_decode import fused_decode_matmul as jfused  # noqa: E402
from repro_torch.core import elp_bsd as telp  # noqa: E402
from repro_torch.core.convert import nibble_pack  # noqa: E402
from repro_torch.kernels import elp_bsd_matmul as mm  # noqa: E402
from repro_torch.kernels import fused_decode as fd  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

REL_TOL = 2e-5
# (name, digits' shifts): the digit paths' wide formats, the routes' test format,
# a nibble 3-digit one, 4 digits over 27 places (past the planes: f32), and
# one with an unsigned digit and a non-affine 5-entry LUT at bf16's edges.
WIDE = {
    "shifts_0_9": ((0,), (9,)),
    "wide_b7": ((0, 1, 2, 3, 4, 5, 6, 7), (0, 3, 6, 9)),
    "wide3_d7": ((0, 1, 2, 3), (0, 9), (4, 13)),
    "wide3_n4": ((0,), (9,), (4, 13)),
    "wide4_d4": ((0,), (9,), (18,), (27,)),
}
UNSIGNED = "edges_u"


def _fmt(pkg, name):
    """The format ``name`` in package ``pkg`` (``telp`` or ``jelp``)."""
    if name in pkg.PRESET_FORMATS:
        return pkg.PRESET_FORMATS[name]
    if name == UNSIGNED:
        digits = (pkg.DigitSpec((0, 5, 2), signed=False), pkg.DigitSpec((-3, 9, -126, 127, 1)))
    else:
        digits = tuple(pkg.DigitSpec(shifts=s) for s in WIDE[name])
    return pkg.ElpBsdFormat(digits, name=name)


PLANE_FMTS = ["shifts_0_9", "wide_b7", "wide3_d7", "wide3_n4", UNSIGNED]
ALL_FMTS = PLANE_FMTS + sorted(telp.PRESET_FORMATS)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the test runner puts several workers on
    one host, where oversubscribed torch threads slow small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes(fmt, k, n, nibble, seed=0):
    """Seeded raw codes ``[k, n]`` (every code value) and their stored form."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 2 ** fmt.bits_per_weight, (k, n)).astype(np.uint8)
    raw.flat[: 2 ** fmt.bits_per_weight] = np.arange(2 ** fmt.bits_per_weight)
    stored = nibble_pack(torch.from_numpy(raw), axis=-2) if nibble else torch.from_numpy(raw)
    return raw, stored


def _layouts(name):
    fmt = _fmt(telp, name)
    return [(name, False)] + ([(name, True)] if fmt.bits_per_weight <= 4 else [])


@pytest.mark.parametrize("name,nibble", [lo for n in ALL_FMTS for lo in _layouts(n)])
def test_digit_planes_are_the_jax_terms_and_sum_to_its_decode(name, nibble):
    tf, jf = _fmt(telp, name), _fmt(jelp, name)
    raw, stored = _codes(tf, 37, 21, nibble)
    planes = ref.digit_planes(stored, tf, nibble)
    assert planes.dtype == torch.bfloat16
    assert tuple(planes.shape) == (len(tf.digits), 37 + (37 % 2 if nibble else 0), 21)
    planes = planes[:, :37]
    for d, (sign, shift) in enumerate(jf.shift_add_terms()):
        want = np.ldexp(sign.astype(np.float32), shift)[raw]
        np.testing.assert_array_equal(planes[d].float().numpy(), want, err_msg=f"digit {d}")
    total = planes[0].float()
    for p in planes[1:]:
        total = total + p.float()
    want = np.asarray(jref.decode_values_shift_add(jnp.asarray(raw), jf))
    np.testing.assert_array_equal(total.numpy().view(np.int32), want.view(np.int32))


def _prmt(x, y, s):
    """PTX ``prmt.b32`` (default mode) on numpy uint64 arrays."""
    out = np.zeros_like(x)
    for n in range(4):
        sel = (s >> (4 * n)) & 7
        byte = np.where(sel < 4, x >> (8 * (sel % 4)), y >> (8 * (sel % 4))) & 0xFF
        out |= byte << (8 * n)
    return out


def _plane_term2(p, w):
    """numpy twin of ``csrc/hopper.cuh::plane_term2``: one digit's bf16x2 terms of
    code pairs ``p`` (even row's code in bits 0-7, odd row's in 16-23)."""
    idx = (p >> w[2]) & w[3]
    e = _prmt(np.full_like(p, w[0]), np.full_like(p, w[1]), (idx | (idx >> 8)) & 0xFFFF)
    return (((e & 0x00FF00FF) << 7) | ((p << w[4]) & w[5])) & 0xFFFFFFFF


@pytest.mark.parametrize("name", PLANE_FMTS + ["elp_bsd_b7", "elp_bsd_d6"])
def test_plane_words_drive_the_kernels_decode_to_the_planes(name):
    fmt = _fmt(telp, name)
    words = ref.plane_words(fmt)
    assert words[0] == len(fmt.digits)
    assert len(words) == 1 + ref.MAX_PLANES * ref.PLANE_WORDS
    n = 2 ** fmt.bits_per_weight
    lo = np.repeat(np.arange(n, dtype=np.uint64), n)
    hi = np.tile(np.arange(n, dtype=np.uint64), n)
    planes = ref.digit_planes(torch.arange(n), fmt).view(torch.int16).numpy().astype(np.uint64)
    planes &= 0xFFFF
    for d in range(words[0]):
        w = [np.uint64(v) for v in words[1 + ref.PLANE_WORDS * d: 1 + ref.PLANE_WORDS * (d + 1)]]
        got = _plane_term2(lo | (hi << np.uint64(16)), w)
        np.testing.assert_array_equal(got, planes[d][lo] | (planes[d][hi] << np.uint64(16)),
                                      err_msg=f"digit {d}")


def test_plane_words_refuse_what_the_planes_do_not_take():
    for fmt in (_fmt(telp, "wide4_d4"), telp.FORMAT_A,
                telp.ElpBsdFormat((telp.DigitSpec((0,)), telp.DigitSpec((130,))), name="big")):
        assert not ref.planes_ok(fmt)
        with pytest.raises(ValueError, match="digit-plane kernels take"):
            ref.plane_words(fmt)


def _padded(a, rows, cols):
    out = np.zeros((rows, cols), a.dtype)
    out[: a.shape[0], : a.shape[1]] = a
    return out


def _up(v, b=32):
    return -(-v // b) * b


# (format, nibble, M, K, N): ragged M, K and N, odd K on nibble codes (the pad row).
MODEL_CASES = [("wide_b7", False, 37, 70, 34), ("wide3_d7", False, 16, 96, 40),
               ("shifts_0_9", True, 21, 71, 33), ("wide3_n4", True, 9, 64, 64)]


@pytest.mark.parametrize("kernel", ["tiled", "fused"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name,nibble,m,k,n", MODEL_CASES)
def test_digits_model_matches_the_jax_kernels(kernel, dtype, name, nibble, m, k, n):
    tf, jf = _fmt(telp, name), _fmt(jelp, name)
    raw, stored = _codes(tf, k, n, nibble, seed=m)
    rng = np.random.default_rng(k)
    x32 = rng.normal(size=(m, k)).astype(np.float32)
    xt = torch.from_numpy(x32).to(getattr(torch, dtype))
    sf = np.float32(0.0131)
    got = ref.elp_bsd_matmul_digits(xt, stored, torch.tensor(sf), tf, nibble=nibble,
                                    terms=1 if dtype == "bfloat16" else 3)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    # The Pallas kernels tile evenly: zero-padded x and codes, the output cut back.
    kp, np_ = _up(k), _up(n)
    xj = jnp.asarray(_padded(xt.float().numpy(), _up(m) if kernel == "tiled" else m, kp))
    xj = xj.astype(jnp.bfloat16) if dtype == "bfloat16" else xj
    cj = jnp.asarray(_padded(stored.numpy(), kp // 2 if nibble else kp, np_))
    sfj = jnp.full((1, 1), sf)
    if kernel == "tiled":
        want = jtiled(xj, cj, sfj, jf, nibble=nibble, block_m=32, block_n=32, block_k=32,
                      out_dtype=jnp.float32, interpret=True)
    else:
        want = jfused(xj, cj, sfj, jf, nibble=nibble, block_n=32, block_k=32,
                      out_dtype=jnp.float32, interpret=True)
    want = np.asarray(want)[:m, :n]
    err = np.abs(got.numpy() - want).max()
    assert err <= REL_TOL * np.abs(want).max(), err
    # The control: one bf16 term of a float32 x is not the product.
    if dtype == "float32":
        one = ref.elp_bsd_matmul_digits(xt, stored, torch.tensor(sf), tf, nibble=nibble, terms=1)
        assert np.abs(one.numpy() - want).max() > REL_TOL * np.abs(want).max()


def test_digit_planes_beat_the_reference_where_a_span_passes_float32():
    """Digits 26 places apart: the reference's float32 decode of 2^26 ± 2^9 ± 1
    drops the 1, the planes keep it, so the digits model is closer to the
    exact product than the reference (and the gate, relative to max |ref|,
    still holds). (Two digits 30 places apart decode to ±2^30 in float32:
    bf16-exact after the rounding, so the table routes take them as the
    reference rounds them.)"""
    shifts = ((0,), (9,), (26,))
    tf = telp.ElpBsdFormat(tuple(telp.DigitSpec(t) for t in shifts), name="span26")
    jf = jelp.ElpBsdFormat(tuple(jelp.DigitSpec(t) for t in shifts), name="span26")
    assert ref.planes_ok(tf) and not ref.bf16_exact(tf)
    raw, stored = _codes(tf, 64, 32, False, seed=26)
    x = torch.from_numpy(np.random.default_rng(26).normal(size=(8, 64)).astype(np.float32))
    sf = np.float32(1.0)
    got = ref.elp_bsd_matmul_digits(x, stored, torch.tensor(sf), tf, terms=3).double().numpy()
    want = np.asarray(jfused(jnp.asarray(x.numpy()), jnp.asarray(raw), jnp.full((1, 1), sf), jf,
                             block_n=32, block_k=32, out_dtype=jnp.float32, interpret=True))
    exact = x.double().numpy() @ np.asarray(telp.decode_codes(raw, tf))
    assert np.abs(got - exact).max() < np.abs(want - exact).max()
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()


def test_route_rule_takes_the_digit_routes_without_launching():
    x = torch.zeros(16, 64)
    for name in PLANE_FMTS:
        fmt = _fmt(telp, name)
        assert not ref.bf16_exact(fmt) and ref.planes_ok(fmt), name
        for r in (mm.route, fd.route):
            assert r(x.to(torch.bfloat16), fmt) == "wgmma_digits"
            assert r(x, fmt) == "bf16x3_digits"
            assert r(x.half(), fmt) == "bf16x3_digits"
            assert r(x.double(), fmt) == "f32"
    wide4 = _fmt(telp, "wide4_d4")
    for r in (mm.route, fd.route):
        for xx in (x, x.to(torch.bfloat16), x.half(), x.double()):
            assert r(xx, wide4) == "f32"
        for fmt in telp.PRESET_FORMATS.values():
            assert r(x.to(torch.bfloat16), fmt) == "wgmma" and r(x, fmt) == "bf16x3"
    assert mm.ROUTES == fd.ROUTES == ("wgmma", "bf16x3", "wgmma_digits", "bf16x3_digits", "f32")
    # the CPU runs the plain version; no route counts a launch
    wide = _fmt(telp, "wide_b7")
    before = (dict(mm.elp_bsd_matmul.launches_by_route),
              dict(fd.fused_decode_matmul.launches_by_route))
    codes = torch.from_numpy(_codes(wide, 64, 8, False)[1].numpy())
    for kern in (mm.elp_bsd_matmul, fd.fused_decode_matmul):
        out = kern(x, codes, 0.5, wide, out_dtype=torch.float32)
        np.testing.assert_array_equal(
            out.numpy(), mm.elp_bsd_matmul_plain(x, codes, torch.tensor(0.5), wide).numpy())
    assert (mm.elp_bsd_matmul.launches_by_route, fd.fused_decode_matmul.launches_by_route) == \
        before


def test_alexnet_mini_packed_with_a_wide_format(monkeypatch):
    from repro import api_schemes as japi
    from repro.kernels import ops as jops
    from repro.models import cnn as jcnn
    from repro_torch import api_schemes as tapi
    from repro_torch.kernels import ops as tops
    from repro_torch.models import cnn as tcnn

    name = "wide_b7"
    tf, jf = _fmt(telp, name), _fmt(jelp, name)
    monkeypatch.setitem(jelp.PRESET_FORMATS, name, jf)
    monkeypatch.setitem(telp.PRESET_FORMATS, name, tf)
    jspec, tspec = jcnn.ALEXNET_MINI, tcnn.ALEXNET_MINI
    tparams = tcnn.init_params(tspec, seed=0, device="cpu")
    jparams = {k: jnp.asarray(v.numpy()) for k, v in tparams.items()}
    # Algorithm 1 off for the net (the JAX package compiles it per weight
    # shape, seconds each); on for one weight below.
    jp = japi.pack_cnn_params(jparams, jf, compensate=False)
    tp = tapi.pack_cnn_params(tparams, tf, compensate=False)
    packed = [k for k in jp if k.endswith("_w")]
    assert packed
    for k in packed:
        assert (tp[k].fmt_name, tp[k].nibble) == (name, False)
        np.testing.assert_array_equal(tp[k].codes.numpy(), np.asarray(jp[k].codes), err_msg=k)
        np.testing.assert_array_equal(tp[k].sf.numpy(), np.asarray(jp[k].sf), err_msg=k)
    jc, _ = jops.pack_conv_weight(jparams["conv1_w"], jf, compensate=True)
    tc, _ = tops.pack_conv_weight(tparams["conv1_w"], tf, compensate=True)
    np.testing.assert_array_equal(tc.codes.numpy(), np.asarray(jc.codes))
    assert not np.array_equal(tc.codes.numpy(), tp["conv1_w"].codes.numpy())
    x = np.random.default_rng(0).normal(size=(6, 32, 32, 3)).astype(np.float32)
    jl = np.asarray(jax.jit(lambda p, v: jcnn.forward(p, jspec, v))(jp, jnp.asarray(x)))
    tl = tcnn.forward(tp, tspec, torch.from_numpy(x)).numpy()
    assert tl.shape == jl.shape
    assert np.abs(tl - jl).max() <= 1e-4 * np.abs(jl).max()
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    # The digit routes' arithmetic (float32 x: bf16x3_digits) in place of the
    # plain versions: the same logits.
    def digits(x, codes, sf, fmt, *, nibble=False, out_dtype=None):
        assert mm.route(x, fmt) == "bf16x3_digits"
        out = ref.elp_bsd_matmul_digits(x, codes, sf, fmt, nibble=nibble, terms=3)
        return out.to(out_dtype or x.dtype)

    monkeypatch.setattr(mm, "elp_bsd_matmul_plain", digits)
    monkeypatch.setattr(fd, "fused_decode_matmul_plain", digits)
    dl = tcnn.forward(tp, tspec, torch.from_numpy(x)).numpy()
    assert np.abs(dl - jl).max() <= 1e-4 * np.abs(jl).max()
    np.testing.assert_array_equal(dl.argmax(-1), jl.argmax(-1))

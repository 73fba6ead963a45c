"""Float32 flash attention's bf16x3 route, on the CPU, against the JAX package.

Float32 q, k and v reach the tensor-core kernel split exactly into three
bf16 terms each (``csrc/flash_attention_wgmma.cu``'s second kernel), with P
split the same way, and each product is a sum of float32 cross-products of
the terms. ``repro_torch.kernels.ref.flash_attention_bf16x3`` models that
arithmetic (the splits, the chosen cross-products summed smallest first, the
online softmax over 64-key tiles in log2 units, each tile's P V summed into a
zeroed float32 sum); here the model meets the JAX Pallas kernel in interpret
mode on float32 inputs, elementwise within 2e-5 of max |out| (the float32
tolerance of the port's flash tests), over both head widths, both masks,
grouped-query heads, a query offset, ragged key counts and a 4096-key
sequence. The kernel's products (``ref.FLASH_ROUTE_PRODUCTS``: six for S,
five for P V) are the fewest whose worst error stays under half that limit
at every shape; the controls print what each smaller set reads. Then the
slice: lm-100m's config cut to 2 layers at full width through the port (its
CPU path, and with flash swapped for the route's model) and through the JAX
package, greedy tokens equal and logits within 1e-4 of max |logit|. The
kernel itself is held against the plain version on the card
(``tests/test_torch_gpu.py``).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from repro.configs.base import ArchConfig as JCfg  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve.engine import ServeSetup as JSetup  # noqa: E402
from repro.serve.engine import static_generate as jgen  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.configs.base import ArchConfig as TCfg  # noqa: E402
from repro_torch.experiments.train_lm import CFG as LM100M  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402

LIMIT = 2e-5  # of max |out|
RULE = 0.5  # the chosen products' worst error, in limits, at every shape
# (B, H, KVH, Sq, Sk, hd, q_offset, causal, JAX block_q, JAX block_k): the JAX
# kernel takes repeated heads and no offset, so the queries are preceded by
# q_offset zero rows there (rows are independent) and the blocks divide the
# padded lengths; a ragged Sk is a block_k that divides it.
SHAPES = [
    (1, 2, 2, 256, 256, 64, 0, True, 128, 128),
    (1, 2, 2, 256, 256, 64, 0, False, 128, 128),
    (2, 4, 4, 384, 384, 128, 0, True, 128, 128),
    (2, 4, 4, 384, 384, 128, 0, False, 128, 128),
    (2, 8, 2, 256, 256, 128, 0, True, 128, 128),
    (1, 4, 2, 128, 256, 128, 128, True, 128, 128),
    (1, 2, 2, 128, 200, 64, 72, True, 40, 40),
    (1, 2, 2, 128, 200, 64, 0, False, 128, 40),
    (1, 2, 2, 4096, 4096, 128, 0, True, 1024, 1024),
    (1, 2, 2, 4096, 4096, 128, 0, False, 1024, 1024),
]
IDS = [f"q{b}x{h}x{sq}x{hd}-kv{kvh}x{sk}-off{off}-{'causal' if c else 'full'}"
       for b, h, kvh, sq, sk, hd, off, c, _, _ in SHAPES]
# The largest sets of fewer products than the route's: every set of fewer
# products is a subset of one of them. Beside them, one product each (the hi
# terms alone): far over the limit everywhere.
SMALLER = ((6, 4), (5, 5), (4, 6))
GROSS = ((1, 1),)
SETS = (ref.FLASH_ROUTE_PRODUCTS,) + SMALLER + GROSS


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file: the test runner puts several workers on
    one host, where oversubscribed torch threads slow small ops many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _case(i: int):
    """Seeded float32 q, k, v of SHAPES[i] (torch) and the JAX kernel's output (numpy)."""
    b, h, kvh, sq, sk, hd, off, causal, bq, bk = SHAPES[i]
    rng = np.random.default_rng(100 + i)
    q = rng.normal(size=(b, h, sq, hd)).astype(np.float32)
    k, v = (rng.normal(size=(b, kvh, sk, hd)).astype(np.float32) for _ in range(2))
    qj = np.concatenate([np.zeros((b, h, off, hd), np.float32), q], 2)
    rep = lambda t: jnp.repeat(jnp.asarray(t), h // kvh, axis=1)  # noqa: E731
    want = np.asarray(jflash(jnp.asarray(qj), rep(k), rep(v), causal=causal, block_q=bq,
                             block_k=bk, interpret=True))[:, :, off:]
    return tuple(map(torch.from_numpy, (q, k, v))), want


@functools.lru_cache(maxsize=None)
def _readings(i: int) -> dict:
    """Worst |model - JAX kernel| / (LIMIT * max |JAX kernel|) at SHAPES[i], for
    each product set of SETS (one pass of the model shares their S products)."""
    (q, k, v), want = _case(i)
    causal, off = SHAPES[i][7], SHAPES[i][6]
    outs = ref._flash_bf16x3_sets(q, k, v, causal, off, list(SETS))
    return {s: float(np.abs(o.numpy() - want).max() / (LIMIT * np.abs(want).max()))
            for s, o in zip(SETS, outs)}


def _reading(i: int, products) -> float:
    return _readings(i)[products]


@pytest.mark.parametrize("i", range(len(SHAPES)), ids=IDS)
def test_model_matches_jax_kernel(i):
    """The route's arithmetic within the float32 limit, and within the product
    rule's half of it."""
    r = _reading(i, ref.FLASH_ROUTE_PRODUCTS)
    print(f"{IDS[i]}: products {ref.FLASH_ROUTE_PRODUCTS} read {r:.3f} of the limit")
    assert r <= RULE


@pytest.mark.parametrize("i", [5, 6])
def test_public_model_is_the_shared_pass(i):
    """``flash_attention_bf16x3`` alone gives the shared pass's output, bit for bit."""
    (q, k, v), _ = _case(i)
    causal, off = SHAPES[i][7], SHAPES[i][6]
    got = ref.flash_attention_bf16x3(q, k, v, causal=causal, q_offset=off)
    shared = ref._flash_bf16x3_sets(q, k, v, causal, off, list(SETS))[0]
    assert got.dtype == torch.float32 and torch.equal(got, shared)


@pytest.mark.parametrize("i", range(len(SHAPES)), ids=IDS)
def test_smaller_product_sets(i):
    """What each smaller set of cross-products reads at the same shape; the
    gross set (the hi terms alone) is over the limit everywhere."""
    for products in SMALLER + GROSS:
        print(f"{IDS[i]}: products {products} read {_reading(i, products):.3f} of the limit")
    for products in GROSS:
        assert _reading(i, products) > 1.0


def test_route_products_are_the_fewest_under_the_rule():
    """Each set of fewer products reads above the rule's half limit at some shape,
    so none could replace the route's."""
    assert sum(ref.FLASH_ROUTE_PRODUCTS) == 11 and ref.FLASH_PRODUCTS[:6] == (
        (0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))
    for products in SMALLER:
        worst = max(_reading(i, products) for i in range(len(SHAPES)))
        print(f"products {products}: worst over the shapes {worst:.3f} of the limit")
        assert worst > RULE


def _split_sum(sa: tuple, sb: tuple, n: int) -> torch.Tensor:
    """``a @ b`` (float32) from the first ``n`` of FLASH_PRODUCTS of the splits
    ``sa`` of a and ``sb`` of b, each product in float32, summed smallest first
    (as the kernel issues them)."""
    out = None
    for i, j in reversed(ref.FLASH_PRODUCTS[:n]):
        t = sa[i] @ sb[j]
        out = t if out is None else out + t
    return out


def test_split_products_are_exact_per_term_pair():
    """A cross-product of two split terms is exact in float32 (8 significant bits
    each), so the model's products differ from the float32 product only by the
    dropped terms and the order of the sums: all six sum to the float32 dot
    product within float32 rounding."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(64, 128)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(128, 64)).astype(np.float32))
    sa, sb = ref.split_bf16x3(a), ref.split_bf16x3(b)
    for i, j in ref.FLASH_PRODUCTS:
        x, y = sa[i].double(), sb[j].double()
        assert torch.equal((sa[i][:, :1] * sb[j][:1, :]).double(), x[:, :1] * y[:1, :])
    got = _split_sum(sa, sb, 6).double()
    exact = a.double() @ b.double()
    assert (got - exact).abs().max().item() <= 1e-5 * exact.abs().max().item()


# ---------------------------------------------------------------------------
# The slice: lm-100m at full width, 2 of its 16 layers
# ---------------------------------------------------------------------------
LM_LAYERS, LM_PROMPT, LM_NEW = 2, 64, 4


def _flash_model(q, k, v, *, causal=True, block_q=128, block_k=128, q_offset=0):
    """The route's model under the kernel wrapper's signature."""
    return ref.flash_attention_bf16x3(q, k, v, causal=causal, q_offset=q_offset).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _lm_slice():
    """The JAX package's greedy tokens and teacher-forced logits for the cut
    config, and the port's config, packed model (float activations) and prompts."""
    spec = {f.name: getattr(LM100M, f.name) for f in dataclasses.fields(LM100M)
            if f.name in {g.name for g in dataclasses.fields(JCfg)}}
    jc, tc = JCfg(**{**spec, "n_layers": LM_LAYERS}), TCfg(**{**spec, "n_layers": LM_LAYERS})
    assert (tc.d_model, tc.n_heads, tc.n_kv_heads, tc.hd, tc.vocab, tc.dtype_str) == (
        512, 8, 4, 64, 32000, "float32")
    jp, tparams = tp.lm_params(jc)
    prompts = np.random.default_rng(4).integers(0, jc.vocab, (2, LM_PROMPT)).astype(np.int32)
    jq = tp.jax_pack_lm(jp, jc)
    setup = JSetup(cfg=jc, mesh=None, max_len=LM_PROMPT + LM_NEW, batch=2)
    want = np.asarray(jgen(setup, jq, {"tokens": jnp.asarray(prompts)}, LM_NEW))
    # its logits, teacher-forced on its tokens
    cache = jtr.init_cache(jc, 2, LM_PROMPT + LM_NEW)
    logits, cache = jax.jit(lambda p, t, c: jtr.prefill(p, jc, t, c))(jq, jnp.asarray(prompts),
                                                                       cache)
    jlogits = [np.asarray(logits)]
    step = jax.jit(lambda p, t, c, pos: jtr.decode_step(p, jc, t, c, pos))
    for i in range(LM_NEW - 1):
        logits, cache = step(jq, jnp.asarray(want[:, i:i + 1]), cache, jnp.int32(LM_PROMPT + i))
        jlogits.append(np.asarray(logits))
    qm = api.quantize(tc, tparams, api.QuantScheme(fmt="elp4", act="float"), device="cpu")
    return tc, qm, prompts, want, jlogits


@pytest.mark.parametrize("flash", ["plain", "bf16x3 model"])
def test_lm100m_slice_matches_reference(flash, monkeypatch):
    """Greedy tokens equal and teacher-forced logits within 1e-4 of max |logit|,
    with the port's CPU flash (the plain version) and with the route's model."""
    tc, qm, prompts, want, jlogits = _lm_slice()
    if flash != "plain":
        monkeypatch.setattr(ttr, "flash_attention", _flash_model)
    got = qm.generate(prompts, LM_NEW).numpy()
    assert np.array_equal(got, want), (got, want)
    cache = ttr.init_cache(tc, 2, LM_PROMPT + LM_NEW, device="cpu")
    logits, cache = ttr.prefill(qm.params, tc, torch.from_numpy(prompts), cache)
    rels = [float(np.abs(logits.numpy() - jlogits[0]).max() / np.abs(jlogits[0]).max())]
    for i in range(LM_NEW - 1):
        logits, cache = ttr.decode_step(qm.params, tc, torch.from_numpy(want[:, i:i + 1].copy()),
                                        cache, LM_PROMPT + i)
        rels.append(float(np.abs(logits.numpy() - jlogits[i + 1]).max()
                          / np.abs(jlogits[i + 1]).max()))
    print(f"lm-100m x {LM_LAYERS} layers, flash {flash}: logits against the JAX package, "
          f"max |diff| / max |logit| per position {[f'{r:.2e}' for r in rels]}")
    assert max(rels) <= 1e-4, rels

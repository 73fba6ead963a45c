"""The step-cost counters (``launch/hlo_stats.py``, ``runtime/cost.py``) and the
repaired ``ServeEngine.decode_cost``.

* the kernel wrappers' and the collectives' ``meta`` path: the plain version's
  shape and dtype, nothing launched or issued, and any other device refused;
* the wire-byte rule per kind against the reference's ``collective_stats`` on
  HLO lines written for the same kind, shape, dtype and group size;
* ``count_cost`` of a reduced dense prefill, decode and train step against an
  independent count from the config's dimensions (2 per multiply-add of every
  product, attention included), and the ``meta`` count against the same step
  run for real on the CPU: FLOPs, bytes, wire bytes and kernel calls equal;
* the byte rule on a few ops, and a decode step's least traffic (arguments
  read once, outputs written once), against counts worked out by hand;
* the FLOPs of a 4-layer config less a 2-layer one's: twice one layer's (every
  layer of the Python loop is counted, which is why ``body_probe`` has no
  counterpart);
* ``decode_cost`` over 4 ``gloo`` ranks on ``(1, 4)`` and ``(2, 2)``
  (``tests/torch_cost_ranks.py``, helpers of ``tests/torch_engine_ranks.py``)
  against a real decode step on each rank and the JAX engine's compiled cost
  on 4 fake devices; a hybrid with fewer query heads than model ranks; and an
  expert-parallel MoE train step's wire bytes, forward and backward, against
  ``WIRE_BYTES``, its ``meta`` count and a count from the config.
"""
import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_cost_ranks as R  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul, elp_bsd_matmul_plain  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain  # noqa: E402
from repro_torch.kernels.fused_decode import fused_decode_matmul  # noqa: E402
from repro_torch.launch import hlo_stats  # noqa: E402
from repro_torch.launch.dryrun import fake_group  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.runtime import collectives  # noqa: E402
from repro_torch.runtime.train_loop import TrainSetup, init_opt_state, make_train_step  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
CFG = get_config("qwen3_8b").reduced()  # float32, 2 layers, d 64, 4 heads (2 KV), hd 16
B, S, MAX_LEN = 2, 128, 160  # S tiles the flash kernel's block: no padded queries


def _wrappers():
    return (elp_bsd_matmul, fused_decode_matmul, flash_attention)


def _launches():
    return [(w.launches, dict(w.launches_by_route)) for w in _wrappers()]


# ---------------------------------------------------------------------------
# The meta path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nibble", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", [elp_bsd_matmul, fused_decode_matmul])
def test_matmul_meta_path_counts_and_launches_nothing(kernel, dtype, nibble):
    from repro_torch.core.elp_bsd import resolve_format

    fmt = resolve_format("elp4")
    rng = np.random.default_rng(0)
    k, n = 33, 24
    x = torch.from_numpy(rng.standard_normal((5, k)).astype(np.float32)).to(dtype)
    codes = torch.from_numpy(rng.integers(0, 256, ((k + 1) // 2 if nibble else k, n),
                                          dtype=np.uint8))
    sf = torch.tensor([0.5])
    want = elp_bsd_matmul_plain(x, codes, sf, fmt, nibble=nibble)
    before = _launches()
    args = (x.to("meta"), codes.to("meta"), sf.to("meta"))
    with hlo_stats.count_cost() as meta:
        got = kernel(*args, fmt, nibble=nibble)
    with hlo_stats.count_cost() as real:
        kernel(x, codes, sf, fmt, nibble=nibble)
    assert got.is_meta and got.shape == want.shape and got.dtype == want.dtype
    assert _launches() == before
    route = "wgmma" if dtype == torch.bfloat16 else "bf16x3"
    assert meta.kernels == {f"{kernel.__name__}/{route}": 1}
    assert real.kernels == {f"{kernel.__name__}/plain": 1}
    assert meta.flops == real.flops == 2.0 * 5 * k * n
    assert meta.bytes_accessed == real.bytes_accessed == (
        x.numel() * x.element_size() + codes.numel() + 4 + 5 * n * 4)


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 3), (False, 0)])
def test_flash_meta_path_counts_and_launches_nothing(causal, q_offset):
    from repro_torch.kernels.flash_attention import attention_pairs

    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 4, 128, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 2, 70, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 2, 70, 16)).astype(np.float32))
    want = flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    before = _launches()
    args = [t.to(torch.bfloat16).to("meta") for t in (q, k, v)]
    with hlo_stats.count_cost() as meta:
        got = flash_attention(*args, causal=causal, q_offset=q_offset)
    with hlo_stats.count_cost() as real:
        out = flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    assert got.is_meta and got.shape == want.shape and got.dtype == torch.bfloat16
    assert torch.equal(out, want) and _launches() == before
    assert meta.kernels == {"flash_attention/wgmma": 1}
    assert real.kernels == {"flash_attention/plain": 1}
    pairs = sum(min(q_offset + i + 1, 70) if causal else 70 for i in range(128))
    assert attention_pairs(128, 70, causal, q_offset) == pairs
    assert real.flops == 4.0 * 16 * 2 * 4 * pairs
    assert real.bytes_accessed == 4 * (2 * q.numel() + 2 * k.numel())
    assert meta.flops == real.flops and meta.bytes_accessed == real.bytes_accessed / 2


class _OddDevice(torch.Tensor):
    """A CPU tensor that reports a device that is neither cuda, cpu nor meta."""

    @property
    def device(self):
        return torch.device("xpu")


def test_other_devices_still_raise():
    from repro_torch.core.elp_bsd import resolve_format

    fmt = resolve_format("elp4")
    x = torch.Tensor._make_subclass(_OddDevice, torch.zeros(2, 4))
    codes = torch.zeros(2, 3, dtype=torch.uint8)
    for kernel in (elp_bsd_matmul, fused_decode_matmul):
        with pytest.raises(ValueError, match="cuda or cpu"):
            kernel(x, codes, torch.ones(1), fmt, nibble=True)
    q = torch.Tensor._make_subclass(_OddDevice, torch.zeros(1, 2, 128, 16))
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(q, q, q)


# ---------------------------------------------------------------------------
# Wire bytes
# ---------------------------------------------------------------------------
_HLO = {  # the port's kind -> (HLO op, how its groups are written)
    "all_reduce": "all-reduce", "all_gather": "all-gather",
    "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
}


@pytest.mark.parametrize("g", [2, 4, 16])
@pytest.mark.parametrize("dtype,hlo_dt", [(torch.float32, "f32"), (torch.bfloat16, "bf16")])
@pytest.mark.parametrize("kind", sorted(_HLO))
def test_wire_byte_rule_matches_the_reference(kind, dtype, hlo_dt, g):
    pytest.importorskip("jax")
    from repro.launch.hlo_stats import collective_stats

    shape = (8, 64)
    groups = "{{" + ",".join(map(str, range(g))) + "}}"
    line = (f"  %c.1 = {hlo_dt}[{','.join(map(str, shape))}]{{1,0}} {_HLO[kind]}("
            f"{hlo_dt}[8,64]{{1,0}} %p), channel_id=1, replica_groups={groups}")
    tiled = line.replace(f"replica_groups={groups}", f"replica_groups=[{16 // g},{g}]<=[16]")
    result_bytes = 8 * 64 * torch.empty((), dtype=dtype).element_size()
    for text in (line, tiled):
        st = collective_stats(text)
        assert st.count == 1
        assert collectives.wire_bytes(kind, result_bytes, g) == pytest.approx(
            st.per_device_bytes, rel=1e-12)


def test_meta_collectives_count_what_they_would_send():
    """Each collective on ``meta`` over a fake group of 4: the result's shape, the
    wire bytes of the rule, nothing issued."""
    from torch.distributed.device_mesh import DeviceMesh

    with fake_group(4):
        group = DeviceMesh("cpu", torch.arange(4).reshape(1, 4),
                           mesh_dim_names=("data", "model")).get_group("model")
        t = torch.empty((8, 6), dtype=torch.bfloat16, device="meta")
        collectives.reset()
        with hlo_stats.count_cost() as c:
            outs = {
                "all_reduce": collectives.all_reduce(t, group),
                "all_gather": collectives.all_gather(t, 0, group, sizes=[8, 8, 8, 6]),
                "reduce_scatter": collectives.reduce_scatter(t, 0, group),
                "all_to_all": collectives.all_to_all(t, group),
            }
        assert sum(collectives.ISSUED.values()) == 0
        assert sum(collectives.WIRE_BYTES.values()) == 0
    assert outs["all_reduce"].shape == (8, 6) and outs["all_gather"].shape == (30, 6)
    assert outs["reduce_scatter"].shape == (2, 6) and outs["all_to_all"].shape == (8, 6)
    b = 8 * 6 * 2
    assert c.by_op == {"all_reduce": 2 * b * 3 / 4, "all_gather": 4 * b * 3 / 4,
                       "reduce_scatter": b / 4 * 3, "all_to_all": b * 3 / 4}
    assert c.collective_calls == dict.fromkeys(outs, 1)


# ---------------------------------------------------------------------------
# count_cost against an independent count, and meta against real
# ---------------------------------------------------------------------------
def _macs(cfg):
    """Multiply-adds a token of one layer's projections and MLP (swiglu)."""
    d, h, kv, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    return 2 * d * h * hd + 2 * d * kv * hd + 3 * d * ff


def _prefill_flops(cfg, b, s):
    """Every layer's products on every token, causal attention on the flash kernel
    (query i sees i + 1 keys: 4·hd per pair), the head on the last position."""
    att = 4 * cfg.hd * b * cfg.n_heads * s * (s + 1) // 2
    return cfg.n_layers * (2 * b * s * _macs(cfg) + att) + 2 * b * cfg.d_model * cfg.vocab


def _decode_flops(cfg, b, max_len):
    """One token a row: the products, attention over the whole cache (masked, not
    skipped), the head."""
    att = 4 * cfg.hd * b * cfg.n_heads * max_len
    return cfg.n_layers * (2 * b * _macs(cfg) + att) + 2 * b * cfg.d_model * cfg.vocab


def _train_flops(cfg, b, s):
    """The reference attention (every query-key pair) and the head on every
    position; the backward doubles every product; remat recomputes each block up
    to its last saved activation, so the MLP's down projection, whose output
    nothing saves, is not recomputed (non-reentrant checkpointing stops early)."""
    layer = 2 * b * s * _macs(cfg) + 4 * cfg.hd * b * cfg.n_heads * s * s
    head = 2 * b * s * cfg.d_model * cfg.vocab
    w2 = 2 * b * s * cfg.d_ff * cfg.d_model
    return cfg.n_layers * (3 * layer + (layer - w2)) + 3 * head


def _step(cfg, params, kind):
    """``(fn, args)`` of one reduced step: a prefill of ``[B, S]`` tokens, a decode step
    at position ``S`` against a ``MAX_LEN`` cache, or a remat train step."""
    api = get_model(cfg)
    rng = np.random.default_rng(2)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    if kind == "train":
        setup = TrainSetup(cfg=cfg, remat=True)
        return make_train_step(setup), (params, init_opt_state(setup, params), None,
                                         {"tokens": tok, "labels": tok.roll(-1, 1)})
    cache = api.init_cache(cfg, B, MAX_LEN, device="cpu")
    if kind == "prefill":
        return (lambda p, t, c: api.prefill(p, cfg, {"tokens": t}, c)), (params, tok, cache)
    return (lambda p, t, c: api.decode_step(p, cfg, t, c, S)), (params, tok[:, :1], cache)


@pytest.fixture(scope="module")
def params():
    return get_model(CFG).init_params(CFG, 0, device="cpu")


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_count_matches_an_independent_count(params, kind):
    fn, args = _step(CFG, params, kind)
    with torch.no_grad() if kind != "train" else torch.enable_grad(), \
            hlo_stats.count_cost() as c:
        fn(*args)
    want = {"prefill": _prefill_flops(CFG, B, S), "decode": _decode_flops(CFG, B, MAX_LEN),
            "train": _train_flops(CFG, B, S)}[kind]
    assert c.flops == want
    assert c.collective_bytes == 0 and c.by_op == {}
    assert c.bytes_accessed > 0 and c.peak_bytes > 0


def test_op_bytes_by_hand():
    """The byte rule on ops counted by hand (float32, int64 indices): a product reads
    both operands and writes its result; a broadcast operand is read once; an
    indexed read reads its indices and the rows it returns and writes them; an
    indexed write in place reads its indices and the values it stores and writes
    them; views move nothing."""
    a, w, bias = torch.randn(4, 8), torch.randn(8, 16), torch.randn(16)
    idx, dst = torch.tensor([0, 2, 3]), torch.zeros(4, 16)

    def f():
        y = a @ w  # 4*8*4 + 8*16*4 read, 4*16*4 written: 896
        z = y + bias.expand(4, 16)  # 256 + 16*4 (stride 0: once) read, 256 written: 576
        u = z * 2.0  # 256 + 256: 512
        r = u[idx]  # 3*8 of indices, 3*16*4 read and written: 408
        dst.index_put_((idx,), r)  # the same: 408
        return r.view(-1)  # 0

    with hlo_stats.count_cost() as c:
        f()
    assert c.bytes_accessed == 896 + 576 + 512 + 408 + 408
    assert c.flops == 2 * 4 * 8 * 16


def test_decode_least_bytes_by_hand(params):
    """``min_bytes`` of the reduced decode step, from the config's dimensions: every
    parameter, the float32 K/V cache and the int32 tokens read once, the float32
    ``[B, 1, V]`` logits written once (the cache is written in place: no fresh
    output). The eager traffic is larger: every op's reads and writes."""
    d, h, kv, hd, ff, v, n = (CFG.d_model, CFG.n_heads, CFG.n_kv_heads, CFG.hd, CFG.d_ff,
                              CFG.vocab, CFG.n_layers)
    layer = 2 * d + d * h * hd + 2 * d * kv * hd + h * hd * d + 2 * hd + 3 * d * ff
    weights = 4 * (v * d + n * layer + d + d * v)
    cache = 4 * 2 * n * B * MAX_LEN * kv * hd
    fn, args = _step(CFG, params, "decode")
    with torch.no_grad():
        rec = hlo_stats.step_cost(fn, *args)
    m = rec["memory"]
    assert m["argument_bytes"] == weights + cache + 4 * B
    assert m["output_bytes"] == 4 * B * v
    assert rec["min_bytes"] == weights + cache + 4 * B + 4 * B * v
    assert rec["bytes_accessed"] > rec["min_bytes"]


@pytest.mark.parametrize("kind", ["prefill", "decode", "train", "packed_decode",
                                  "packed_prefill"])
def test_meta_count_equals_the_real_count(params, kind):
    tree = params
    if kind.startswith("packed"):
        from repro_torch import api

        tree = api.quantize(CFG, params, api.QuantScheme(fmt="elp4"), device="cpu").params
    fn, args = _step(CFG, tree, kind.split("_")[-1])
    grad = torch.enable_grad() if kind == "train" else torch.no_grad()
    with grad:
        meta = hlo_stats.step_cost(fn, *args)
    with grad, hlo_stats.count_cost() as real:
        fn(*args)
    assert meta["flops"] == real.flops > 0
    assert meta["bytes_accessed"] == real.bytes_accessed > 0
    assert meta["collective_bytes"] == real.collective_bytes == 0
    assert hlo_stats.StepCost(kernels=meta["kernels"]).kernel_calls() == real.kernel_calls()
    assert all(k.endswith("/plain") for k in real.kernels)
    if kind == "packed_decode":
        assert real.kernel_calls() == {"fused_decode_matmul": 7 * CFG.n_layers}
    assert meta["memory"]["argument_bytes"] == hlo_stats.tree_bytes(args)


def test_every_layer_is_counted():
    """FLOPs(4 layers) - FLOPs(2 layers) = 2 x FLOPs(one layer), for a prefill and a
    train step: no layer body is counted once."""
    out = {}
    for n in (2, 4):
        cfg = dataclasses.replace(CFG, n_layers=n)
        p = get_model(cfg).init_params(cfg, 0, device="meta")
        for kind in ("prefill", "train"):
            fn, args = _step(cfg, p, kind)
            with torch.no_grad() if kind == "prefill" else torch.enable_grad():
                out[n, kind] = hlo_stats.step_cost(fn, *args)["flops"]
    one = {"prefill": _prefill_flops(CFG, B, S) - _prefill_flops(
        dataclasses.replace(CFG, n_layers=1), B, S)}
    one["train"] = _train_flops(CFG, B, S) - _train_flops(dataclasses.replace(CFG, n_layers=1),
                                                          B, S)
    for kind in ("prefill", "train"):
        assert out[4, kind] - out[2, kind] == 2 * one[kind]


def test_roofline_terms_use_the_card_and_its_links():
    t = hlo_stats.roofline_terms(989e12, 3.35e12, 50e9, min_bytes_per_device=3.35e11)
    assert t["compute_s"] == pytest.approx(1.0) and t["memory_s"] == pytest.approx(1.0)
    assert t["min_memory_s"] == pytest.approx(0.1)
    assert t["collective_s"] == pytest.approx(1.0)
    assert hlo_stats.link_bandwidth(None) == hlo_stats.NVLINK_BW
    from repro_torch.launch.dryrun import grid_mesh

    with fake_group(256):
        assert hlo_stats.link_bandwidth(grid_mesh((16, 16))) == hlo_stats.IB_BW
    with fake_group(4):
        assert hlo_stats.link_bandwidth(grid_mesh((2, 2))) == hlo_stats.NVLINK_BW


# ---------------------------------------------------------------------------
# decode_cost over 4 gloo ranks, and the reference's compiled cost
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp

    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("cost_ranks")
    inputs = str(d / "inputs.npz")
    R.make_inputs(inputs)
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={R.WORLD}",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen([sys.executable, R.__file__, "jax", inputs, str(d / "jax.npz")],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        mp.spawn(R.rank_main, args=(R.WORLD, str(d / "store"), inputs, str(d)), nprocs=R.WORLD,
                 join=True)
    finally:
        _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return dict(np.load(d / "jax.npz")), [dict(np.load(d / f"rank{r}.npz"))
                                          for r in range(R.WORLD)]


@pytest.mark.parametrize("mesh", sorted(R.MESHES))
def test_decode_cost_is_the_ranks_real_step(ranks, mesh):
    """On each rank: nonzero wire bytes, equal to what ``WIRE_BYTES`` counted over one
    real decode step on that rank; FLOPs and bytes equal to that step's count;
    nothing issued by ``decode_cost`` itself."""
    _, rs = ranks
    for r in rs:
        assert r[f"{mesh}/issued_by_cost"] == 0
        assert r[f"{mesh}/cost/collective_bytes"] > 0
        assert r[f"{mesh}/cost/collective_bytes"] == r[f"{mesh}/real/wire_bytes"]
        assert r[f"{mesh}/real/collective_bytes"] == r[f"{mesh}/real/wire_bytes"]
        for k in ("flops", "bytes_accessed"):
            assert r[f"{mesh}/cost/{k}"] == r[f"{mesh}/real/{k}"] > 0
        by_op = {k.rsplit("/", 1)[1]: v for k, v in r.items()
                 if k.startswith(f"{mesh}/cost/by_op/")}
        real = {k.rsplit("/", 1)[1]: v for k, v in r.items()
                if k.startswith(f"{mesh}/real/wire/") and v}
        assert by_op == real


def test_decode_cost_without_a_mesh_sends_nothing(ranks):
    _, rs = ranks
    for r in rs:
        assert r["none/cost/collective_bytes"] == 0 and r["none/real/wire_bytes"] == 0
        assert r["none/cost/flops"] == r["none/real/flops"] > 0


@pytest.mark.parametrize("mesh", sorted(R.MESHES))
def test_decode_cost_divides_over_the_ranks(ranks, mesh):
    """Each rank's FLOPs are the meshless step's over the 4 ranks: (1, 4) splits
    every product and every head over the model axis, (2, 2) the slots over the
    data axis and the rest over the model axis. The only replicated parts would
    be products that no rule splits; this step has none (the embedding lookup and
    the norms count no FLOPs), so the division is exact."""
    _, rs = ranks
    for r in rs:
        assert r[f"{mesh}/cost/flops"] * R.WORLD == r["none/cost/flops"]


@pytest.mark.parametrize("mesh", sorted(R.MESHES))
def test_decode_cost_against_the_reference(ranks, mesh):
    """The reference's ``decode_cost`` is XLA's cost analysis of its compiled step
    on the same mesh. XLA counts the scanned layer body once (the reason for the
    reference dry-run's ``body_probe``, which ``decode_cost`` does not apply), so
    with L = 2 layers it sees one layer's products; it also counts elementwise
    FLOPs (softmax, norms, RoPE, the argmax's compares) that ``FlopCounterMode``
    does not. The port's FLOPs are therefore held between 1 and L times XLA's.
    GSPMD picks its own collectives, so the wire bytes are held within a factor
    of 20 either way."""
    jx, rs = ranks
    flops = rs[0][f"{mesh}/cost/flops"] / jx[f"{mesh}/flops"]
    wire = rs[0][f"{mesh}/cost/collective_bytes"] / jx[f"{mesh}/collective_bytes"]
    print(f"{mesh}: port/reference FLOPs {flops:.3f}, wire bytes {wire:.3f}, bytes "
          f"{rs[0][f'{mesh}/cost/bytes_accessed'] / jx[f'{mesh}/bytes_accessed']:.3f}")
    assert 1.0 <= flops <= R.config(R.ARCH).n_layers
    assert 1 / 20 <= wire <= 20


def test_fewer_heads_than_model_ranks(ranks):
    """The hybrid with 2 query heads over a model axis of 4 (two ranks attend no
    head): logits within 1e-5 of max |logit| of the meshless ones, the same greedy
    tokens, and one train step's loss and gradient norm within 1e-5."""
    _, rs = ranks
    for r in rs:
        got, want = r["few/mesh/logits"], r["few/none/logits"]
        assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))
        assert np.array_equal(got.argmax(-1), want.argmax(-1))
        for k in ("loss", "gnorm"):
            assert abs(float(r[f"few/mesh/{k}"]) - float(r[f"few/none/{k}"])) <= 1e-5 * abs(
                float(r[f"few/none/{k}"]))


def _moe_exchanges(mesh):
    """``(calls, wire bytes)`` of the expert exchange in one expert-parallel train
    step of ``R.MOE_ARCH`` on ``mesh``, from the config alone: each layer's rank
    routes its model-axis share of its batch slice's tokens, and sends a float32
    ``[m, E/m, cap, D]`` buffer out and back in the forward and the gradient back
    and out in the backward (four exchanges a layer), each ``b·(m-1)/m``."""
    cfg = R.config(R.MOE_ARCH)
    nd, m = R.MESHES[mesh]
    t = R.MOE_BATCH // nd * R.MOE_SEQ // m
    cap = max(8, math.ceil(t * cfg.topk / cfg.n_experts * cfg.moe_capacity_factor))
    b = m * (cfg.n_experts // m) * cap * cfg.d_model * 4
    return 4 * cfg.n_layers, 4 * cfg.n_layers * b * (m - 1) / m


@pytest.mark.parametrize("mesh", sorted(R.MESHES))
def test_moe_train_step_wire_bytes_forward_and_backward(ranks, mesh):
    """An expert-parallel MoE train step on each rank: the backward's collectives
    are counted as the forward's are. The exchange's calls and wire bytes equal the
    count from the config's dimensions (forward and backward), and every kind's
    wire bytes and calls are the same on ``meta`` (``step_cost``, which issues
    nothing), in the real step's ``count_cost`` and in ``ISSUED``/``WIRE_BYTES``
    over the real step."""
    _, rs = ranks
    calls, wire = _moe_exchanges(mesh)
    for r in rs:
        k = f"moetrain/{mesh}/{{}}/{{}}".format
        assert r[f"moetrain/{mesh}/meta_issued"] == 0
        assert int(r[k("issued", "all_to_all")]) == calls
        assert r[k("wire", "all_to_all")] == wire
        for kind in collectives.KINDS:
            assert r[k("meta", kind)] == r[k("real", kind)] == r[k("wire", kind)], kind
            assert (int(r[k("meta_calls", kind)]) == int(r[k("real_calls", kind)])
                    == int(r[k("issued", kind)])), kind
        assert r[k("wire", "all_reduce")] > 0

"""The autotuner and the dispatch on its cache, on the card.

Marked ``gpu`` (skipped without a card); no JAX here (the card's machine has
none), so each kernel is held against its plain PyTorch version, within 2e-5
of max |plain| as ``chip_smoke.py`` holds them:

* ``autotune_matmul`` at a qwen3-8b decode-step shape (bf16 x, the wgmma
  routes) and an AlexNet fc shape (float32 x, the bf16x3 routes): every impl
  timed, the winner written, ``quantized_matmul(impl="auto")`` then
  launching the winner's kernel, its output held;
* an entry electing the tiled kernel where the heuristic takes the
  decode-step one moves the launch;
* ``autotune_flash_decode`` on the ``(1, 1)`` mesh of a one-rank NCCL group,
  ``block_s=None`` equal to the tuned chunk's call.

    python -m pytest -m gpu tests/test_torch_bench_gpu.py
"""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu
REL_TOL = 2e-5


@pytest.fixture
def card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.bench import autotune

    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "autotune_cache.json"))
    autotune.invalidate_memory_cache()
    yield torch.device("cuda")
    autotune.invalidate_memory_cache()


def _launches():
    from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul
    from repro_torch.kernels.fused_decode import fused_decode_matmul

    return {f"tiled/{r}": elp_bsd_matmul.launches_by_route[r]
            for r in elp_bsd_matmul.launches_by_route} | {
        f"fused/{r}": fused_decode_matmul.launches_by_route[r]
        for r in fused_decode_matmul.launches_by_route}


def _held(x, pw, card, expect: str):
    """``quantized_matmul(impl="auto")`` launches ``expect`` (``impl/route``) once
    and agrees with the plain version."""
    from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul_plain
    from repro_torch.kernels.ops import quantized_matmul

    before = _launches()
    got = quantized_matmul(x, pw, impl="auto", out_dtype=torch.float32)
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in _launches().items() if v != before[k]}
    assert delta == {expect: 1}
    want = elp_bsd_matmul_plain(x, pw.codes, pw.sf, pw.fmt, nibble=pw.nibble,
                                out_dtype=torch.float32)
    assert (got - want).abs().max().item() <= REL_TOL * want.abs().max().item()


@pytest.mark.parametrize("m, k, n, dtype, route", [(16, 4096, 4096, torch.bfloat16, "wgmma"),
                                                   (64, 4096, 1000, torch.float32, "bf16x3")])
def test_tuned_winner_runs_and_holds(card, m, k, n, dtype, route):
    from repro_torch.bench import autotune
    from repro_torch.kernels.ops import pack_weight

    res = autotune.autotune_matmul(m, k, n, "elp_bsd_a4", dtype=dtype, device=card)
    assert {r["impl"] for r in res["ranking"]} == set(autotune.IMPLS)
    assert res["route"] == route and res["impl"] in autotune.VOTING
    assert all(r["wall_us"] > 0 for r in res["ranking"])
    assert autotune.lookup_impl(m, k, n, fmt_name="elp_bsd_a4", nibble=True,
                                backend="cuda")[0] == res["impl"]
    gen = torch.Generator(device=card).manual_seed(1)
    x = torch.randn(m, k, device=card, generator=gen).to(dtype)
    pw, _ = pack_weight(torch.randn(k, n, device=card, generator=gen) * 0.02, "elp_bsd_a4")
    _held(x, pw, card, f"{res['impl']}/{route}")


def test_an_entry_moves_the_launch(card):
    from repro_torch.bench import autotune
    from repro_torch.kernels.ops import pack_weight

    m, k, n = 16, 4096, 1024
    gen = torch.Generator(device=card).manual_seed(2)
    x = torch.randn(m, k, device=card, generator=gen).to(torch.bfloat16)
    pw, _ = pack_weight(torch.randn(k, n, device=card, generator=gen) * 0.02, "elp_bsd_a4")
    _held(x, pw, card, "fused/wgmma")  # the heuristic: M <= 256
    autotune.write_entries({autotune.cache_key(m, k, n, "elp_bsd_a4", True, "cuda", impl):
                            {"blocks": [128, 128, 128], "wall_us": wall}
                            for impl, wall in (("tiled", 1.0), ("fused", 2.0), ("library", 0.5))})
    _held(x, pw, card, "tiled/wgmma")


def test_flash_decode_tuned_chunk(card):
    from repro_torch.bench import autotune
    from repro_torch.models.context import ParallelCtx
    from repro_torch.models.flash_decode import flash_decode_attention
    from repro_torch.runtime.elastic import make_mesh

    b, s, h, hd, kv = 4, 2048, 8, 128, 2
    ours = not torch.distributed.is_initialized()
    pctx = ParallelCtx(mesh=make_mesh(), flash_decode=True)
    try:
        res = autotune.autotune_flash_decode(b, s, h, hd, kv=kv, dtype=torch.bfloat16, pctx=pctx,
                                             device=card)
        assert sorted(r["block_s"] for r in res["ranking"]) == [0, 128, 256, 512]
        # float32 inputs: the chunked and one-shot sums then differ by float32
        # rounding only, not by a bf16 step of the output
        gen = torch.Generator(device=card).manual_seed(3)
        q = torch.randn(b, 1, h, hd, device=card, generator=gen)
        ck, cv = (torch.randn(b, s, kv, hd, device=card, generator=gen) for _ in range(2))
        got = flash_decode_attention(q, ck, cv, s - 1, pctx=pctx)
        assert torch.equal(got, flash_decode_attention(q, ck, cv, s - 1, pctx=pctx,
                                                       block_s=res["blocks"][1]))
        one_shot = flash_decode_attention(q, ck, cv, s - 1, pctx=pctx, block_s=0)
        assert (got - one_shot).abs().max().item() <= 1e-5 * one_shot.abs().max().item()
    finally:
        if ours:
            torch.distributed.destroy_process_group()

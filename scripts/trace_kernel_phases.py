#!/usr/bin/env python3
"""Where the time goes inside the two bf16 tensor-core kernels, on one NVIDIA GPU.

Builds copies of ``csrc/fused_decode_wgmma.cu`` and
``csrc/flash_attention_wgmma.cu`` into ``build/trace/`` with ``clock64``
stamps added at the phase boundaries of the first consumer thread of each
block (the kernels' arithmetic is untouched), runs each warm and then
cold (L2 flushed; the stamps are the cold run's) at
qwen3-8b's shapes (the decode step's w1/w3 and wq/wo products at M = 16;
the prefill's attention) and, for the float32 (bf16x3) routes, the
decode-step kernel at AlexNet's fc0 and fc2 at M = 64 (a K block is three
stages there, one per bf16 term of x) and the tiled kernel
(``csrc/elp_bsd_matmul_wgmma.cu``'s second kernel) at AlexNet's conv1 and
conv3, and prints the median cycle at which each phase ends, counted from
the block's entry.

    python3 scripts/trace_kernel_phases.py

Needs a CUDA device and ``nvcc``, and exits non-zero without one.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
SLOTS = 64  # stamps per block
BLOCKS = 4096  # blocks stamped

STAMP_HEAD = (
    f"__device__ long long g_stamp[{BLOCKS} * {SLOTS}];\n"
    "#define STAMP(slot) do { if (stamp_on && (slot) < " + str(SLOTS) + ") "
    "stamp_at[(slot)] = clock64() - stamp_t0; } while (0)\n"
)
STAMP_TAIL = (
    '\nextern "C" int stamps_read(long long* host) {\n'
    f"  return (int)cudaMemcpyFromSymbol(host, g_stamp, {8 * BLOCKS * SLOTS});\n"
    "}\n"
    'extern "C" int stamps_clear() {\n'
    "  void* p = nullptr;\n"
    "  if (cudaGetSymbolAddress(&p, g_stamp) != cudaSuccess) return -1;\n"
    f"  return (int)cudaMemset(p, 0, {8 * BLOCKS * SLOTS});\n"
    "}\n"
)
STAMP_ENTRY = (
    "  const long long stamp_t0 = clock64();\n"
    "  const int stamp_block = blockIdx.y * gridDim.x + blockIdx.x;\n"
    f"  const bool stamp_on = stamp_block < {BLOCKS} && threadIdx.x == 0;\n"
    f"  long long* stamp_at = g_stamp + stamp_block * {SLOTS};\n"
)

# (anchor, text inserted after it) per kernel. Decode: slot 0 = barriers
# ready, 1 + 3i = stage i arrived, 2 + 3i = stage i decoded, 3 + 3i = stage i
# freed (i < 19), 61 = main loop done, 62 = partial sums flagged, 63 = end.
DECODE_STAMPS = [
    ("  using S = Shape<NT, NIBBLE, Dec::PLANES>;\n", STAMP_ENTRY),
    ("  __syncthreads();\n\n  const int warp", None),  # replaced below
    ("    mbar_wait(&full[st], (i / STAGES) & 1);\n",
     "    if (i < 19) STAMP(1 + 3 * i);\n"),
    ("    decode_stage<NIBBLE>(f, cs + st * S::C_STAGE, tab + lane, col >> 4, col & 15, q);\n",
     "    if (i < 19) STAMP(2 + 3 * i);\n"),
    ("  auto release = [&](int i) {\n", "    if (i < 19) STAMP(3 + 3 * i);\n"),
    ("    i += TERMS * n_st;\n", "    STAMP(61);\n"),
    ("    if (!*last_flag || n >= N) continue;\n", None),
    ("        if (m < M && n + c < N) out[static_cast<size_t>(m) * N + n + c] = v[e] * scale;\n"
     "      }\n    }\n  }\n", "  STAMP(63);\n"),
]
# Flash: 0 = Q arrived; per key tile t < 3: 1 + 4t arrived, 2 + 4t S done,
# 3 + 4t softmax done, 4 + 4t P.V done; 63 = end.
FLASH_STAMPS = [
    ("  using S = Smem<HD>;\n", STAMP_ENTRY),
    ("  mbar_wait(q_full, 0);\n", "  STAMP(0);\n"),
    ("    mbar_wait(&full[st], (kt / STAGES) & 1);\n", "    if (kt < 3) STAMP(1 + 4 * kt);\n"),
    ("    for (int i = 0; i < 32; ++i) fence_operand(s[i]);\n",
     "    if (kt < 3) STAMP(2 + 4 * kt);\n"),
    ("    wgmma_fence();\n#pragma unroll\n    for (int kk = 0; kk < 4; ++kk)\n", None),
    ("    __syncwarp();\n    if (lane == 0) mbar_arrive(&empty[st]);\n  }\n", None),
]


# The tiled bf16x3 kernel: the first consumer thread stamps slots 0-20 and
# 62-63, the first splitter thread 32-50, for stages 0, 1, 2, 12 and 24
# (TSLOT 0-4). Consumer: 0 = barriers ready, 1 + 3t = codes arrived,
# 2 + 3t = decoded, 16 + t = split written, 3 + 3t = freed, 62 = main loop
# done, 63 = epilogue. Splitter: 32 + 4t = float32 tile arrived, 33 + 4t =
# bf16 slot free, 34 + 4t = split written.
TILED_ENTRY = (
    "  const long long stamp_t0 = clock64();\n"
    "  const int stamp_block = blockIdx.y * gridDim.x + blockIdx.x;\n"
    f"  const bool stamp_on = stamp_block < {BLOCKS} && blockIdx.z == 0 && "
    "(threadIdx.x == 0 || threadIdx.x == 256);\n"
    f"  long long* stamp_at = g_stamp + stamp_block * {SLOTS};\n"
)
TSLOT = "{ const int ts = (i) < 3 ? (i) : (i) == 12 ? 3 : (i) == 24 ? 4 : -1; if (ts >= 0) "
TILED_STAMPS = [
    ("  constexpr int c_bytes = NIBBLE ? x3::BK / 2 * x3::BN : x3::BK * x3::BN;\n", TILED_ENTRY),
    ("      mbar_wait(&ffull[fst], (i / x3::F_STAGES) & 1);\n",
     "      " + TSLOT + "STAMP(32 + 4 * ts); }\n"),
    ("      if (i >= x3::B_STAGES) mbar_wait(&bempty[bst], (i / x3::B_STAGES - 1) & 1);\n",
     "      " + TSLOT + "STAMP(33 + 4 * ts); }\n"),
    ("      fence_proxy_async();\n", "      " + TSLOT + "STAMP(34 + 4 * ts); }\n"),
    ("    const int fst = i % x3::F_STAGES;\n    mbar_wait(&ffull[fst], (i / x3::F_STAGES) & 1);\n",
     "    " + TSLOT + "STAMP(1 + 3 * ts); }\n"),
    ("col >> 4, col & 15,\n                         q);\n", "    " + TSLOT + "STAMP(2 + 3 * ts); }\n"),
    ("    mbar_wait(&bfull[i % x3::B_STAGES], (i / x3::B_STAGES) & 1);\n",
     "    " + TSLOT + "STAMP(16 + ts); }\n"),
    ("    if (lane == 0) mbar_arrive(&bempty[i % x3::B_STAGES]);\n",
     "    " + TSLOT + "STAMP(3 + 3 * ts); }\n"),
    ("    }\n  }\n  promote();\n", "  STAMP(62);\n"),
    ("#pragma unroll\n  for (int j = 0; j < x3::BM / 8; ++j) {\n", "    STAMP(63);\n"),
]


def patched_tiled(src: str) -> str:
    src = _patch(src, TILED_STAMPS)
    return src.replace("  if (warp >= x3::PRODUCER_WARP) {\n",
                       "  STAMP(0);\n  if (warp >= x3::PRODUCER_WARP) {\n", 1)


def _patch(src: str, stamps: list) -> str:
    src = src.replace("namespace {\n", STAMP_HEAD + "namespace {\n", 1)
    for anchor, text in stamps:
        if anchor not in src:
            raise RuntimeError(f"trace anchor not found: {anchor!r}")
        if text is not None:
            src = src.replace(anchor, anchor + text, 1)
    return src + STAMP_TAIL


def patched_decode(src: str) -> str:
    src = _patch(src, DECODE_STAMPS)
    src = src.replace("  __syncthreads();\n\n  const int warp",
                      "  __syncthreads();\n  STAMP(0);\n\n  const int warp", 1)
    return src.replace("    if (!*last_flag || n >= N) continue;\n",
                       "    STAMP(62);\n    if (!*last_flag || n >= N) continue;\n", 1)


def patched_flash(src: str) -> str:
    src = _patch(src, FLASH_STAMPS)
    src = src.replace("    wgmma_fence();\n#pragma unroll\n    for (int kk = 0; kk < 4; ++kk)\n",
                      "    if (kt < 3) STAMP(3 + 4 * kt);\n"
                      "    wgmma_fence();\n#pragma unroll\n    for (int kk = 0; kk < 4; ++kk)\n", 1)
    src = src.replace("    __syncwarp();\n    if (lane == 0) mbar_arrive(&empty[st]);\n  }\n",
                      "    if (kt < 3) STAMP(4 + 4 * kt);\n"
                      "    __syncwarp();\n    if (lane == 0) mbar_arrive(&empty[st]);\n  }\n", 1)
    last = src.index("\n}\n\n// ----")  # the end of the bf16 kernel, before the bf16x3 one
    return src[:last] + "\n  STAMP(63);" + src[last:]


def build_traced(name: str, patch, signatures: dict) -> ctypes.CDLL:
    from repro_torch import _build

    out_dir = os.path.join(ROOT, "build", "trace")
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(_build.CSRC, out_dir)
    path = os.path.join(out_dir, f"{name}.cu")
    with open(path) as f:
        src = patch(f.read())
    with open(path, "w") as f:
        f.write(src)
    lib_path = os.path.join(out_dir, f"lib{name}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path, path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the traced {name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    for fn, (argtypes, restype) in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    lib.stamps_read.argtypes = [ctypes.c_void_p]
    lib.stamps_read.restype = ctypes.c_int
    lib.stamps_clear.restype = ctypes.c_int
    _build._LIBS[name] = lib  # the wrapper now launches the traced copy
    return lib


def read_stamps(lib):
    """The stamps of the blocks that ran to their end since the last clear."""
    import numpy as np

    buf = (ctypes.c_longlong * (BLOCKS * SLOTS))()
    if lib.stamps_read(ctypes.addressof(buf)) != 0:
        raise RuntimeError("could not read the stamps")
    stamps = np.frombuffer(buf, dtype=np.int64).reshape(BLOCKS, SLOTS)
    return stamps[stamps[:, 63] > 0]


def report(label: str, stamps, names: dict) -> None:
    import numpy as np

    print(f"[{label}] blocks {stamps.shape[0]}; cycles from block entry, median (p10, p90):")
    for slot, name in names.items():
        v = stamps[:, slot][stamps[:, slot] > 0]
        if len(v):
            print(f"[{label}]   {name:24s} {np.median(v):8.0f} ({np.percentile(v, 10):.0f}, "
                  f"{np.percentile(v, 90):.0f})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("trace_kernel_phases: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch import _build
    from repro_torch.core.elp_bsd import resolve_format
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.elp_bsd_matmul import elp_bsd_matmul
    from repro_torch.kernels.fused_decode import fused_decode_matmul

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {smi}; torch {torch.__version__}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(32 << 20, device=dev)

    def cold(lib, fn) -> None:
        fn()
        torch.cuda.synchronize()
        if lib.stamps_clear() != 0:
            raise RuntimeError("could not clear the stamps")
        flush.zero_()
        fn()
        torch.cuda.synchronize()

    name = "fused_decode_wgmma"
    lib = build_traced(name, patched_decode, {**_build.matmul_signatures(name, "bf16"),
                                              **_build.matmul_signatures(name, "bf16x3")})
    fmt = resolve_format("elp4")
    for label, k, n in (("w1/w3", 4096, 12288), ("wq/wo", 4096, 4096)):
        x = torch.randn(16, k, device=dev, generator=gen).to(torch.bfloat16)
        codes = torch.randint(0, 256, (k // 2, n), device=dev, dtype=torch.uint8, generator=gen)
        sf = torch.ones(1, device=dev)
        cold(lib, lambda: fused_decode_matmul(x, codes, sf, fmt, nibble=True,
                                              out_dtype=torch.float32))
        names = {0: "table and barriers"}
        for i in (0, 1, 2, 9, 18):
            names.update({1 + 3 * i: f"stage {i} arrived", 2 + 3 * i: f"stage {i} decoded",
                          3 + 3 * i: f"stage {i} freed"})
        names.update({61: "main loop done", 62: "partials flagged", 63: "end"})
        report(f"decode {label} M=16 K={k} N={n}", read_stamps(lib), names)
    for label, k, n in (("fc0", 12544, 4096), ("fc2", 4096, 1000)):
        x = torch.relu(torch.randn(64, k, device=dev, generator=gen))
        codes = torch.randint(0, 256, (k // 2, n), device=dev, dtype=torch.uint8, generator=gen)
        sf = torch.ones(1, device=dev)
        cold(lib, lambda: fused_decode_matmul(x, codes, sf, fmt, nibble=True))
        names = {0: "table and barriers"}
        for i in (0, 3, 6, 9, 18):  # the first stage of K blocks 0, 1, 2, 3 and 6
            names.update({1 + 3 * i: f"K block {i // 3} arrived",
                          2 + 3 * i: f"K block {i // 3} decoded",
                          3 + 3 * i: f"K block {i // 3} freed"})
        names.update({61: "main loop done", 62: "partials flagged", 63: "end"})
        report(f"decode bf16x3 {label} M=64 K={k} N={n}", read_stamps(lib), names)

    name = "elp_bsd_matmul_wgmma"
    lib = build_traced(name, patched_tiled, _build.matmul_signatures(name, "bf16x3"))
    for label, m, k, n in (("conv1", 50176, 2400, 256), ("conv3", 12544, 3456, 384)):
        x = torch.relu(torch.randn(m, k, device=dev, generator=gen))
        codes = torch.randint(0, 256, (k // 2, n), device=dev, dtype=torch.uint8, generator=gen)
        sf = torch.ones(1, device=dev)
        cold(lib, lambda: elp_bsd_matmul(x, codes, sf, fmt, nibble=True))
        names = {0: "table and barriers"}
        for t, i in enumerate((0, 1, 2, 12, 24)):
            names.update({32 + 4 * t: f"stage {i} float32 in", 33 + 4 * t: f"stage {i} slot free",
                          34 + 4 * t: f"stage {i} split", 1 + 3 * t: f"stage {i} codes in",
                          2 + 3 * t: f"stage {i} decoded", 16 + t: f"stage {i} split seen",
                          3 + 3 * t: f"stage {i} freed"})
        names.update({62: "main loop done", 63: "end"})
        report(f"tiled bf16x3 {label} M={m} K={k} N={n}", read_stamps(lib), names)

    name = "flash_attention_wgmma"
    lib = build_traced(name, patched_flash, fa._signatures("wgmma"))
    q = torch.randn(16, 128, 32, 128, device=dev, generator=gen).to(torch.bfloat16).transpose(1, 2)
    k, v = (torch.randn(16, 128, 8, 128, device=dev, generator=gen).to(torch.bfloat16)
            .transpose(1, 2) for _ in range(2))
    cold(lib, lambda: fa.flash_attention(q, k, v, causal=True))
    names = {0: "Q arrived"}
    for t in range(2):
        names.update({1 + 4 * t: f"tile {t} arrived", 2 + 4 * t: f"tile {t} S done",
                      3 + 4 * t: f"tile {t} softmax done", 4 + 4 * t: f"tile {t} P.V done"})
    names[63] = "end"
    report("flash qwen3-8b prefill, causal", read_stamps(lib), names)
    return 0


if __name__ == "__main__":
    sys.exit(main())

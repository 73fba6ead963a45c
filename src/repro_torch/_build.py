"""Build the CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, ``build/kernels/lib<name>-<digest>.so`` at the root of
the checkout, where ``<digest>`` hashes the sources and flags, so an edited
kernel is rebuilt and an unchanged one is reused. Nothing is built when the
package is imported: the first launch builds what it needs, and
:func:`build` compiles several sources at once (one ``nvcc`` each, all
started together) and returns each one's ``-Xptxas -v`` report.

Each library is loaded with the ctypes signatures of its C entry points
(:func:`load`). The two float32 packed matmul kernels share two::

    long long <name>_workspace(int M, int N, int K)
    int <name>_f32(const float* x, const uint8_t* codes, const float* sf, float* out,
                   int M, int N, int K, int nibble, float* work, long long work_floats,
                   const int* desc, void* stream)

The first gives the floats of workspace the launch needs for its split-K
partial sums on the current device (0 for none, -1 for a shape the kernel
cannot take): the kernel's source picks the split from its own tiles and
its occupancy. The second launches on ``stream`` with that workspace and
returns the launches' ``cudaError_t``, or -1 for a descriptor, shape or
workspace the kernel cannot take. The two bf16 tensor-core matmuls
(``elp_bsd_matmul_wgmma``, ``fused_decode_wgmma``) have the same
``_workspace`` and, in place of ``_f32``::

    int <name>_bf16(const bf16* x, const uint8_t* codes, const float* sf, float* out,
                    int M, int N, int K, int nibble, float* work, long long work_floats,
                    const uint32_t* table, long long x_ld, long long codes_ld, void* stream)

with the 256-entry decode table (:func:`repro_torch.kernels.ref.decode_table`)
in host memory and the row strides of x (elements) and codes (bytes), each
a multiple of 16 bytes, as TMA asks. Their float32-activation route
(bf16x3: x split exactly into three bf16 terms) has the same arguments
with float32 x, as ``<name>_bf16x3`` beside ``<name>_bf16x3_workspace``.
Their digit-plane routes, for formats whose values are not all exact in
bf16, are ``<name>_bf16_digits`` and ``<name>_bf16x3_digits`` (each beside
its ``_workspace``), with the same arguments and the digit-plane words
(:func:`repro_torch.kernels.ref.plane_words`) in place of the table.
The attention kernels' entry points are declared by their wrapper
(:mod:`repro_torch.kernels.flash_attention`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.core.elp_bsd import ElpBsdFormat

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Every kernel source of the port, by name (csrc/<name>.cu).
SOURCES = ("elp_bsd_matmul", "elp_bsd_matmul_wgmma", "fused_decode", "fused_decode_wgmma",
           "flash_attention", "flash_attention_wgmma")
# Layout of the format descriptor parsed by csrc/elp_decode.cuh.
MAX_DIGITS = 4
MAX_LUT = 8

_LIBS: dict[str, ctypes.CDLL] = {}
_DECLARED: set[tuple[str, str]] = set()  # (library, entry point)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def lib_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: list[str]) -> dict[str, str]:
    """Compile the named sources in parallel; return each ``nvcc`` report.

    A library that is already built is not compiled again (its report is
    then empty). Raises ``RuntimeError`` with the compiler's output when a
    source fails to build.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        dst = lib_path(name)
        if dst.exists():
            continue
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, dst)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, dst) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, dst)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


# The launch entry point's arguments between the workspace and the stream,
# by entry suffix: the format descriptor (float32 kernels), or the decode
# table (digit-plane words) and the row strides of x and codes (the
# tensor-core kernels).
_TABLE_STRIDES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong)
LAUNCH_EXTRA = {"f32": (ctypes.c_void_p,), "bf16": _TABLE_STRIDES, "bf16x3": _TABLE_STRIDES,
                "bf16_digits": _TABLE_STRIDES, "bf16x3_digits": _TABLE_STRIDES}


def workspace_entry(name: str, kind: str) -> str:
    """The entry point giving the workspace of ``<name>_<kind>``'s launches."""
    return f"{name}_workspace" if kind in ("f32", "bf16") else f"{name}_{kind}_workspace"


def matmul_signatures(name: str, kind: str = "f32") -> dict:
    """ctypes signatures of a packed matmul library's two entry points for
    ``kind``: ``<name>_<kind>`` and its :func:`workspace_entry`."""
    # Every pointer and the stream as c_void_p: left undeclared, ctypes
    # would pass them as 32-bit ints and cut them.
    return {
        f"{name}_{kind}": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p, ctypes.c_longlong, *LAUNCH_EXTRA[kind],
                              ctypes.c_void_p], ctypes.c_int),
        workspace_entry(name, kind): ([ctypes.c_int] * 3, ctypes.c_longlong),
    }


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built on first use).

    ``signatures`` maps each C entry point to its ``(argtypes, restype)``
    (:func:`matmul_signatures` for the packed matmul kernels); entry points
    already declared keep their declarations.
    """
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    for fn_name, (argtypes, restype) in signatures.items():
        if (name, fn_name) not in _DECLARED:
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = restype
            _DECLARED.add((name, fn_name))
    return lib


def format_descriptor(fmt: ElpBsdFormat) -> ctypes.Array:
    """``fmt``'s shift-add decomposition as the int array elp_decode.cuh parses.

    ``n_digits``, then per digit ``off, sign_bits, index_bits, affine, a,
    b, lut[8]`` (unused digits and LUT entries zero).
    """
    dec = fmt.shift_add_decomposition()
    if len(dec) > MAX_DIGITS:
        raise ValueError(f"the CUDA decoder takes at most {MAX_DIGITS} digits, {fmt.name} has {len(dec)}")
    vals = [len(dec)]
    for i in range(MAX_DIGITS):
        if i < len(dec):
            off, sbits, ibits, tab, affine = dec[i]
            if len(tab) > MAX_LUT:
                raise ValueError(f"the CUDA decoder takes LUTs of at most {MAX_LUT} shifts")
            a, b = affine if affine is not None else (0, 0)
            lut = [int(t) for t in tab] + [int(tab[-1])] * (MAX_LUT - len(tab))
            vals += [off, sbits, ibits, int(affine is not None), a, b, *lut]
        else:
            vals += [0] * (6 + MAX_LUT)
    return (ctypes.c_int * len(vals))(*vals)


def _launch(name: str, kind: str, x: torch.Tensor, codes: torch.Tensor, sf: torch.Tensor,
            out: torch.Tensor, k: int, nibble: bool, extra: tuple, what: str) -> None:
    """Allocate the workspace ``<name>_<kind>``'s :func:`workspace_entry` asks
    for, then call ``<name>_<kind>`` with ``extra`` before the current stream
    of ``x``'s device; raise if it fails."""
    m, n = out.shape
    lib = load(name, matmul_signatures(name, kind))
    with torch.cuda.device(x.device):
        need = getattr(lib, workspace_entry(name, kind))(m, n, k)
        work = torch.empty(max(need, 0), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = -1 if need < 0 else getattr(lib, f"{name}_{kind}")(
            x.data_ptr(), codes.data_ptr(), sf.data_ptr(), out.data_ptr(), m, n, k, int(nibble),
            work.data_ptr() if need > 0 else None, need, *extra, stream)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed with code {err} (M={m}, N={n}, K={k}, nibble={nibble}, "
            f"workspace {need} floats, {what}); -1 means the kernel refused the "
            "shape, operands or format"
        )


def launch(name: str, x: torch.Tensor, codes: torch.Tensor, sf: torch.Tensor,
           out: torch.Tensor, nibble: bool, fmt: ElpBsdFormat) -> None:
    """Launch the float32 kernel ``csrc/<name>.cu`` on the current stream of ``x``'s device.

    ``x [M, K]`` and ``out [M, N]`` are contiguous float32, ``codes`` is
    contiguous uint8 ``[K, N]`` (``[ceil(K/2), N]`` when ``nibble``),
    ``sf`` is one float32 on the device. The caller has checked all of
    that. The split-K workspace the kernel asks for is allocated here.
    """
    desc = format_descriptor(fmt)  # held here: the C side reads it during the call
    _launch(name, "f32", x, codes, sf, out, x.shape[1], nibble,
            (ctypes.addressof(desc),), f"fmt={fmt.name}")


def launch_tensor_core(name: str, kind: str, x: torch.Tensor, k: int, codes: torch.Tensor,
                       sf: torch.Tensor, out: torch.Tensor, nibble: bool,
                       table: ctypes.Array) -> None:
    """Launch route ``kind`` (``"bf16"``, ``"bf16x3"``, ``"bf16_digits"`` or
    ``"bf16x3_digits"``) of the tensor-core kernel ``csrc/<name>.cu`` on the
    current stream of ``x``'s device.

    ``x`` is bf16 (``"bf16"``) or float32 (``"bf16x3"``, split by the kernel
    into three bf16 terms) with ``k`` logical columns, ``codes`` uint8 with
    ``out.shape[1]`` logical columns, each with unit column stride, a
    16-byte aligned base and a row stride of a multiple of 16 bytes; ``out
    [M, N]`` is contiguous float32, ``sf`` one float32 on the device and
    ``table`` the 256 decode words, or for the ``"_digits"`` kinds the
    digit-plane words. The caller has checked all of that.
    """
    _launch(name, kind, x, codes, sf, out, k, nibble,
            (ctypes.addressof(table), x.stride(0), codes.stride(0)), f"{x.dtype} x, route {kind}")

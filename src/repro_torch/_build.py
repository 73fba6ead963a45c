"""Build the CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, ``build/kernels/lib<name>-<digest>.so`` at the root of
the checkout, where ``<digest>`` hashes the sources and flags, so an edited
kernel is rebuilt and an unchanged one is reused. Nothing is built when the
package is imported: the first launch builds what it needs, and
:func:`build` compiles several sources at once (one ``nvcc`` each, all
started together) and returns each one's ``-Xptxas -v`` report.

Each library is loaded with the ctypes signatures of its C entry points
(:func:`load`). The two packed matmul kernels share two::

    long long <name>_workspace(int M, int N, int K)
    int <name>_f32(const float* x, const uint8_t* codes, const float* sf, float* out,
                   int M, int N, int K, int nibble, float* work, long long work_floats,
                   const int* desc, void* stream)

The first gives the floats of workspace the launch needs for its split-K
partial sums on the current device (0 for none, -1 for a shape the kernel
cannot take): the kernel's source picks the split from its own tiles and
its occupancy. The second launches on ``stream`` with that workspace and
returns the launches' ``cudaError_t``, or -1 for a descriptor, shape or
workspace the kernel cannot take. The attention kernel's entry point is
declared by its wrapper (:mod:`repro_torch.kernels.flash_attention`).
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
# Layout of the format descriptor parsed by csrc/elp_decode.cuh.
MAX_DIGITS = 2
MAX_LUT = 8

_LIBS: dict[str, ctypes.CDLL] = {}


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


def matmul_signatures(name: str) -> dict:
    """ctypes signatures of a packed matmul library's two entry points."""
    # Every pointer and the stream as c_void_p: left undeclared, ctypes
    # would pass them as 32-bit ints and cut them.
    return {
        f"{name}_f32": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                        + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p],
                        ctypes.c_int),
        f"{name}_workspace": ([ctypes.c_int] * 3, ctypes.c_longlong),
    }


def load(name: str, signatures: dict | None = None) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built on first use).

    ``signatures`` maps each C entry point to its ``(argtypes, restype)``;
    the default is the packed matmul kernels' pair (:func:`matmul_signatures`).
    """
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        sigs = signatures if signatures is not None else matmul_signatures(name)
        for fn_name, (argtypes, restype) in sigs.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LIBS[name] = lib
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


def launch(name: str, x: torch.Tensor, codes: torch.Tensor, sf: torch.Tensor,
           out: torch.Tensor, nibble: bool, fmt: ElpBsdFormat) -> None:
    """Launch ``csrc/<name>.cu`` on the current stream of ``x``'s device.

    ``x [M, K]`` and ``out [M, N]`` are contiguous float32, ``codes`` is
    contiguous uint8 ``[K, N]`` (``[ceil(K/2), N]`` when ``nibble``),
    ``sf`` is one float32 on the device. The caller has checked all of
    that. The split-K workspace the kernel asks for is allocated here.
    """
    m, k = x.shape
    n = out.shape[1]
    lib = load(name)
    desc = format_descriptor(fmt)  # held here: the C side reads it during the call
    with torch.cuda.device(x.device):
        need = getattr(lib, f"{name}_workspace")(m, n, k)
        work = torch.empty(max(need, 0), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = -1 if need < 0 else getattr(lib, f"{name}_f32")(
            x.data_ptr(), codes.data_ptr(), sf.data_ptr(), out.data_ptr(), m, n, k, int(nibble),
            work.data_ptr() if need > 0 else None, need, ctypes.addressof(desc), stream)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed with code {err} (M={m}, N={n}, K={k}, nibble={nibble}, "
            f"workspace {need} floats, fmt={fmt.name}); -1 means the kernel refused the "
            "shape or format"
        )

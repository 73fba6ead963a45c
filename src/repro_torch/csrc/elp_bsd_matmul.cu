// Tiled ELP_BSD decode + matmul for Hopper (sm_90a), float32 on CUDA cores.
//
// Replaces the Pallas TPU kernel repro/kernels/elp_bsd_matmul.py::elp_bsd_matmul
// (body _mm_kernel): out[M, N] = (x[M, K] . decode(codes)[K, N]) * sf, where
// codes are uint8, one per weight ([K, N]) or nibble-packed two per byte
// along K ([K/2, N], low nibble = even row), and sf is one float32 read
// from device memory (no host sync).
//
// Design. The TPU kernel walks a sequential (M/bm, N/bn, K/bk) grid and
// carries a VMEM accumulator across the K steps. On Hopper blocks run in
// parallel and nothing carries between them, so each block owns one
// 128 x 128 output tile and loops over K itself. Per 16-deep K step it
// stages the x tile (transposed) and the code tile in shared memory,
// decodes the codes to float32 in shared memory (shift-add, elp_decode.cuh),
// and every thread accumulates an 8 x 8 micro-tile in float32 registers.
// The decoded [K, N] weight never reaches device memory. Where the output
// tiles alone would leave the SMs idle for part of the last wave, K is split
// over several blocks per tile (grid z); their partial sums go to a float32
// workspace and a second pass adds them in split order, so the result is
// deterministic (no atomics). Ragged M, N and K
// edges are masked in the kernel: rows and columns past the logical shape
// load zeros, so a pad code (which may decode to a nonzero value, e.g.
// code 0 of elp_bsd_a4 is +1) only ever meets zero activations.
//
// Bound on an H100 SXM: the f32 CUDA-core rate, 67 TFLOP/s. A conv GEMM of
// AlexNet at batch 64 does 2*M*K*N operations on (M*K + M*N)*4 bytes, which
// at these K and N is far above the card's f32 operations-per-byte line.
// This kernel serves float32 activations, which would round on the bf16
// tensor cores; bf16 activations take elp_bsd_matmul_wgmma.cu (wgmma),
// where a decoded weight (at most two powers of two with shift <= 7) is
// exact and so is every product.
#include <stdint.h>

#include "elp_decode.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int AS_LD = BM + 4;  // padded leading dim of the transposed x tile
constexpr int MAX_SPLITS = 4;

__global__ void __launch_bounds__(THREADS, 2)
elp_bsd_matmul_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes,
                      const float* __restrict__ sf, float* __restrict__ out,
                      float* __restrict__ work, int M, int N, int K, int kspan, int nibble,
                      ElpFormat fmt) {
  __shared__ __align__(16) float As[BK][AS_LD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group
  const int ty = tid / 16;  // row group
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  // Split-K: this block sums K rows [kbeg, kend); kspan is a multiple of BK.
  const int kbeg = blockIdx.z * kspan;
  const int kend = min(K, kbeg + kspan);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // x tile loader: 16 consecutive k of one row per half-warp.
  const int ld_k = tid % BK;
  const int ld_r = tid / BK;  // 0..15
  // code tile loader: one column per thread, rows strided by 2.
  const int ld_n = tid % BN;
  const int ld_kr = tid / BN;  // 0..1

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    // Stage x[m0:m0+128, k0:k0+16] transposed into As[k][m].
    {
      const int gk = k0 + ld_k;
#pragma unroll
      for (int j = 0; j < BM / 16; ++j) {
        const int r = ld_r + 16 * j;
        const int gm = m0 + r;
        As[ld_k][r] = (gm < M && gk < kend) ? x[(size_t)gm * K + gk] : 0.f;
      }
    }
    // Stage and decode codes[k0:k0+16, n0:n0+128] into Bs[k][n].
    {
      const int gn = n0 + ld_n;
      if (nibble) {
#pragma unroll
        for (int j = 0; j < BK / 4; ++j) {
          const int kr = ld_kr + 2 * j;  // byte row within the tile, 0..7
          const int gk = k0 + 2 * kr;    // logical even row
          unsigned byte = 0;
          if (gn < N && gk < kend) byte = codes[(size_t)(gk / 2) * N + gn];
          const bool in_n = gn < N;
          Bs[2 * kr][ld_n] = (in_n && gk < kend) ? elp_decode(byte & 0xFu, fmt) : 0.f;
          Bs[2 * kr + 1][ld_n] = (in_n && gk + 1 < kend) ? elp_decode(byte >> 4, fmt) : 0.f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) {
          const int kk = ld_kr + 2 * j;
          const int gk = k0 + kk;
          Bs[kk][ld_n] =
              (gn < N && gk < kend) ? elp_decode(codes[(size_t)gk * N + gn], fmt) : 0.f;
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // One split writes the scaled result; several write unscaled partial
  // sums to work[split] for splitk_reduce_kernel.
  const bool split = gridDim.z > 1;
  const float s = split ? 1.f : sf[0];
  float* dst = split ? work + (size_t)blockIdx.z * M * N : out;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (gn < N) dst[(size_t)gm * N + gn] = acc[i][j] * s;
    }
  }
}

// The launch's grid: one block per output tile, times the split-K factor
// (grid.z) for the current device; kspan is the K rows of one split.
// Returns false for a shape the kernel cannot take.
bool plan(int M, int N, int K, dim3* grid, int* kspan) {
  if (M <= 0 || N <= 0 || K <= 0) return false;
  const long long tiles = static_cast<long long>((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  const int splits =
      choose_splits(elp_bsd_matmul_kernel, THREADS, tiles, (K + BK - 1) / BK, MAX_SPLITS);
  if (splits < 1) return false;
  *kspan = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  *grid = dim3((N + BN - 1) / BN, (M + BM - 1) / BM, (K + *kspan - 1) / *kspan);
  return grid->y <= 65535u;
}

}  // namespace

// C entry points, bound with ctypes. elp_bsd_matmul_workspace gives the
// floats of split-K workspace a launch at this shape needs (0 for none),
// or -1 for a shape the kernel cannot take. elp_bsd_matmul_f32 takes that
// workspace (`work`, `work_floats`; codes hold ceil(K/2) rows when
// `nibble`), launches on `stream` and returns the cudaError_t of the
// launches (0 on success), or -1 for a format descriptor, shape or
// workspace the kernel cannot take.
extern "C" long long elp_bsd_matmul_workspace(int M, int N, int K) {
  dim3 grid;
  int kspan;
  if (!plan(M, N, K, &grid, &kspan)) return -1;
  return grid.z > 1 ? static_cast<long long>(grid.z) * M * N : 0;
}

extern "C" int elp_bsd_matmul_f32(const float* x, const uint8_t* codes, const float* sf,
                                  float* out, int M, int N, int K, int nibble, float* work,
                                  long long work_floats, const int* desc, void* stream) {
  ElpFormat fmt;
  dim3 grid;
  int kspan;
  if (!elp_format_from_desc(desc, &fmt) || !plan(M, N, K, &grid, &kspan)) return -1;
  if (grid.z > 1 && (work == nullptr || work_floats < static_cast<long long>(grid.z) * M * N))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  elp_bsd_matmul_kernel<<<grid, THREADS, 0, st>>>(x, codes, sf, out, work, M, N, K, kspan,
                                                  nibble, fmt);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || grid.z == 1) return err;
  return splitk_reduce(work, sf, out, static_cast<size_t>(M) * N, grid.z, st);
}

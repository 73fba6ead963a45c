// Decode-step ELP_BSD decode + matmul for Hopper (sm_90a), float32, M <= 256.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_decode.py::fused_decode_matmul
// (body _fused_kernel): the same out[M, N] = (x[M, K] . decode(codes)[K, N]) * sf
// as the tiled kernel, for the small M of an fc layer at decode-size batch.
//
// Design. The TPU kernel keeps the whole M strip resident and walks a
// sequential (N/bn, K/bk) grid. Here each block owns a 32-column strip of
// the output for ALL M rows, so N is spread over the SMs (N = 4096 gives
// 128 blocks for the 132 SMs of an H100), and the block loops over K. Per
// 32-deep K step it stages the x strip [M, 32] and the code tile [32, 32]
// in shared memory, decodes the codes there (elp_decode.cuh), and each
// thread accumulates 4 columns for up to 8 rows (rows tm + 32 i) in float32
// registers. A 32-column strip per block gives too few blocks to hide the
// load latency (fc2, N = 1000, has 32), so K is also split over several
// blocks per strip (grid y): their partial sums go to a float32 workspace
// and a second pass adds them in split order, deterministic (no atomics).
// Ragged K and N are masked in the kernel (zeros past the logical shape).
//
// Bound on an H100 SXM at the AlexNet fc shapes with M = 64: the f32
// CUDA-core rate. fc0 does 2*64*12544*4096 = 6.6 GFLOP, about 98 us at
// 67 TFLOP/s, against 25.7 MB of nibble codes, about 7.7 us at 3.35 TB/s.
// The headroom is the bf16 tensor-core rate (989 TFLOP/s dense, about
// 6.6 us for fc0), at which the code stream, not the arithmetic, would
// bound it. The tensor-core kernels of fused_decode_wgmma.cu take every
// format of at most 3 digits whose terms are normal bf16 values (by table
// or digit planes); this one serves the rest (4 or more digits, terms
// outside bf16's normal range, x of another type).
#include <stdint.h>

#include "elp_decode.cuh"

namespace {

constexpr int MAX_M = 256;
constexpr int BN = 32;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int XS_LD = BK + 4;  // keeps float4 rows aligned and conflict-free
constexpr int MAX_SPLITS = 8;

__global__ void __launch_bounds__(THREADS)
fused_decode_matmul_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes,
                           const float* __restrict__ sf, float* __restrict__ out,
                           float* __restrict__ work, int M, int N, int K, int kspan,
                           int nibble, ElpFormat fmt) {
  __shared__ __align__(16) float xs[MAX_M][XS_LD];
  __shared__ __align__(16) float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tn = tid % 8;   // columns tn*4 .. tn*4+3 of the strip
  const int tm = tid / 8;   // rows tm + 32*i
  const int n0 = blockIdx.x * BN;
  const int mg = (M + 31) / 32;  // active row groups (warp-uniform)
  // Split-K: this block sums K rows [kbeg, kend); kspan is a multiple of BK.
  const int kbeg = blockIdx.y * kspan;
  const int kend = min(K, kbeg + kspan);

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int ld_c = tid % BK;  // x loader: one k per lane
  const int ld_r = tid / BK;  // 0..7
  const int ld_n = tid % BN;  // code loader: one column per lane
  const int ld_k = tid / BN;  // 0..7

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    {
      const int gk = k0 + ld_c;
      for (int r = ld_r; r < mg * 32; r += THREADS / BK)
        xs[r][ld_c] = (r < M && gk < kend) ? x[(size_t)r * K + gk] : 0.f;
    }
    {
      const int gn = n0 + ld_n;
      const bool in_n = gn < N;
      if (nibble) {
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          const int kr = ld_k + 8 * j;  // byte row within the tile, 0..15
          const int gk = k0 + 2 * kr;
          unsigned byte = 0;
          if (in_n && gk < kend) byte = codes[(size_t)(gk / 2) * N + gn];
          ws[2 * kr][ld_n] = (in_n && gk < kend) ? elp_decode(byte & 0xFu, fmt) : 0.f;
          ws[2 * kr + 1][ld_n] = (in_n && gk + 1 < kend) ? elp_decode(byte >> 4, fmt) : 0.f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const int kk = ld_k + 8 * j;
          const int gk = k0 + kk;
          ws[kk][ld_n] = (in_n && gk < kend) ? elp_decode(codes[(size_t)gk * N + gn], fmt) : 0.f;
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      const float4 w0 = *reinterpret_cast<const float4*>(&ws[kk][tn * 4]);
      const float4 w1 = *reinterpret_cast<const float4*>(&ws[kk + 1][tn * 4]);
      const float4 w2 = *reinterpret_cast<const float4*>(&ws[kk + 2][tn * 4]);
      const float4 w3 = *reinterpret_cast<const float4*>(&ws[kk + 3][tn * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i < mg) {
          const float4 xv = *reinterpret_cast<const float4*>(&xs[tm + 32 * i][kk]);
          acc[i][0] = fmaf(xv.w, w3.x, fmaf(xv.z, w2.x, fmaf(xv.y, w1.x, fmaf(xv.x, w0.x, acc[i][0]))));
          acc[i][1] = fmaf(xv.w, w3.y, fmaf(xv.z, w2.y, fmaf(xv.y, w1.y, fmaf(xv.x, w0.y, acc[i][1]))));
          acc[i][2] = fmaf(xv.w, w3.z, fmaf(xv.z, w2.z, fmaf(xv.y, w1.z, fmaf(xv.x, w0.z, acc[i][2]))));
          acc[i][3] = fmaf(xv.w, w3.w, fmaf(xv.z, w2.w, fmaf(xv.y, w1.w, fmaf(xv.x, w0.w, acc[i][3]))));
        }
      }
    }
    __syncthreads();
  }

  // One split writes the scaled result; several write unscaled partial
  // sums to work[split] for splitk_reduce_kernel.
  const bool split = gridDim.y > 1;
  const float s = split ? 1.f : sf[0];
  float* dst = split ? work + (size_t)blockIdx.y * M * N : out;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = tm + 32 * i;
    if (i >= mg || gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tn * 4 + j;
      if (gn < N) dst[(size_t)gm * N + gn] = acc[i][j] * s;
    }
  }
}

// The launch's grid: one block per 32-column strip, times the split-K
// factor (grid.y) for the current device; kspan is the K rows of one
// split. Returns false for a shape the kernel cannot take.
bool plan(int M, int N, int K, dim3* grid, int* kspan) {
  if (M <= 0 || M > MAX_M || N <= 0 || K <= 0) return false;
  const int strips = (N + BN - 1) / BN;
  const int splits =
      choose_splits(fused_decode_matmul_kernel, THREADS, strips, (K + BK - 1) / BK, MAX_SPLITS);
  if (splits < 1) return false;
  *kspan = ((K + splits - 1) / splits + BK - 1) / BK * BK;
  *grid = dim3(strips, (K + *kspan - 1) / *kspan);
  return true;
}

}  // namespace

// C entry points, bound with ctypes. fused_decode_workspace gives the
// floats of split-K workspace a launch at this shape needs (0 for none),
// or -1 for a shape the kernel cannot take. fused_decode_f32 takes that
// workspace (`work`, `work_floats`; codes hold ceil(K/2) rows when
// `nibble`), launches on `stream` and returns the cudaError_t of the
// launches (0 on success), or -1 for a format descriptor, shape or
// workspace the kernel cannot take.
extern "C" long long fused_decode_workspace(int M, int N, int K) {
  dim3 grid;
  int kspan;
  if (!plan(M, N, K, &grid, &kspan)) return -1;
  return grid.y > 1 ? static_cast<long long>(grid.y) * M * N : 0;
}

extern "C" int fused_decode_f32(const float* x, const uint8_t* codes, const float* sf,
                                float* out, int M, int N, int K, int nibble, float* work,
                                long long work_floats, const int* desc, void* stream) {
  ElpFormat fmt;
  dim3 grid;
  int kspan;
  if (!elp_format_from_desc(desc, &fmt) || !plan(M, N, K, &grid, &kspan)) return -1;
  if (grid.y > 1 && (work == nullptr || work_floats < static_cast<long long>(grid.y) * M * N))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fused_decode_matmul_kernel<<<grid, THREADS, 0, st>>>(x, codes, sf, out, work, M, N, K, kspan,
                                                       nibble, fmt);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || grid.y == 1) return err;
  return splitk_reduce(work, sf, out, static_cast<size_t>(M) * N, grid.y, st);
}

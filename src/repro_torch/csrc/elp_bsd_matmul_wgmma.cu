// Tiled ELP_BSD decode + matmul for Hopper (sm_90a): bf16 activations on
// the tensor cores (wgmma), operands fed by TMA.
//
// Replaces, for bfloat16 activations, the Pallas TPU kernel
// repro/kernels/elp_bsd_matmul.py::elp_bsd_matmul (body _mm_kernel):
// out[M, N] = (x[M, K] . decode(codes)[K, N]) * sf in float32, where codes
// are uint8, one per weight ([K, N]) or nibble-packed two per byte along K
// ([ceil(K/2), N], low nibble = even row), and sf is one float32 read from
// device memory. The TPU kernel casts x to float32 and sums float32 products
// of the decoded weights; here x stays bf16. Every decoded value of a format
// this kernel takes is exact in bf16 (the wrapper checks the format), and a
// product of two bf16 values is exact in float32, so the tensor cores form
// the same products and only the order of the float32 sums differs.
//
// Bound on an H100 SXM: the bf16 tensor-core rate (989 TFLOP/s dense). At
// the LM prefill's shapes (M = 2048) the work is far above the card's
// operations-per-byte line: 2*M*K*N operations on M*K*2 + K*N/2 + M*N*4
// bytes.
//
// Design. The product is computed transposed, out^T = W^T . x^T, so that
// the decoded weight is wgmma's register-sourced A operand and never
// touches shared memory, and x, which is K-contiguous, is its B operand as
// TMA lays it down (128-byte swizzle). A block owns 128 weight columns x
// 256 x rows: two consumer warpgroups each decode 64 columns and run
// m64n256k16 wgmmas against the same x tile, so every code is decoded once
// per 256 rows of x. One producer warp keeps a ring of STAGES (x, code)
// tiles in flight through TMA with full/empty mbarriers. Decoding is a
// table lookup: the wrapper builds, from the format, a 256-entry table
// indexed by the code byte (nibble: the bf16 pair of its two codes, low
// half the even row, which is exactly one register of an A fragment; u8:
// the code's bf16 in the low half). Each block copies it into shared
// memory once per lane (entry e of lane l at word 32 e + l), so the 32
// lookups of a warp never share a bank. A consumer frees a stage once its
// wgmmas are done and then decodes the next; the two consumer warpgroups
// interleave, so one decodes while the other's wgmmas run. The producer
// warpgroup gives up most of its registers (setmaxnreg) to the consumers'
// 128 float32 accumulators a thread. The A rows of a warp map to 16 adjacent weight columns (row g to
// column 2g, row g + 8 to column 2g + 1), so a thread reads its two
// columns' codes as one 16-bit word and writes its outputs as float2.
// Ragged M, N and K come from TMA's out-of-bounds zero fill: K rows past the
// logical K load zero activations, so a pad code (which may decode to a
// nonzero value) only ever meets zeros; the epilogue masks M and N. Where
// the output tiles alone would leave SMs idle for part of the last wave, K
// is split over several blocks per tile; their partial sums go to a
// float32 workspace that a second pass adds in split order (deterministic,
// no atomics).
#include <cuda.h>  // CUtensorMap and its enums; libcuda's encoder is fetched at run time
#include <cuda_runtime.h>
#include <stdint.h>

#include "elp_decode.cuh"

namespace {

constexpr int BN = 128;  // weight columns (output N) per block: CONSUMERS x 64
constexpr int BM = 256;  // x rows (output M) per block: the wgmma N
constexpr int BK = 64;   // K per stage: one 128-byte swizzled row of bf16 x
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;  // warpgroups
constexpr int PRODUCER_WARP = CONSUMERS * 4;  // issues every TMA load
constexpr int THREADS = (CONSUMERS + 1) * 128;  // the last warpgroup produces
constexpr int MAX_SPLITS = 4;
constexpr int X_STAGE_BYTES = BM * BK * 2;  // 32 KB
constexpr int C_STAGE_BYTES = BK * BN;      // 8 KB (u8 rows; nibble fills half)
constexpr int TABLE_WORDS = 256 * 32;       // one copy of the table per lane
constexpr int SMEM_BYTES =
    STAGES * (X_STAGE_BYTES + C_STAGE_BYTES) + TABLE_WORDS * 4 + 2 * STAGES * 8 + 1024;

struct DecodeTable {
  uint32_t v[256];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the completion of the barrier's phase of parity `parity`. A wait
// of more than WAIT_LIMIT_NS (a pipeline fault: no legitimate stage takes
// that long) traps, so the launch fails instead of hanging the card.
constexpr uint64_t WAIT_LIMIT_NS = 5000000000ull;
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint64_t start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = global_ns();
    } else if (global_ns() - start > WAIT_LIMIT_NS) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_b128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// d[64 x 256] += A[64 x 16] (bf16 pairs in registers) . B[16 x 256] (shared memory).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], const uint32_t* a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The A fragments of one stage (four k16 steps, four registers each) for
// this thread's two weight columns. Nibble: the tile is [32 byte rows][128
// columns]; register (column, k..k+1) is the byte of byte row k/2, which the
// table maps to the bf16 pair. u8: the tile is [64 rows][128 columns]; the
// pair (k, k+1) of a column is two lookups. Rows are 128-byte swizzled:
// the 16-byte chunk c of row r sits at chunk c ^ (r % 8).
template <bool NIBBLE>
__device__ __forceinline__ void decode_stage(uint32_t (&f)[16], const uint8_t* ct,
                                             const uint32_t* tab_lane, int chunk, int inoff,
                                             int q) {
  auto at = [&](int row) {
    return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(
        ct + row * 128 + ((chunk ^ (row & 7)) << 4) + inoff));
  };
  auto lut = [&](uint32_t byte) { return tab_lane[byte * 32]; };
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (NIBBLE) {
      const uint32_t ba = at(8 * kk + q), bb = at(8 * kk + q + 4);
      f[4 * kk + 0] = lut(ba & 0xFFu);  // column, k..k+1
      f[4 * kk + 1] = lut(ba >> 8);     // column + 1, k..k+1
      f[4 * kk + 2] = lut(bb & 0xFFu);  // column, k+8..k+9
      f[4 * kk + 3] = lut(bb >> 8);     // column + 1, k+8..k+9
    } else {
      const int k = 16 * kk + 2 * q;
      const uint32_t a0 = at(k), a1 = at(k + 1), b0 = at(k + 8), b1 = at(k + 9);
      f[4 * kk + 0] = __byte_perm(lut(a0 & 0xFFu), lut(a1 & 0xFFu), 0x5410);
      f[4 * kk + 1] = __byte_perm(lut(a0 >> 8), lut(a1 >> 8), 0x5410);
      f[4 * kk + 2] = __byte_perm(lut(b0 & 0xFFu), lut(b1 & 0xFFu), 0x5410);
      f[4 * kk + 3] = __byte_perm(lut(b0 >> 8), lut(b1 >> 8), 0x5410);
    }
  }
}

template <bool NIBBLE>
__global__ void __launch_bounds__(THREADS, 1)
elp_bsd_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                            const __grid_constant__ CUtensorMap c_map,
                            const __grid_constant__ DecodeTable table,
                            const float* __restrict__ sf, float* __restrict__ out,
                            float* __restrict__ work, int M, int N, int K, int steps_per_split) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* xs = smem;                                       // STAGES x [256][64] bf16
  uint8_t* cs = xs + STAGES * X_STAGE_BYTES;                // STAGES x code tile
  uint32_t* tab = reinterpret_cast<uint32_t*>(cs + STAGES * C_STAGE_BYTES);  // [256][32]
  uint64_t* full = reinterpret_cast<uint64_t*>(tab + TABLE_WORDS);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int nk = (K + BK - 1) / BK;
  const int s_beg = blockIdx.z * steps_per_split;
  const int steps = min(nk, s_beg + steps_per_split) - s_beg;

  for (int i = tid; i < TABLE_WORDS; i += THREADS) tab[i] = table.v[i >> 5];
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  if (warp >= PRODUCER_WARP) {
    // The producer warpgroup hands its registers to the consumers' accumulators.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == PRODUCER_WARP && lane == 0) {
      constexpr int c_bytes = NIBBLE ? BK / 2 * BN : BK * BN;
      for (int i = 0; i < steps; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[st], (i / STAGES - 1) & 1);
        mbar_expect_tx(&full[st], X_STAGE_BYTES + c_bytes);
        const int k0 = (s_beg + i) * BK;
        tma_load_2d(xs + st * X_STAGE_BYTES, &x_map, &full[st], k0, m0);
        tma_load_2d(cs + st * C_STAGE_BYTES, &c_map, &full[st], n0, NIBBLE ? k0 / 2 : k0);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  // Consumers: warpgroup wg decodes weight columns [64 wg, 64 wg + 64) of the tile.
  const int wg = warp / 4, w = warp % 4, g = lane / 4, q = lane % 4;
  const int col = wg * 64 + w * 16 + 2 * g;  // this thread's columns: col, col + 1
  const uint32_t* tab_lane = tab + lane;
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  uint32_t f[16];

  for (int i = 0; i < steps; ++i) {
    const int st = i % STAGES;
    mbar_wait(&full[st], (i / STAGES) & 1);
    decode_stage<NIBBLE>(f, cs + st * C_STAGE_BYTES, tab_lane, col >> 4, col & 15, q);
#pragma unroll
    for (int r = 0; r < 16; ++r) fence_operand(f[r]);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    const uint64_t desc = desc_b128(smem_u32(xs + st * X_STAGE_BYTES));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n256k16(d, f + 4 * kk, desc + 2 * kk);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    // The next stage's fragments are decoded only after these wgmmas are
    // done: A registers written while wgmmas are in flight make ptxas
    // serialize them anyway. The other consumer warpgroup's wgmmas keep the
    // tensor cores busy meanwhile.
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
#pragma unroll
  for (int i = 0; i < 128; ++i) fence_operand(d[i]);

  // d[4j + {0, 1}]: column col at x rows 8j + 2q + {0, 1}; d[4j + {2, 3}]:
  // column col + 1 at the same rows. One split writes the scaled result;
  // several write unscaled partial sums to work[split].
  const bool split = gridDim.z > 1;
  const float s = split ? 1.f : sf[0];
  float* dst = split ? work + static_cast<size_t>(blockIdx.z) * M * N : out;
  const int n = n0 + col;
  if (n >= N) return;
  const bool pair = n + 1 < N && (N % 2 == 0);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 8 * j + 2 * q + h;
      if (m >= M) continue;
      float* p = dst + static_cast<size_t>(m) * N + n;
      const float lo = d[4 * j + h] * s, hi = d[4 * j + 2 + h] * s;
      if (pair) {
        *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
      } else {
        p[0] = lo;
        if (n + 1 < N) p[1] = hi;
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda through the CUDA runtime, so the
// library links only cudart.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D tiled map of rows of `row_bytes` stride, 128-byte swizzle,
// out-of-bounds elements read as zero.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t inner,
              uint64_t rows, uint64_t row_bytes, uint32_t box_inner, uint32_t box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {inner, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The launch's grid: one block per (128-column, 256-row) output tile, times
// the split-K factor (grid.z) for the current device; steps is the K stages
// of one split. Returns false for a shape the kernel cannot take.
template <bool NIBBLE>
bool plan(int M, int N, int K, dim3* grid, int* steps) {
  if (M <= 0 || N <= 0 || K <= 0) return false;
  auto kernel = elp_bsd_matmul_wgmma_kernel<NIBBLE>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES) !=
      cudaSuccess)
    return false;
  const long long tiles = static_cast<long long>((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  const int nk = (K + BK - 1) / BK;
  const int splits = choose_splits(kernel, THREADS, tiles, nk, MAX_SPLITS, SMEM_BYTES);
  if (splits < 1) return false;
  *steps = (nk + splits - 1) / splits;
  *grid = dim3((N + BN - 1) / BN, (M + BM - 1) / BM, (nk + *steps - 1) / *steps);
  return grid->y <= 65535u;
}

}  // namespace

// C entry points, bound with ctypes. elp_bsd_matmul_wgmma_workspace gives
// the floats of split-K workspace a launch at this shape needs (0 for none),
// or -1 for a shape the kernel cannot take. elp_bsd_matmul_wgmma_bf16 takes
// bf16 x [M, K] with rows x_ld elements apart, codes with rows codes_ld
// bytes apart (ceil(K/2) rows when `nibble`), both 16-byte aligned with
// 16-byte row strides (TMA's rule), the 256-entry decode table in host
// memory, and that workspace; it launches on `stream` and returns the
// cudaError_t of the launches (0 on success), or -1 for an operand, shape
// or workspace the kernel cannot take, or a libcuda without TMA encoding.
extern "C" long long elp_bsd_matmul_wgmma_workspace(int M, int N, int K) {
  dim3 grid;
  int steps;
  // The nibble and u8 kernels share tiles, threads and shared memory: one plan.
  if (!plan<true>(M, N, K, &grid, &steps)) return -1;
  return grid.z > 1 ? static_cast<long long>(grid.z) * M * N : 0;
}

extern "C" int elp_bsd_matmul_wgmma_bf16(const void* x, const uint8_t* codes, const float* sf,
                                         float* out, int M, int N, int K, int nibble,
                                         float* work, long long work_floats,
                                         const uint32_t* table, long long x_ld,
                                         long long codes_ld, void* stream) {
  dim3 grid;
  int steps;
  const bool ok = nibble ? plan<true>(M, N, K, &grid, &steps) : plan<false>(M, N, K, &grid, &steps);
  if (!ok || table == nullptr || x_ld < K || codes_ld < N || (x_ld * 2) % 16 != 0 ||
      codes_ld % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0)
    return -1;
  if (grid.z > 1 && (work == nullptr || work_floats < static_cast<long long>(grid.z) * M * N))
    return -1;
  const int krows = nibble ? (K + 1) / 2 : K;
  CUtensorMap x_map, c_map;
  if (!make_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, x_ld * 2, BK, BM) ||
      !make_map(&c_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, codes, N, krows, codes_ld, BN,
                nibble ? BK / 2 : BK))
    return -1;
  DecodeTable tab;
  for (int i = 0; i < 256; ++i) tab.v[i] = table[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nibble)
    elp_bsd_matmul_wgmma_kernel<true><<<grid, THREADS, SMEM_BYTES, st>>>(
        x_map, c_map, tab, sf, out, work, M, N, K, steps);
  else
    elp_bsd_matmul_wgmma_kernel<false><<<grid, THREADS, SMEM_BYTES, st>>>(
        x_map, c_map, tab, sf, out, work, M, N, K, steps);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || grid.z == 1) return err;
  return splitk_reduce(work, sf, out, static_cast<size_t>(M) * N, grid.z, st);
}

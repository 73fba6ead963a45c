// Tiled ELP_BSD decode + matmul for Hopper (sm_90a) on the tensor cores
// (wgmma), operands fed by TMA: bf16 activations as they are, and float32
// activations split inside the kernel into three bf16 terms (bf16x3, the
// second kernel below).
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
//
// bf16x3: float32 activations (AlexNet's im2col convs, 1.24 GB of x per
// forward at batch 64, so the split is not written to device memory).
// Every decoded weight is exact in bf16, and x = hi + mid + lo exactly with
// each term a bf16 holding 8 of x's 24 significand bits (split_bf16x3,
// hopper.cuh), so each term's products are exact in float32 and the three
// terms' wgmmas sum what the float32 reference sums, in another order: into
// a wgmma accumulator for a few K stages, which the consumer then adds into
// a float32 register sum, as the TPU kernel adds each K block's dot into a
// float32 sum (a whole split summed on the tensor cores drifts with K). Bound: three bf16 passes at the tensor
// cores' rate (about 0.47 ms for AlexNet's five convs) or, for conv0, the
// bytes of x. The same transposed product, at a tile that fits the
// shared memory: 128 weight columns x 96 x rows, wgmma m64n96k16. One
// thread of two producer warpgroups TMA-loads the float32 x tile (two
// 32-column halves, 128-byte swizzle) and the code tile into a 2-slot
// ring; all eight of their warps split each float32 tile into the three
// bf16 tiles in the 128-byte-swizzled K-major layout wgmma's B descriptor
// reads, fence the writes for the async proxy and arrive on a second
// 2-slot ring. Each consumer warpgroup decodes a stage's codes from the
// TMA ring into A fragments while the stage is being split (and the
// previous stage's wgmmas run), then runs the three terms' 12 wgmmas on
// them. The split, not the tensor cores, sets the pace (PERF.md): it
// shares the shared memory with the wgmmas' B reads, and a stage's split
// starts only when the consumers free the stage two before it. At 96 rows
// the tiles of AlexNet's late convs fill the SMs without split-K, whose
// partial sums cost more device memory traffic than the idle SMs of an
// unsplit last wave.
//
// Digit planes (the wgmma_digits and bf16x3_digits routes): a format whose
// decoded values are not all exact in bf16 (two digits more than 7 binary
// places apart) but whose every digit term +-2^shift is a normal bf16, with
// 2 or 3 digits. Each kernel's Dec = DigitPlanes instance computes
// x . W = sum_d x . P_d, P_d the plane of digit d's terms (hopper.cuh): each
// term is exact in bf16, so each product is exact in float32 and only the
// order of the float32 sums differs from the reference (Sec. IV's shift-add
// MAC). Per K stage a consumer decodes each digit's plane in turn into the
// A fragments the table would give (arithmetically, no table: the digit's
// exponent LUT sits in two registers, prmt), and runs TERMS wgmmas x 4 on
// each: a unit is one (stage, digit), two fragment sets let the next unit
// decode while this one's wgmmas run, and a stage is freed after its last
// digit. Both instances add their wgmma accumulator into a float32 register
// sum every 768 products, as the bf16x3 kernel does above (D planes double
// or treble the products a split sums); for that the bf16 instance takes 128
// x rows a block (m64n128k16), not 256. Bound: D (or 3 D) bf16 passes at the
// tensor cores' rate.
#include "elp_decode.cuh"
#include "hopper.cuh"

namespace {

constexpr int BN = 128;  // weight columns (output N) per block: CONSUMERS x 64
constexpr int BM = 256;  // x rows (output M) per block: the wgmma N
constexpr int BK = 64;   // K per stage: one 128-byte swizzled row of bf16 x
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;  // warpgroups
constexpr int PRODUCER_WARP = CONSUMERS * 4;  // issues every TMA load
constexpr int THREADS = (CONSUMERS + 1) * 128;  // the last warpgroup produces
constexpr int MAX_SPLITS = 4;
constexpr int C_STAGE_BYTES = BK * BN;      // 8 KB (u8 rows; nibble fills half)
constexpr int TABLE_WORDS = 256 * 32;       // one copy of the table per lane
// The digit-plane instances' tile: 128 x rows, so that a float32 register sum
// fits beside the wgmma accumulator (64 + 64 floats a thread), into which the
// consumer adds the accumulator every PROMOTE_UNITS units (64 products each:
// 768, as the bf16x3 kernels). With D planes a split sums D K products, and
// a whole split summed on the tensor cores drifts with K (PERF.md).
constexpr int BM_PLANES = 128;
constexpr int PROMOTE_UNITS = 12;
template <class Dec>
struct Tile {
  static constexpr int BM_ = Dec::PLANES ? BM_PLANES : BM;
  static constexpr int X_STAGE = BM_ * BK * 2;  // 32 KB (16 KB)
  static constexpr int SMEM =
      STAGES * (X_STAGE + C_STAGE_BYTES) + TABLE_WORDS * 4 + 2 * STAGES * 8 + 1024;
};

template <bool NIBBLE, class Dec>
__global__ void __launch_bounds__(THREADS, 1)
elp_bsd_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                            const __grid_constant__ CUtensorMap c_map,
                            const __grid_constant__ Dec table,
                            const float* __restrict__ sf, float* __restrict__ out,
                            float* __restrict__ work, int M, int N, int K, int steps_per_split) {
  constexpr int TBM = Tile<Dec>::BM_, X_STAGE = Tile<Dec>::X_STAGE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* xs = smem;                                       // STAGES x [TBM][64] bf16
  uint8_t* cs = xs + STAGES * X_STAGE;                      // STAGES x code tile
  uint32_t* tab = reinterpret_cast<uint32_t*>(cs + STAGES * C_STAGE_BYTES);  // [256][32]
  uint64_t* full = reinterpret_cast<uint64_t*>(tab + TABLE_WORDS);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * TBM;
  const int nk = (K + BK - 1) / BK;
  const int s_beg = blockIdx.z * steps_per_split;
  const int steps = min(nk, s_beg + steps_per_split) - s_beg;

  if constexpr (Dec::PLANES) {
    copy_planes(tab, table, tid, THREADS);  // the table's space holds the planes' words
  } else {
    for (int i = tid; i < TABLE_WORDS; i += THREADS) tab[i] = table.v[i >> 5];
  }
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
        mbar_expect_tx(&full[st], X_STAGE + c_bytes);
        const int k0 = (s_beg + i) * BK;
        tma_load_2d(xs + st * X_STAGE, &x_map, &full[st], k0, m0);
        tma_load_2d(cs + st * C_STAGE_BYTES, &c_map, &full[st], n0, NIBBLE ? k0 / 2 : k0);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  // Consumers: warpgroup wg decodes weight columns [64 wg, 64 wg + 64) of the tile.
  const int wg = warp / 4, w = warp % 4, g = lane / 4, q = lane % 4;
  const int col = wg * 64 + w * 16 + 2 * g;  // this thread's columns: col, col + 1
  float d[TBM / 2];
#pragma unroll
  for (int i = 0; i < TBM / 2; ++i) d[i] = 0.f;
  if constexpr (Dec::PLANES) {
    // Unit u is digit u % nd of K stage u / nd; acc is the float32 sum of d.
    const int nd = table.n, units = steps * nd;
    float acc[TBM / 2];
#pragma unroll
    for (int i = 0; i < TBM / 2; ++i) acc[i] = 0.f;
    auto promote = [&] {
#pragma unroll
      for (int r = 0; r < TBM / 2; ++r) {
        fence_operand(d[r]);
        acc[r] += d[r];
        d[r] = 0.f;
      }
    };
    auto decode = [&](uint32_t(&f)[16], int u) {
      const int i = u / nd, dg = u - i * nd, st = i % STAGES;
      if (dg == 0) mbar_wait(&full[st], (i / STAGES) & 1);
      decode_stage_plane<NIBBLE>(f, cs + st * C_STAGE_BYTES, tab + PLANE_WORDS * dg, col >> 4,
                                 col & 15, q);
    };
    auto issue = [&](uint32_t(&f)[16], int u) {
#pragma unroll
      for (int r = 0; r < 16; ++r) fence_operand(f[r]);
      wgmma_fence();
      const uint64_t desc = desc_b128(smem_u32(xs + (u / nd % STAGES) * X_STAGE));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<TBM, 0>(d, f + 4 * kk, desc + 2 * kk);
      wgmma_commit();
    };
    // After a unit's wgmmas: its stage is free once its last digit is done.
    auto release = [&](int u) {
      const int i = u / nd;
      __syncwarp();
      if (u - i * nd == nd - 1 && lane == 0) mbar_arrive(&empty[i % STAGES]);
    };
    uint32_t fa[16], fb[16];
    decode(fa, 0);
    for (int u = 0; u < units; u += 2) {
      issue(fa, u);
      if (u + 1 < units) decode(fb, u + 1);
      wgmma_wait<0>();
      release(u);
      if (u + 1 >= units) break;
      issue(fb, u + 1);
      if (u + 2 < units) decode(fa, u + 2);
      wgmma_wait<0>();
      release(u + 1);
      if ((u + 2) % PROMOTE_UNITS == 0) promote();
    }
    promote();
#pragma unroll
    for (int r = 0; r < TBM / 2; ++r) d[r] = acc[r];
  } else {
    const uint32_t* tab_lane = tab + lane;
    uint32_t f[16];

    for (int i = 0; i < steps; ++i) {
      const int st = i % STAGES;
      mbar_wait(&full[st], (i / STAGES) & 1);
      decode_stage<NIBBLE>(f, cs + st * C_STAGE_BYTES, tab_lane, col >> 4, col & 15, q);
#pragma unroll
      for (int r = 0; r < 16; ++r) fence_operand(f[r]);
      wgmma_fence();
      const uint64_t desc = desc_b128(smem_u32(xs + st * X_STAGE));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<TBM, 0>(d, f + 4 * kk, desc + 2 * kk);
      wgmma_commit();
      // The next stage's fragments are decoded only after these wgmmas are
      // done: A registers written while wgmmas are in flight make ptxas
      // serialize them anyway. The other consumer warpgroup's wgmmas keep the
      // tensor cores busy meanwhile.
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
  }
#pragma unroll
  for (int i = 0; i < TBM / 2; ++i) fence_operand(d[i]);

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
  for (int j = 0; j < TBM / 8; ++j) {
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

// The launch's grid: one block per (128-column, 256-row; digit planes:
// 128-row) output tile, times the split-K factor (grid.z) for the current
// device; steps is the K stages of one split. Returns false for a shape the
// kernel cannot take.
template <bool NIBBLE, class Dec = DecodeTable>
bool plan(int M, int N, int K, dim3* grid, int* steps) {
  if (M <= 0 || N <= 0 || K <= 0) return false;
  constexpr int TBM = Tile<Dec>::BM_, SMEM = Tile<Dec>::SMEM;
  auto kernel = elp_bsd_matmul_wgmma_kernel<NIBBLE, Dec>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM) !=
      cudaSuccess)
    return false;
  const long long tiles = static_cast<long long>((N + BN - 1) / BN) * ((M + TBM - 1) / TBM);
  const int nk = (K + BK - 1) / BK;
  const int splits = choose_splits(kernel, THREADS, tiles, nk, MAX_SPLITS, SMEM);
  if (splits < 1) return false;
  *steps = (nk + splits - 1) / splits;
  *grid = dim3((N + BN - 1) / BN, (M + TBM - 1) / TBM, (nk + *steps - 1) / *steps);
  return grid->y <= 65535u;
}

// ---------------------------------------------------------------------------
// bf16x3: float32 x, split inside the kernel (see the head of this file).
namespace x3 {
constexpr int BN = 128;  // weight columns per block: CONSUMERS x 64
constexpr int BM = 96;   // x rows per block: the wgmma N
constexpr int BK = 64;   // K per stage: one 128-byte swizzled row of each bf16 term
constexpr int TERMS = 3;
constexpr int CONSUMERS = 2;  // warpgroups
constexpr int PRODUCER_WARP = CONSUMERS * 4;  // the first producer warp
constexpr int SPLIT_THREADS = 256;            // two producer warpgroups
constexpr int THREADS = CONSUMERS * 128 + SPLIT_THREADS;
constexpr int MAX_SPLITS = 4;
// K stages a wgmma accumulator sums before the consumer adds it into its
// float32 register sum (PROMOTE * BK * TERMS = 768 products).
constexpr int PROMOTE = 4;
// Registers a thread after setmaxnreg: the splitters give up what the
// consumers' second sum needs (2 x 128 x (SPLIT_REGS + CONSUMER_REGS) =
// the 64K of the register file, what the launch bound allots).
constexpr int SPLIT_REGS = 80;
constexpr int CONSUMER_REGS = 176;
constexpr int F_STAGES = 2;                  // TMA ring: float32 x and codes
constexpr int B_STAGES = 2;                  // split ring: bf16 terms
constexpr int XF_HALF = BM * 32 * 4;         // 12 KB: [BM][32] float32, 128-byte rows
constexpr int XF_STAGE = 2 * XF_HALF;        // 24 KB
constexpr int C_STAGE = BK * BN;             // 8 KB (u8 rows; nibble fills half)
constexpr int F_SLOT = XF_STAGE + C_STAGE;   // 32 KB
constexpr int XB_TILE = BM * BK * 2;         // 12 KB: one bf16 term, [BM][64]
constexpr int B_SLOT = TERMS * XB_TILE;      // 36 KB
constexpr int SMEM = F_STAGES * F_SLOT + B_STAGES * B_SLOT + TABLE_WORDS * 4 +
                     2 * (F_STAGES + B_STAGES) * 8 + 1024;
static_assert(SMEM <= 232448, "more shared memory than a block can have");
}  // namespace x3

template <bool NIBBLE, class Dec>
__global__ void __launch_bounds__(x3::THREADS, 1)
elp_bsd_matmul_bf16x3_kernel(const __grid_constant__ CUtensorMap x_map,
                             const __grid_constant__ CUtensorMap c_map,
                             const __grid_constant__ Dec table,
                             const float* __restrict__ sf, float* __restrict__ out,
                             float* __restrict__ work, int M, int N, int K, int steps_per_split) {
  constexpr int c_bytes = NIBBLE ? x3::BK / 2 * x3::BN : x3::BK * x3::BN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* fs = smem;                           // F_STAGES x (x halves, codes)
  uint8_t* bs = fs + x3::F_STAGES * x3::F_SLOT;  // B_STAGES x (hi, mid, lo)
  uint32_t* tab = reinterpret_cast<uint32_t*>(bs + x3::B_STAGES * x3::B_SLOT);  // [256][32]
  uint64_t* ffull = reinterpret_cast<uint64_t*>(tab + TABLE_WORDS);
  uint64_t* fempty = ffull + x3::F_STAGES;
  uint64_t* bfull = fempty + x3::F_STAGES;
  uint64_t* bempty = bfull + x3::B_STAGES;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * x3::BN;
  const int m0 = blockIdx.y * x3::BM;
  const int nk = (K + x3::BK - 1) / x3::BK;
  const int s_beg = blockIdx.z * steps_per_split;
  const int steps = min(nk, s_beg + steps_per_split) - s_beg;

  if constexpr (Dec::PLANES) {
    copy_planes(tab, table, tid, x3::THREADS);  // the table's space holds the planes' words
  } else {
    for (int i = tid; i < TABLE_WORDS; i += x3::THREADS) tab[i] = table.v[i >> 5];
  }
  if (tid == 0) {
    for (int s = 0; s < x3::F_STAGES; ++s) {
      mbar_init(&ffull[s], 1);
      // every splitter thread, and every consumer warp once it has decoded the codes
      mbar_init(&fempty[s], x3::SPLIT_THREADS + x3::CONSUMERS * 4);
    }
    for (int s = 0; s < x3::B_STAGES; ++s) {
      mbar_init(&bfull[s], x3::SPLIT_THREADS);
      mbar_init(&bempty[s], x3::CONSUMERS * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  if (warp >= x3::PRODUCER_WARP) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(x3::SPLIT_REGS));
    // The producer warpgroups. Their thread 0 issues the TMA loads of stage
    // i + F_STAGES once every splitter and consumer has read stage i; all
    // 256 split.
    // Unit u is 8 consecutive K of one row (one 16-byte chunk of each bf16
    // term); the 8 threads of a shared-memory phase take 8 rows of one
    // chunk, so the swizzle spreads their accesses over all 32 banks.
    const int sid = tid - x3::PRODUCER_WARP * 32;
    auto load = [&](int i) {
      const int st = i % x3::F_STAGES;
      const int k0 = (s_beg + i) * x3::BK;
      // The second half only where it holds columns below K.
      const bool second = k0 + 32 < K;
      mbar_expect_tx(&ffull[st], x3::XF_HALF * (second ? 2 : 1) + c_bytes);
      uint8_t* slot = fs + st * x3::F_SLOT;
      tma_load_2d(slot, &x_map, &ffull[st], k0, m0);
      if (second) tma_load_2d(slot + x3::XF_HALF, &x_map, &ffull[st], k0 + 32, m0);
      tma_load_2d(slot + x3::XF_STAGE, &c_map, &ffull[st], n0, NIBBLE ? k0 / 2 : k0);
    };
    if (sid == 0)
      for (int i = 0; i < min(steps, x3::F_STAGES); ++i) load(i);
    for (int i = 0; i < steps; ++i) {
      const int fst = i % x3::F_STAGES, bst = i % x3::B_STAGES;
      mbar_wait(&ffull[fst], (i / x3::F_STAGES) & 1);
      if (i >= x3::B_STAGES) mbar_wait(&bempty[bst], (i / x3::B_STAGES - 1) & 1);
      const uint8_t* f = fs + fst * x3::F_SLOT;
      uint8_t* b = bs + bst * x3::B_SLOT;
      const bool second = (s_beg + i) * x3::BK + 32 < K;
#pragma unroll
      for (int it = 0; it < x3::BM * 8 / x3::SPLIT_THREADS; ++it) {
        const int u = sid + it * x3::SPLIT_THREADS;
        const int r = (u & 7) | ((u >> 6) << 3);  // row
        const int j = (u >> 3) & 7;               // bf16 chunk: K 8j .. 8j + 7
        const int h = j >> 2, c0 = 2 * (j & 3);   // float32 half and its first chunk
        float4 lo4 = make_float4(0.f, 0.f, 0.f, 0.f), hi4 = lo4;
        if (h == 0 || second) {
          const uint8_t* row = f + h * x3::XF_HALF + r * 128;
          lo4 = *reinterpret_cast<const float4*>(row + ((c0 ^ (r & 7)) << 4));
          hi4 = *reinterpret_cast<const float4*>(row + (((c0 + 1) ^ (r & 7)) << 4));
        }
        uint4 t[3];
        split_bf16x3_x8(lo4, hi4, t);
        const int off = r * 128 + ((j ^ (r & 7)) << 4);
#pragma unroll
        for (int tt = 0; tt < 3; ++tt)
          *reinterpret_cast<uint4*>(b + tt * x3::XB_TILE + off) = t[tt];
      }
      fence_proxy_async();
      mbar_arrive(&fempty[fst]);
      mbar_arrive(&bfull[bst]);
      if (sid == 0 && i + x3::F_STAGES < steps) {
        mbar_wait(&fempty[fst], (i / x3::F_STAGES) & 1);
        load(i + x3::F_STAGES);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(x3::CONSUMER_REGS));
  // Consumers: warpgroup wg decodes weight columns [64 wg, 64 wg + 64) of the tile.
  const int wg = warp / 4, w = warp % 4, g = lane / 4, q = lane % 4;
  const int col = wg * 64 + w * 16 + 2 * g;  // this thread's columns: col, col + 1
  const uint32_t* tab_lane = tab + lane;
  // d is the wgmma accumulator of the last few stages; acc sums it in
  // float32 every PROMOTE stages, as the TPU kernel adds each K block's dot
  // into its float32 VMEM sum. The tensor cores' own accumulation loses
  // precision over long sums (a whole split in d read 1.04 of the 2e-5
  // limit at K = 25088; PERF.md).
  float d[x3::BM / 2], acc[x3::BM / 2];
#pragma unroll
  for (int r = 0; r < x3::BM / 2; ++r) d[r] = acc[r] = 0.f;
  auto promote = [&] {
#pragma unroll
    for (int r = 0; r < x3::BM / 2; ++r) {
      fence_operand(d[r]);
      acc[r] += d[r];
      d[r] = 0.f;
    }
  };
  // A stage's codes are decoded from the TMA ring, before its split is
  // done; its wgmmas wait for the split.
  auto decode = [&](uint32_t(&f)[16], int i) {
    const int fst = i % x3::F_STAGES;
    mbar_wait(&ffull[fst], (i / x3::F_STAGES) & 1);
    decode_stage<NIBBLE>(f, fs + fst * x3::F_SLOT + x3::XF_STAGE, tab_lane, col >> 4, col & 15,
                         q);
    __syncwarp();
    if (lane == 0) mbar_arrive(&fempty[fst]);
  };
  auto issue = [&](uint32_t(&f)[16], int i) {
    mbar_wait(&bfull[i % x3::B_STAGES], (i / x3::B_STAGES) & 1);
#pragma unroll
    for (int r = 0; r < 16; ++r) fence_operand(f[r]);
    wgmma_fence();
    const uint8_t* b = bs + (i % x3::B_STAGES) * x3::B_SLOT;
#pragma unroll
    for (int t = 0; t < x3::TERMS; ++t) {
      const uint64_t desc = desc_b128(smem_u32(b + t * x3::XB_TILE));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<x3::BM, 0>(d, f + 4 * kk, desc + 2 * kk);
    }
    wgmma_commit();
  };
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&bempty[i % x3::B_STAGES]);
  };
  uint32_t fa[16], fb[16];
  if constexpr (Dec::PLANES) {
    // Unit u is digit u % nd of K stage u / nd: a stage's codes leave the TMA
    // ring after its last digit's decode, its split after its last digit's
    // wgmmas; the accumulator is promoted every PROMOTE units.
    const int nd = table.n, units = steps * nd;
    auto pdecode = [&](uint32_t(&f)[16], int u) {
      const int i = u / nd, dg = u - i * nd, fst = i % x3::F_STAGES;
      if (dg == 0) mbar_wait(&ffull[fst], (i / x3::F_STAGES) & 1);
      decode_stage_plane<NIBBLE>(f, fs + fst * x3::F_SLOT + x3::XF_STAGE,
                                 tab + PLANE_WORDS * dg, col >> 4, col & 15, q);
      __syncwarp();
      if (dg == nd - 1 && lane == 0) mbar_arrive(&fempty[fst]);
    };
    auto prelease = [&](int u) {
      const int i = u / nd;
      __syncwarp();
      if (u - i * nd == nd - 1 && lane == 0) mbar_arrive(&bempty[i % x3::B_STAGES]);
    };
    pdecode(fa, 0);
    for (int u = 0; u < units; u += 2) {
      issue(fa, u / nd);
      if (u + 1 < units) pdecode(fb, u + 1);
      wgmma_wait<0>();
      prelease(u);
      if (u + 1 >= units) break;
      issue(fb, (u + 1) / nd);
      if (u + 2 < units) pdecode(fa, u + 2);
      wgmma_wait<0>();
      prelease(u + 1);
      if ((u + 2) % x3::PROMOTE == 0) promote();
    }
  } else {
    // Two fragment sets: the next stage is decoded while this one's wgmmas run.
    decode(fa, 0);
    for (int j = 0; j < steps; j += 2) {
      issue(fa, j);
      if (j + 1 < steps) decode(fb, j + 1);
      wgmma_wait<0>();
      release(j);
      if (j + 1 >= steps) break;
      issue(fb, j + 1);
      if (j + 2 < steps) decode(fa, j + 2);
      wgmma_wait<0>();
      release(j + 1);
      if ((j + 2) % x3::PROMOTE == 0) promote();
    }
  }
  promote();

  // As the bf16 kernel's epilogue: acc[4j + {0, 1}] column col at x rows
  // 8j + 2q + {0, 1}, acc[4j + {2, 3}] column col + 1.
  const bool split = gridDim.z > 1;
  const float s = split ? 1.f : sf[0];
  float* dst = split ? work + static_cast<size_t>(blockIdx.z) * M * N : out;
  const int n = n0 + col;
  if (n >= N) return;
  const bool pair = n + 1 < N && (N % 2 == 0);
#pragma unroll
  for (int j = 0; j < x3::BM / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 8 * j + 2 * q + h;
      if (m >= M) continue;
      float* p = dst + static_cast<size_t>(m) * N + n;
      const float lo = acc[4 * j + h] * s, hi = acc[4 * j + 2 + h] * s;
      if (pair) {
        *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
      } else {
        p[0] = lo;
        if (n + 1 < N) p[1] = hi;
      }
    }
  }
}

template <bool NIBBLE, class Dec = DecodeTable>
bool plan_bf16x3(int M, int N, int K, dim3* grid, int* steps) {
  if (M <= 0 || N <= 0 || K <= 0) return false;
  auto kernel = elp_bsd_matmul_bf16x3_kernel<NIBBLE, Dec>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, x3::SMEM) !=
      cudaSuccess)
    return false;
  const long long tiles =
      static_cast<long long>((N + x3::BN - 1) / x3::BN) * ((M + x3::BM - 1) / x3::BM);
  const int nk = (K + x3::BK - 1) / x3::BK;
  const int splits = choose_splits(kernel, x3::THREADS, tiles, nk, x3::MAX_SPLITS, x3::SMEM);
  if (splits < 1) return false;
  *steps = (nk + splits - 1) / splits;
  *grid = dim3((N + x3::BN - 1) / x3::BN, (M + x3::BM - 1) / x3::BM, (nk + *steps - 1) / *steps);
  return grid->y <= 65535u;
}

// The bf16 route's launch on decoder `dec` (table or digit planes), then the
// split-K sum where the plan splits K; -1 as the entry points below.
template <class Dec>
int launch_bf16(const void* x, const uint8_t* codes, const float* sf, float* out, int M, int N,
                int K, int nibble, float* work, long long work_floats, const Dec& dec,
                long long x_ld, long long codes_ld, cudaStream_t st) {
  dim3 grid;
  int steps;
  const bool ok = nibble ? plan<true, Dec>(M, N, K, &grid, &steps)
                         : plan<false, Dec>(M, N, K, &grid, &steps);
  if (!ok || x_ld < K || codes_ld < N || (x_ld * 2) % 16 != 0 || codes_ld % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(codes) % 16 != 0)
    return -1;
  if (grid.z > 1 && (work == nullptr || work_floats < static_cast<long long>(grid.z) * M * N))
    return -1;
  const int krows = nibble ? (K + 1) / 2 : K;
  CUtensorMap x_map, c_map;
  if (!make_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, x_ld * 2, BK,
                Tile<Dec>::BM_) ||
      !make_map(&c_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, codes, N, krows, codes_ld, BN,
                nibble ? BK / 2 : BK))
    return -1;
  if (nibble)
    elp_bsd_matmul_wgmma_kernel<true, Dec><<<grid, THREADS, Tile<Dec>::SMEM, st>>>(
        x_map, c_map, dec, sf, out, work, M, N, K, steps);
  else
    elp_bsd_matmul_wgmma_kernel<false, Dec><<<grid, THREADS, Tile<Dec>::SMEM, st>>>(
        x_map, c_map, dec, sf, out, work, M, N, K, steps);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || grid.z == 1) return err;
  return splitk_reduce(work, sf, out, static_cast<size_t>(M) * N, grid.z, st);
}

// The bf16x3 route's launch on decoder `dec`, as launch_bf16.
template <class Dec>
int launch_bf16x3(const void* x, const uint8_t* codes, const float* sf, float* out, int M, int N,
                  int K, int nibble, float* work, long long work_floats, const Dec& dec,
                  long long x_ld, long long codes_ld, cudaStream_t st) {
  dim3 grid;
  int steps;
  const bool ok = nibble ? plan_bf16x3<true, Dec>(M, N, K, &grid, &steps)
                         : plan_bf16x3<false, Dec>(M, N, K, &grid, &steps);
  if (!ok || x_ld < K || codes_ld < N || (x_ld * 4) % 16 != 0 || codes_ld % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(codes) % 16 != 0)
    return -1;
  if (grid.z > 1 && (work == nullptr || work_floats < static_cast<long long>(grid.z) * M * N))
    return -1;
  const int krows = nibble ? (K + 1) / 2 : K;
  CUtensorMap x_map, c_map;
  if (!make_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, K, M, x_ld * 4, 32, x3::BM) ||
      !make_map(&c_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, codes, N, krows, codes_ld, x3::BN,
                nibble ? x3::BK / 2 : x3::BK))
    return -1;
  if (nibble)
    elp_bsd_matmul_bf16x3_kernel<true, Dec><<<grid, x3::THREADS, x3::SMEM, st>>>(
        x_map, c_map, dec, sf, out, work, M, N, K, steps);
  else
    elp_bsd_matmul_bf16x3_kernel<false, Dec><<<grid, x3::THREADS, x3::SMEM, st>>>(
        x_map, c_map, dec, sf, out, work, M, N, K, steps);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || grid.z == 1) return err;
  return splitk_reduce(work, sf, out, static_cast<size_t>(M) * N, grid.z, st);
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
  if (table == nullptr) return -1;
  DecodeTable tab;
  for (int i = 0; i < 256; ++i) tab.v[i] = table[i];
  return launch_bf16(x, codes, sf, out, M, N, K, nibble, work, work_floats, tab, x_ld, codes_ld,
                     static_cast<cudaStream_t>(stream));
}

// The bf16x3 route, with the signatures of the two above: float32 x [M, K]
// with rows x_ld elements apart (16-byte aligned base and row stride), split
// into three bf16 terms inside the kernel. Launches on `stream` (plus the
// split-K sum where the plan splits K) and returns the launches'
// cudaError_t, or -1 as above.
extern "C" long long elp_bsd_matmul_wgmma_bf16x3_workspace(int M, int N, int K) {
  dim3 grid;
  int steps;
  if (!plan_bf16x3<true>(M, N, K, &grid, &steps)) return -1;
  return grid.z > 1 ? static_cast<long long>(grid.z) * M * N : 0;
}

extern "C" int elp_bsd_matmul_wgmma_bf16x3(const void* x, const uint8_t* codes, const float* sf,
                                           float* out, int M, int N, int K, int nibble,
                                           float* work, long long work_floats,
                                           const uint32_t* table, long long x_ld,
                                           long long codes_ld, void* stream) {
  if (table == nullptr) return -1;
  DecodeTable tab;
  for (int i = 0; i < 256; ++i) tab.v[i] = table[i];
  return launch_bf16x3(x, codes, sf, out, M, N, K, nibble, work, work_floats, tab, x_ld,
                       codes_ld, static_cast<cudaStream_t>(stream));
}

// The digit-plane routes (wgmma_digits: bf16 x; bf16x3_digits: float32 x),
// with the signatures above, `planes` in place of the table: the host's
// digit-plane words (hopper.cuh, DigitPlanes). Their plans are the table
// kernels' (the same tiles, threads and shared memory).
extern "C" long long elp_bsd_matmul_wgmma_bf16_digits_workspace(int M, int N, int K) {
  dim3 grid;
  int steps;
  if (!plan<true, DigitPlanes>(M, N, K, &grid, &steps)) return -1;
  return grid.z > 1 ? static_cast<long long>(grid.z) * M * N : 0;
}

extern "C" int elp_bsd_matmul_wgmma_bf16_digits(const void* x, const uint8_t* codes,
                                                const float* sf, float* out, int M, int N, int K,
                                                int nibble, float* work, long long work_floats,
                                                const uint32_t* planes, long long x_ld,
                                                long long codes_ld, void* stream) {
  DigitPlanes dec;
  if (planes == nullptr || !planes_from_host(&dec, planes)) return -1;
  return launch_bf16(x, codes, sf, out, M, N, K, nibble, work, work_floats, dec, x_ld, codes_ld,
                     static_cast<cudaStream_t>(stream));
}

extern "C" long long elp_bsd_matmul_wgmma_bf16x3_digits_workspace(int M, int N, int K) {
  dim3 grid;
  int steps;
  if (!plan_bf16x3<true, DigitPlanes>(M, N, K, &grid, &steps)) return -1;
  return grid.z > 1 ? static_cast<long long>(grid.z) * M * N : 0;
}

extern "C" int elp_bsd_matmul_wgmma_bf16x3_digits(const void* x, const uint8_t* codes,
                                                  const float* sf, float* out, int M, int N,
                                                  int K, int nibble, float* work,
                                                  long long work_floats, const uint32_t* planes,
                                                  long long x_ld, long long codes_ld,
                                                  void* stream) {
  DigitPlanes dec;
  if (planes == nullptr || !planes_from_host(&dec, planes)) return -1;
  return launch_bf16x3(x, codes, sf, out, M, N, K, nibble, work, work_floats, dec, x_ld,
                       codes_ld, static_cast<cudaStream_t>(stream));
}

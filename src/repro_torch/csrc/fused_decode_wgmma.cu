// Decode-step ELP_BSD decode + matmul for Hopper (sm_90a) on the tensor
// cores (wgmma), operands fed by TMA, M <= 256: bf16 activations as they
// are, float32 activations split exactly into three bf16 terms (bf16x3).
//
// Replaces, for bfloat16 activations, the Pallas TPU kernel
// repro/kernels/fused_decode.py::fused_decode_matmul (body _fused_kernel):
// out[M, N] = (x[M, K] . decode(codes)[K, N]) * sf in float32 for the small
// M of a decode step, codes uint8 ([K, N]) or nibble-packed along K
// ([ceil(K/2), N], low nibble = even row), sf one float32 on the device.
// Every decoded value of a format this kernel takes is exact in bf16 (the
// wrapper checks the format) and a product of two bf16 values is exact in
// float32, so only the order of the float32 sums differs from the reference.
//
// Bound on an H100 SXM: the code stream. At qwen3-8b's decode step (M = 16,
// a4 nibble codes) one launch reads K*N/2 code bytes and does 2*16*K*N
// operations: 64 operations per code byte, 214 TFLOP/s at 3.35 TB/s, three
// times the CUDA cores' float32 rate and a fifth of the bf16 tensor-core
// rate. So only the tensor cores bring it to its byte bound (about 7.5 us
// for w1/w3 and w2, 2.5 us for wq/wo, 0.63 us for wk/wv).
//
// Design. The product is computed transposed, out^T = W^T . x^T, as in
// elp_bsd_matmul_wgmma.cu: the decoded weight is wgmma's register A operand
// (one nibble byte is one bf16x2 A register, looked up in a 256-entry table
// stored once per lane so a warp's lookups never share a bank), and x, which
// is K-contiguous, is the B operand as TMA lays it down (128-byte swizzle),
// with wgmma's N the decode batch rounded up to NT in {16, 64, 256}: M = 16
// runs m64n16k16 with no padding, and TMA's out-of-bounds zero
// fill covers ragged M and K (K rows past the logical K load zero
// activations, so a nibble pad code only meets zeros); the epilogue masks M
// and N. A work item is a 128-column strip of the output times a range of
// 64-deep K stages (split-K). The grid is persistent: a few blocks per SM
// (two at NT = 16) walk the items, so the 32 KB table is copied once per
// block, not once per item. One producer warp streams (x, code) stage pairs
// by TMA through a ring of up to 12 stages (96 KB of codes in flight per
// SM at M = 16); the two consumer warpgroups each decode 64 columns and
// run the wgmmas. Decode, not the tensor cores, is the limit at NT = 16:
// each decoded pair feeds only 16 tokens, and at the byte bound an SM must
// decode about 15 code bytes a cycle (the per-lane table allows 32). So a
// consumer decodes the next stage into a second fragment set while the
// current stage's wgmmas run (ptxas keeps them asynchronous: no C7513
// warning), and frees a stage once they are done. Measured (PERF.md), a
// stage still costs a consumer about 1800 cycles of a serial chain: the
// wait, 550-870 cycles of dependent shared-memory loads to decode, the
// wgmmas and their wait; so the codes stream at 0.3-1 TB/s, not 3.35.
// Float32 activations (AlexNet's and VGG16's fc layers, M = 64) take the
// bf16x3 route: a first launch splits x exactly into three bf16 terms
// x = hi + mid + lo (split_bf16x3 in hopper.cuh; [3, M, K] bf16, 4.8 MB for
// AlexNet's fc0), and the kernel's TERMS = 3 instance walks the K stages in
// threes, one x term each, the codes riding with the first. The three
// terms' wgmmas share one A fragment set, decoded once per K block, and one
// wgmma accumulator, which the consumer adds into a float32 register sum
// every PROMOTE K blocks, as the tiled bf16x3 kernel does: each term's
// products with a bf16-exact weight are exact in float32, so the sum is the
// float32 reference's up to the order of its additions. (A whole split
// summed on the tensor cores drifts with K where the products do not cancel
// in sign: VGG16's fc0, post-ReLU x at K = 25088, read 0.756 of the 2e-5
// limit against float64, the plain float32 product 0.062; PERF.md.) The
// second sum leaves no registers for NT = 256, so this route runs the
// NT <= 64 instances on x rows 64 at a time, one launch each.
// Measured (PERF.md): a K block costs a consumer about 1500 cycles at fc0,
// the same decode chain as above with twelve m64n64k16 wgmmas behind it.
// Split-K needs no second launch: every split writes its partial sums to a
// float32 workspace, and the last split of a strip to finish (a per-strip
// counter in device memory, which that split resets to zero for the next
// launch) adds the partials in split order and writes the scaled result,
// so the sums do not depend on block scheduling. The counters make
// concurrent launches on several streams of one device unsafe; the port
// launches on one stream.
#include "hopper.cuh"

namespace {

constexpr int BN = 128;  // weight columns (output N) per work item: CONSUMERS x 64
constexpr int BK = 64;   // K per stage: one 128-byte swizzled row of bf16 x
constexpr int CONSUMERS = 2;  // warpgroups
constexpr int CONSUMER_THREADS = CONSUMERS * 128;
constexpr int PRODUCER_WARP = CONSUMERS * 4;  // issues every TMA load
constexpr int MAX_M = 256;
constexpr int X3_ROWS = 64;  // bf16x3: x rows a launch takes (NT <= 64)
// bf16x3: K blocks (of TERMS stages) the wgmma accumulator sums before the
// consumer adds it into its float32 register sum (PROMOTE * BK * TERMS =
// 768 products, as the tiled bf16x3 kernel).
constexpr int PROMOTE = 4;
constexpr int MAX_STAGES = 12;
constexpr int MAX_SPLITS = 32;
constexpr int MAX_STRIPS = 16384;
constexpr int TABLE_WORDS = 256 * 32;  // one copy of the table per lane
constexpr int SM_SMEM = 228 * 1024;    // shared memory of an SM, 1 KB of it reserved per block

// Splits of each strip finished in the current launch; the last one resets it.
__device__ unsigned int g_strip_done[MAX_STRIPS];

constexpr int blocks_per_sm(int nt) { return nt <= 32 ? 2 : 1; }
// Two blocks an SM: one producer warp (up to 112 registers a thread). One:
// a producer warpgroup, which hands its registers to the consumers.
constexpr int threads_for(int nt) {
  return CONSUMER_THREADS + (blocks_per_sm(nt) == 2 ? 32 : 128);
}

template <int NT, bool NIBBLE>
struct Shape {
  static constexpr int BLOCKS = blocks_per_sm(NT);
  static constexpr int THREADS = threads_for(NT);
  static constexpr int X_STAGE = NT * BK * 2;
  static constexpr int C_STAGE = NIBBLE ? BK / 2 * BN : BK * BN;
  static constexpr int FIXED = TABLE_WORDS * 4 + 2 * MAX_STAGES * 8 + 16 + 1024;  // + alignment
  static constexpr int FIT = (SM_SMEM / BLOCKS - 1024 - FIXED) / (X_STAGE + C_STAGE);
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int SMEM = STAGES * (X_STAGE + C_STAGE) + FIXED;
  static_assert(STAGES >= 2, "the ring needs two stages");
};

// TERMS = 1: x is bf16 [M, K]. TERMS = 3: x is the split [3, M, K] of a
// float32 x, stage i of a block holding term i % 3 of K block i / 3.
template <int NT, bool NIBBLE, int TERMS>
__global__ void __launch_bounds__(threads_for(NT), blocks_per_sm(NT))
fused_decode_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap c_map,
                          const __grid_constant__ DecodeTable table,
                          const float* __restrict__ sf, float* __restrict__ out,
                          float* __restrict__ work, int M, int N, int K, int splits,
                          int steps) {
  using S = Shape<NT, NIBBLE>;
  constexpr int STAGES = S::STAGES;
  // A consumer holds a K block's TERMS stages while it waits for the next one.
  static_assert(TERMS == 1 || STAGES >= TERMS + 1, "the ring cannot hold two K blocks' stages");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* xs = smem;                                                     // STAGES x [NT][64] bf16
  uint8_t* cs = xs + STAGES * S::X_STAGE;                                 // STAGES x code tile
  uint32_t* tab = reinterpret_cast<uint32_t*>(cs + STAGES * S::C_STAGE);  // [256][32]
  uint64_t* full = reinterpret_cast<uint64_t*>(tab + TABLE_WORDS);
  uint64_t* empty = full + STAGES;
  volatile int* last_flag = reinterpret_cast<volatile int*>(empty + STAGES);

  const int tid = threadIdx.x;
  const int nk = (K + BK - 1) / BK;
  const int items = (N + BN - 1) / BN * splits;

  for (int i = tid; i < TABLE_WORDS; i += S::THREADS) tab[i] = table.v[i >> 5];
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
    // With one block per SM the producer warpgroup hands its registers to
    // the consumers' accumulators (NT / 2 floats a thread).
    if constexpr (S::BLOCKS == 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == PRODUCER_WARP && lane == 0) {
      int i = 0;  // stages issued by this block so far
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int n0 = item / splits * BN;
        const int s0 = item % splits * steps, s1 = min(nk, s0 + steps);
        for (int s = s0; s < s1; ++s) {
          for (int t = 0; t < TERMS; ++t, ++i) {
            const int st = i % STAGES;
            if (i >= STAGES) mbar_wait(&empty[st], (i / STAGES - 1) & 1);
            mbar_expect_tx(&full[st], S::X_STAGE + (t == 0 ? S::C_STAGE : 0));
            const int k0 = s * BK;
            if constexpr (TERMS == 1) tma_load_2d(xs + st * S::X_STAGE, &x_map, &full[st], k0, 0);
            else tma_load_3d(xs + st * S::X_STAGE, &x_map, &full[st], k0, 0, t);
            if (t == 0)
              tma_load_2d(cs + st * S::C_STAGE, &c_map, &full[st], n0, NIBBLE ? k0 / 2 : k0);
          }
        }
      }
    }
    return;
  }
  if constexpr (S::BLOCKS == 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");

  // Consumers: warpgroup wg decodes weight columns [64 wg, 64 wg + 64) of the strip.
  const int wg = warp / 4, w = warp % 4, g = lane / 4, q = lane % 4;
  const int col = wg * 64 + w * 16 + 2 * g;  // this thread's columns: col, col + 1
  const uint32_t* tab_lane = tab + lane;
  const float scale = sf[0];
  const size_t mn = static_cast<size_t>(M) * N;

  auto decode = [&](uint32_t(&f)[16], int i) {
    const int st = i % STAGES;
    mbar_wait(&full[st], (i / STAGES) & 1);
    decode_stage<NIBBLE>(f, cs + st * S::C_STAGE, tab_lane, col >> 4, col & 15, q);
  };
  // The wgmmas of the K block whose TERMS stages start at stage i, all on
  // the A fragments f (decoded from stage i's codes, whose wait decode did).
  auto issue = [&](float(&d)[NT / 2], uint32_t(&f)[16], int i) {
#pragma unroll
    for (int t = 1; t < TERMS; ++t) mbar_wait(&full[(i + t) % STAGES], ((i + t) / STAGES) & 1);
#pragma unroll
    for (int r = 0; r < 16; ++r) fence_operand(f[r]);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < TERMS; ++t) {
      const uint64_t desc = desc_b128(smem_u32(xs + ((i + t) % STAGES) * S::X_STAGE));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<NT, 0>(d, f + 4 * kk, desc + 2 * kk);
    }
    wgmma_commit();
  };
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) {
#pragma unroll
      for (int t = 0; t < TERMS; ++t) mbar_arrive(&empty[(i + t) % STAGES]);
    }
  };

  int i = 0;  // stages consumed by this block so far (TERMS per K block)
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int strip = item / splits, split = item % splits;
    const int s0 = split * steps, n_st = min(nk, s0 + steps) - s0;
    // bf16x3: d holds the last few K blocks' wgmma sums, acc their float32 sum.
    float d[NT / 2], acc[TERMS == 3 ? NT / 2 : 1];
#pragma unroll
    for (int r = 0; r < NT / 2; ++r) d[r] = 0.f;
#pragma unroll
    for (int r = 0; r < (TERMS == 3 ? NT / 2 : 1); ++r) acc[r] = 0.f;
    auto promote = [&] {
      if constexpr (TERMS == 3) {
#pragma unroll
        for (int r = 0; r < NT / 2; ++r) {
          fence_operand(d[r]);
          acc[r] += d[r];
          d[r] = 0.f;
        }
      }
    };
    uint32_t fa[16], fb[16];
    // Two fragment sets: the next K block is decoded while this one's wgmmas run.
    decode(fa, i);
    for (int j = 0; j < n_st; j += 2) {
      issue(d, fa, i + TERMS * j);
      if (j + 1 < n_st) decode(fb, i + TERMS * (j + 1));
      wgmma_wait<0>();
      release(i + TERMS * j);
      if (j + 1 >= n_st) break;
      issue(d, fb, i + TERMS * (j + 1));
      if (j + 2 < n_st) decode(fa, i + TERMS * (j + 2));
      wgmma_wait<0>();
      release(i + TERMS * (j + 1));
      if ((j + 2) % PROMOTE == 0) promote();
    }
    i += TERMS * n_st;
    promote();
#pragma unroll
    for (int r = 0; r < NT / 2; ++r) fence_operand(d[r]);
    if constexpr (TERMS == 3) {
#pragma unroll
      for (int r = 0; r < NT / 2; ++r) d[r] = acc[r];
    }

    // d[4j + {0, 1}]: column col at x rows 8j + 2q + {0, 1}; d[4j + {2, 3}]:
    // column col + 1 at the same rows.
    const int n = strip * BN + col;
    if (splits == 1) {
      if (n < N) {
#pragma unroll
        for (int j = 0; j < NT / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = 8 * j + 2 * q + h;
            if (m >= M) continue;
            out[static_cast<size_t>(m) * N + n] = d[4 * j + h] * scale;
            if (n + 1 < N) out[static_cast<size_t>(m) * N + n + 1] = d[4 * j + 2 + h] * scale;
          }
      }
      continue;
    }
    float* part = work + split * mn;
    if (n < N) {
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 8 * j + 2 * q + h;
          if (m >= M) continue;
          part[static_cast<size_t>(m) * N + n] = d[4 * j + h];
          if (n + 1 < N) part[static_cast<size_t>(m) * N + n + 1] = d[4 * j + 2 + h];
        }
    }
    __threadfence();
    named_bar_sync(1, CONSUMER_THREADS);
    if (tid == 0) {
      const bool last = atomicAdd(&g_strip_done[strip], 1u) == static_cast<unsigned>(splits - 1);
      if (last) g_strip_done[strip] = 0;
      *last_flag = last;
    }
    named_bar_sync(1, CONSUMER_THREADS);
    if (!*last_flag || n >= N) continue;
    __threadfence();
    // The last split adds every split's partial sums in split order (its
    // own from registers: the same values it wrote), for up to 32 of its
    // outputs at a time: each split's loads for them are issued together,
    // so the sum waits for one L2 round trip per split, not one per
    // output and split.
    constexpr int CH = NT / 2 < 32 ? NT / 2 : 32;
#pragma unroll
    for (int r0 = 0; r0 < NT / 2; r0 += CH) {
      float v[CH];
      for (int s = 0; s < splits; ++s) {
#pragma unroll
        for (int e = 0; e < CH; ++e) {
          // d[r]: column n + c at x row 8j + 2q + h
          const int r = r0 + e, j = r >> 2, c = (r >> 1) & 1, h = r & 1;
          const int m = 8 * j + 2 * q + h;
          float p = d[r];
          if (s != split)
            p = m < M && n + c < N
                    ? __ldcg(work + s * mn + static_cast<size_t>(m) * N + n + c)
                    : 0.f;
          v[e] = s == 0 ? p : v[e] + p;
        }
      }
#pragma unroll
      for (int e = 0; e < CH; ++e) {
        const int r = r0 + e, j = r >> 2, c = (r >> 1) & 1, h = r & 1;
        const int m = 8 * j + 2 * q + h;
        if (m < M && n + c < N) out[static_cast<size_t>(m) * N + n + c] = v[e] * scale;
      }
    }
  }
}

// The launch's plan for the current device: the split-K factor, the K
// stages of one split, and the persistent grid (at most one block per
// resident slot). The split minimises the stage time of the busiest slot,
// waves * (stages per split + 2), plus one stage per split for the last
// split's sum. Returns false for a shape the kernel cannot take.
bool plan(int M, int N, int K, int* grid, int* splits, int* steps) {
  if (M <= 0 || M > MAX_M || N <= 0 || K <= 0) return false;
  const long long strips = (N + BN - 1) / BN;
  if (strips > MAX_STRIPS) return false;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return false;
  const int nt = M <= 16 ? 16 : M <= 64 ? 64 : 256;
  const long long slots = static_cast<long long>(sms) * blocks_per_sm(nt);
  const int nk = (K + BK - 1) / BK;
  long long best_cost = -1;
  for (int s = 1; s <= MAX_SPLITS && s <= nk; ++s) {
    const int st = (nk + s - 1) / s;
    if ((nk + st - 1) / st != s) continue;  // every split holds at least one stage
    const long long waves = (strips * s + slots - 1) / slots;
    const long long cost = waves * (st + 2) + (s > 1 ? s : 0);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      *splits = s;
      *steps = st;
    }
  }
  *grid = static_cast<int>(strips * *splits < slots ? strips * *splits : slots);
  return true;
}

// x is bf16 [M, K] (TERMS = 1) or three planes [M, K] (TERMS = 3) plane_ld
// elements apart, rows x_ld elements apart.
template <int NT, bool NIBBLE, int TERMS>
int launch(const void* x, const uint8_t* codes, const float* sf, float* out, int M, int N, int K,
           float* work, const DecodeTable& tab, long long x_ld, long long plane_ld,
           long long codes_ld, int grid, int splits, int steps, cudaStream_t stream) {
  using S = Shape<NT, NIBBLE>;
  auto kernel = fused_decode_wgmma_kernel<NT, NIBBLE, TERMS>;
  // All of the SM's memory as shared memory, so BLOCKS blocks fit on one.
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM) !=
          cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared) != cudaSuccess)
    return -1;
  const int krows = NIBBLE ? (K + 1) / 2 : K;
  CUtensorMap x_map, c_map;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M), TERMS};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(x_ld * 2),
                                 static_cast<cuuint64_t>(plane_ld * 2)};
  const cuuint32_t box[3] = {BK, NT, 1};
  if (!make_map_nd(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, TERMS == 1 ? 2 : 3, x, dims, strides,
                   box) ||
      !make_map(&c_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, codes, N, krows, codes_ld, BN,
                NIBBLE ? BK / 2 : BK))
    return -1;
  kernel<<<grid, S::THREADS, S::SMEM, stream>>>(x_map, c_map, tab, sf, out, work, M, N, K, splits,
                                             steps);
  return static_cast<int>(cudaGetLastError());
}

// TERMS = 3 takes M <= X3_ROWS: its NT = 256 instance is never built.
template <bool NIBBLE, int TERMS>
int launch_nt(const void* x, const uint8_t* codes, const float* sf, float* out, int M, int N,
              int K, float* work, const DecodeTable& tab, long long x_ld, long long plane_ld,
              long long codes_ld, int grid, int splits, int steps, cudaStream_t st) {
  if (M <= 16)
    return launch<16, NIBBLE, TERMS>(x, codes, sf, out, M, N, K, work, tab, x_ld, plane_ld,
                                     codes_ld, grid, splits, steps, st);
  if (TERMS == 3 && M > X3_ROWS) return -1;
  if constexpr (TERMS == 1) {
    if (M > 64)
      return launch<256, NIBBLE, 1>(x, codes, sf, out, M, N, K, work, tab, x_ld, plane_ld,
                                    codes_ld, grid, splits, steps, st);
  }
  return launch<64, NIBBLE, TERMS>(x, codes, sf, out, M, N, K, work, tab, x_ld, plane_ld,
                                   codes_ld, grid, splits, steps, st);
}

// The bf16x3 route's first launch: float32 x [M, K] (rows x_ld apart) into
// x3 [3][M][kp] bf16 (hi, mid, lo; split_bf16x3), eight elements a thread,
// zero past K. vec: x and x_ld allow 16-byte loads.
__global__ void split_x_kernel(const float* __restrict__ x, long long x_ld, int M, int K, int kp,
                               int vec, uint4* __restrict__ x3) {
  const int chunks = kp / 8;
  const long long u = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (u >= static_cast<long long>(M) * chunks) return;
  const int m = static_cast<int>(u / chunks), k0 = 8 * static_cast<int>(u % chunks);
  const float* row = x + m * x_ld;
  float4 a, b;
  if (vec && k0 + 8 <= K) {
    a = *reinterpret_cast<const float4*>(row + k0);
    b = *reinterpret_cast<const float4*>(row + k0 + 4);
  } else {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = k0 + j < K ? row[k0 + j] : 0.f;
    a = make_float4(v[0], v[1], v[2], v[3]);
    b = make_float4(v[4], v[5], v[6], v[7]);
  }
  uint4 t[3];
  split_bf16x3_x8(a, b, t);
  const long long plane = static_cast<long long>(M) * chunks;
#pragma unroll
  for (int i = 0; i < 3; ++i) x3[i * plane + u] = t[i];
}

// The bf16x3 route's split of x: rows of K rounded up to 16 bytes of bf16,
// after the split-K partial sums (16-byte aligned) in the workspace.
int padded_k(int K) { return (K + 7) / 8 * 8; }
long long partial_floats(int M, int N, int splits) {
  return splits > 1 ? (static_cast<long long>(splits) * M * N + 3) / 4 * 4 : 0;
}
// The bf16x3 route's split-K partial sums: the most one of its launches (x
// rows X3_ROWS at a time) needs, or -1 for a shape the kernel cannot take.
long long x3_partial_floats(int M, int N, int K) {
  if (M <= 0 || M > MAX_M) return -1;
  long long most = 0;
  for (int m0 = 0; m0 < M; m0 += X3_ROWS) {
    int grid, splits, steps;
    const int mc = M - m0 < X3_ROWS ? M - m0 : X3_ROWS;
    if (!plan(mc, N, K, &grid, &splits, &steps)) return -1;
    const long long p = partial_floats(mc, N, splits);
    if (p > most) most = p;
  }
  return most;
}

}  // namespace

// C entry points, bound with ctypes, with the signatures of
// elp_bsd_matmul_wgmma.cu's. fused_decode_wgmma_workspace gives the floats
// of split-K workspace a launch at this shape needs (0 for none), or -1 for
// a shape the kernel cannot take. fused_decode_wgmma_bf16 takes bf16 x
// [M, K] (M <= 256) with rows x_ld elements apart, codes with rows codes_ld
// bytes apart (ceil(K/2) rows when `nibble`), both 16-byte aligned with
// 16-byte row strides (TMA's rule), the 256-entry decode table in host
// memory, and that workspace; it launches once on `stream` and returns the
// launch's cudaError_t (0 on success), or -1 for an operand, shape or
// workspace the kernel cannot take, or a libcuda without TMA encoding.
extern "C" long long fused_decode_wgmma_workspace(int M, int N, int K) {
  int grid, splits, steps;
  if (!plan(M, N, K, &grid, &splits, &steps)) return -1;
  return splits > 1 ? static_cast<long long>(splits) * M * N : 0;
}

extern "C" int fused_decode_wgmma_bf16(const void* x, const uint8_t* codes, const float* sf,
                                       float* out, int M, int N, int K, int nibble,
                                       float* work, long long work_floats,
                                       const uint32_t* table, long long x_ld,
                                       long long codes_ld, void* stream) {
  int grid, splits, steps;
  if (!plan(M, N, K, &grid, &splits, &steps) || table == nullptr || x_ld < K || codes_ld < N ||
      (x_ld * 2) % 16 != 0 || codes_ld % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0)
    return -1;
  if (splits > 1 && (work == nullptr || work_floats < static_cast<long long>(splits) * M * N))
    return -1;
  DecodeTable tab;
  for (int i = 0; i < 256; ++i) tab.v[i] = table[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return nibble ? launch_nt<true, 1>(x, codes, sf, out, M, N, K, work, tab, x_ld, 0, codes_ld,
                                     grid, splits, steps, st)
                : launch_nt<false, 1>(x, codes, sf, out, M, N, K, work, tab, x_ld, 0, codes_ld,
                                      grid, splits, steps, st);
}

// The bf16x3 route, with the signatures of the two above: float32 x [M, K]
// (M <= 256) with rows x_ld elements apart, codes as above. Its workspace
// holds the split-K partial sums and, after them, the split of x
// ([3, M, K rounded up to 8] bf16). Launches on `stream`: the split, then
// the TERMS = 3 kernel on x rows X3_ROWS at a time; returns the first
// failing launch's cudaError_t (0 on success), or -1 as above.
extern "C" long long fused_decode_wgmma_bf16x3_workspace(int M, int N, int K) {
  const long long part = x3_partial_floats(M, N, K);
  return part < 0 ? -1 : part + 3LL * M * padded_k(K) / 2;
}

extern "C" int fused_decode_wgmma_bf16x3(const void* x, const uint8_t* codes, const float* sf,
                                         float* out, int M, int N, int K, int nibble,
                                         float* work, long long work_floats,
                                         const uint32_t* table, long long x_ld,
                                         long long codes_ld, void* stream) {
  const long long part = x3_partial_floats(M, N, K);
  if (part < 0 || table == nullptr || x_ld < K || codes_ld < N || codes_ld % 16 != 0 ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0 || work == nullptr ||
      reinterpret_cast<uintptr_t>(work) % 16 != 0)
    return -1;
  const int kp = padded_k(K);
  if (work_floats < part + 3LL * M * kp / 2) return -1;
  uint4* x3 = reinterpret_cast<uint4*>(work + part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long units = static_cast<long long>(M) * (kp / 8);
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && x_ld % 4 == 0;
  split_x_kernel<<<static_cast<unsigned>((units + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(x), x_ld, M, K, kp, vec, x3);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  DecodeTable tab;
  for (int i = 0; i < 256; ++i) tab.v[i] = table[i];
  // Launches of one stream run in order, so each reuses the partial sums'
  // space and the strips' counters (reset by each launch's last splits).
  for (int m0 = 0; m0 < M; m0 += X3_ROWS) {
    int grid, splits, steps;
    const int mc = M - m0 < X3_ROWS ? M - m0 : X3_ROWS;
    plan(mc, N, K, &grid, &splits, &steps);
    const uint16_t* xm = reinterpret_cast<const uint16_t*>(x3) + static_cast<long long>(m0) * kp;
    float* om = out + static_cast<long long>(m0) * N;
    const long long plane = static_cast<long long>(M) * kp;
    const int e = nibble ? launch_nt<true, 3>(xm, codes, sf, om, mc, N, K, work, tab, kp, plane,
                                              codes_ld, grid, splits, steps, st)
                         : launch_nt<false, 3>(xm, codes, sf, om, mc, N, K, work, tab, kp, plane,
                                               codes_ld, grid, splits, steps, st);
    if (e != 0) return e;
  }
  return 0;
}

// Flash attention for Hopper (sm_90a) on the tensor cores (wgmma), operands
// fed by TMA: bf16 q, k, v as they are, and float32 q, k, v split inside the
// kernel into three bf16 terms each (bf16x3, the second kernel below).
//
// Replaces, for bfloat16 inputs, the Pallas TPU kernel
// repro/kernels/flash_attention.py::flash_attention (body _flash_kernel):
// out = softmax(q k^T / sqrt(hd) [+ causal mask]) v over q [B, H, Sq, hd]
// and k/v [B, KVH, Sk, hd], with an online softmax whose running max m,
// running sum l and accumulator are float32, masked logits set to -1e30
// (not -inf), l clamped at 1e-30 before the final division, and the output
// written in bf16. The semantics are those of flash_attention.cu, the
// float32 kernel: a causal block stops at its diagonal key tile and blocks
// run longest first; k and v may have fewer heads than q (head h reads
// key/value head h / group); every tensor is read through its (batch,
// head, seq) strides, so a [B, S, H, hd] activation is read in place;
// q_offset places the queries after a cached prefix for the causal mask.
//
// Bound on an H100 SXM: bytes. The causal prefill of qwen3-8b at b16 s128
// (k and v with 8 of 32 heads) moves 42 MB (q, k, v read once, out written
// once; 12.5 us at 3.35 TB/s) and does 2.2 GFLOP (2.2 us at the 989 TFLOP/s
// bf16 rate).
//
// Design. One block per (batch*head, 64-query tile): one consumer
// warpgroup owns the 64 query rows, one producer warp loads the Q tile once
// and the 64-key K and V tiles through a 2-stage TMA ring (4-D tensor maps
// over the (hd, and the seq, head, batch axes in stride order), 128-byte
// swizzle, out-of-bounds rows and columns read as zero, so ragged Sq, Sk and
// hd need no copies). S = Q K^T is wgmma m64n64k16 with Q as the
// shared-memory A operand and K as the K-major B operand (hd is
// contiguous: no transpose); the scale 1/sqrt(hd) multiplies the float32
// logits after the product, where the reference scales q in float32 before
// it, a difference of float32 rounding of the logit only. The masked
// softmax runs on the accumulator in registers (a row's values sit in one
// quad of lanes), its exponentials taken as 2^x of logits scaled by
// log2(e) (one ex2.approx each, relative error about 2^-22, where the
// accurate expf costs about ten instructions: per tile the softmax, not the
// wgmmas, is most of the instructions a thread issues). P. V takes P from
// the accumulator, which has the layout of wgmma's register A fragment, and
// V as an MN-major B operand through wgmma's transpose bit. The reference multiplies float32 P by V; a bf16 P
// would lose 8 bits of it, so P is split into P_hi = bf16(P) and P_lo =
// bf16(P - P_hi), and two wgmmas add P_hi V and P_lo V into the same
// float32 accumulator: P_hi + P_lo carries 16 bits of P, within about 2^-16
// of it. The kernel is bytes-bound with more than 5x compute headroom, so
// the second product costs close to nothing. Measured (PERF.md), a
// two-tile block at qwen3-8b's prefill shape spends about a third of its
// life waiting for its second K/V tile behind the first wave's loads.
//
// bf16x3: float32 q, k and v (the float32 LMs' prefill), replacing for them
// the same TPU kernel and the float32 CUDA-core kernel flash_attention.cu,
// which runs at most at the 67 TFLOP/s float32 rate. The semantics are the
// bf16 kernel's with the reference's float32 arithmetic: q is scaled by
// 1/sqrt(hd) in float32 before anything else (as the reference scales it),
// the output is float32, divided by max(l, 1e-30). Each float32 operand is
// split exactly into three bf16 terms, x = hi + mid + lo (split_bf16x3,
// hopper.cuh; 8 significand bits each, so a product of two terms is exact in
// float32), and each product is a sum of the terms' cross-products a_i b_j
// (repro_torch/kernels/ref.py::FLASH_PRODUCTS, about 2^-8 (i + j) of a b):
// S = Q K^T takes the six with i + j <= 2 (hi.hi, hi.mid, mid.hi, hi.lo,
// mid.mid, lo.hi; 48 wgmma m64n64k16 a 64-key tile at hd 128), P V the first
// five of them (P split the same way in registers, into the register A
// fragments; V's three terms read through the transpose bit; 40 wgmmas).
// The count is the fewest whose worst error stays under half the float32
// limit (2e-5 of max |out|) at every test shape: the CPU model
// (ref.flash_attention_bf16x3, tests/test_torch_flash_bf16x3.py) reads at
// most 0.47 of the limit with (6, 5) against the JAX kernel, and above half
// at some shape with every smaller set: (6, 4) 0.86, (5, 5) 1.42, (4, 6)
// 2.73, the hi terms alone (1, 1) 234-1054. Each product's wgmmas are
// issued smallest term pair first, into a zeroed accumulator: issued hi.hi
// first, the tensor cores' accumulation adds the small terms to a large sum
// and loses much of what they carry. Each tile's P V is summed into a
// zeroed accumulator and added into a float32 register sum, scaled by the
// softmax correction there (a P V summed across every tile on the tensor
// cores drifts, as the matmuls' long K sums do); S sums at most 6 x 128 =
// 768 products, the interval at which the bf16x3 matmuls promote theirs.
//
// Design: one block per (batch*head, 128-query tile), causal blocks stopping
// at their diagonal key tile and running longest first. Two consumer
// warpgroups own 64 query rows each and run their wgmmas and softmax; they
// take turns to issue (S of tile t: consumer 0 then 1; P V: 0 then 1; each
// hands the turn on once its wgmmas are issued), so one's wgmmas run while
// the other computes its softmax, and both read one split of each K and V
// tile. One splitter warpgroup's thread 0 TMA-loads float32 tiles
// ([64 rows][32 float32] boxes, 128-byte swizzle): Q's two halves first,
// then each key tile's K and V as two units; all 128 of its threads split
// each arrived tile into the three bf16 terms in the 128-byte-swizzled
// layout wgmma's descriptors read (TMA's bf16 layout), into a consumer's Q
// terms or a 2-slot ring of split tiles (slot 0 K, slot 1 V), so tile
// t + 1's K is split while tile t's P V runs. Shared memory at hd 128: the
// two consumers' Q terms 2 x 48 KB, the split ring 2 x 48 KB, a one-slot
// float32 ring of 32 KB: 224 KB and the barriers, one block an SM; at hd 64
// half of each and two float32 slots, 128 KB. Two stages of the whole set
// for one consumer (float32 and split K, V and Q) would already take 272 KB
// at hd 128; one consumer with a 2-slot float32 ring (208 KB) fits but ran
// slower at the 4096-key shapes. The splitters give registers to
// the consumers (setmaxnreg: 72 and 216 a thread). Bound on an H100 SXM:
// operations at 989 / 5.5 TFLOP/s (6 and 5 bf16 products for the two
// float32 products of a query-key pair), or the bytes of q, k, v and out at
// 3.35 TB/s at the LM's short prefills; at [1, 32, 4096, 128] causal 0.77 ms
// (2.05 ms at the float32 rate).
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block: the consumer warpgroup's wgmma M
constexpr int BKV = 64;  // keys per step
constexpr int STAGES = 2;
constexpr int THREADS = 128 + 32;  // one consumer warpgroup, one producer warp
constexpr int HALF_BYTES = 64 * 128;  // one [64 rows][64 bf16] swizzled tile: 8 KB
constexpr float NEG = -1e30f;

template <int HD>
struct Smem {
  static constexpr int HALVES = HD / 64;
  static constexpr int TILE = HALVES * HALF_BYTES;  // a [64][HD] tile, one half per 64 of hd
  static constexpr int BYTES = TILE + STAGES * 2 * TILE + 1024 + 1024;  // + barriers, alignment
};

// Per tensor map (q, k, v): the logical axis (0 batch, 1 head, 2 seq) of
// map dimensions 1..3, in ascending stride order.
struct Axes {
  int q[3], k[3], v[3];
};

__device__ __forceinline__ int pick(const int* axes, int i, int b, int h, int s) {
  const int a = axes[i];
  return a == 0 ? b : a == 1 ? h : s;
}

// 2^x (ex2.approx: relative error about 2^-22; 0 for the masked logits).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map, const Axes axes,
                             __nv_bfloat16* __restrict__ o, long long os0, long long os1,
                             long long os2, int H, int group, int Sq, int Sk, int hd,
                             int causal, int q_offset, float scale) {
  using S = Smem<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* qs = smem;                      // [64][HD] bf16, one swizzled half per 64 of hd
  uint8_t* ks = qs + S::TILE;              // STAGES x [64 keys][HD]
  uint8_t* vs = ks + STAGES * S::TILE;     // STAGES x [64 keys][HD]
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + STAGES * S::TILE);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal tiles first
  int n_kt = (Sk + BKV - 1) / BKV;
  if (causal) {
    const int last_key = q_offset + min(q0 + BQ, Sq) - 1;  // the block's last visible key
    n_kt = min(n_kt, last_key / BKV + 1);
  }

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  if (warp == 4) {
    if (lane == 0) {
      mbar_expect_tx(q_full, S::TILE);
      for (int c = 0; c < S::HALVES; ++c)
        tma_load_4d(qs + c * HALF_BYTES, &q_map, q_full, 64 * c, pick(axes.q, 0, b, h, q0),
                    pick(axes.q, 1, b, h, q0), pick(axes.q, 2, b, h, q0));
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[st], (kt / STAGES - 1) & 1);
        mbar_expect_tx(&full[st], 2 * S::TILE);
        const int k0 = kt * BKV;
        for (int c = 0; c < S::HALVES; ++c) {
          tma_load_4d(ks + st * S::TILE + c * HALF_BYTES, &k_map, &full[st], 64 * c,
                      pick(axes.k, 0, b, kvh, k0), pick(axes.k, 1, b, kvh, k0),
                      pick(axes.k, 2, b, kvh, k0));
          tma_load_4d(vs + st * S::TILE + c * HALF_BYTES, &v_map, &full[st], 64 * c,
                      pick(axes.v, 0, b, kvh, k0), pick(axes.v, 1, b, kvh, k0),
                      pick(axes.v, 2, b, kvh, k0));
        }
      }
    }
    return;
  }

  // Consumer warpgroup. Accumulator layout of m64nN: d[4j + 2r + e] is row
  // 16 warp + g + 8r, column 8j + 2qd + e.
  const int g = lane / 4, qd = lane % 4;
  float acc[S::HALVES][32];
#pragma unroll
  for (int c = 0; c < S::HALVES; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  // m is kept in log2 units: the logits are scaled by scale * log2(e), so
  // exp(x - m) is one 2^x.
  const float scale_log2 = scale * 1.4426950408889634f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % STAGES;
    mbar_wait(&full[st], (kt / STAGES) & 1);
    const uint8_t* kst = ks + st * S::TILE;
    const uint8_t* vst = vs + st * S::TILE;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = (kk / 4) * HALF_BYTES + (kk % 4) * 32;
      wgmma_ss_n64(s, desc_b128(smem_u32(qs + off)), desc_b128(smem_u32(kst + off)));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(s[i]);

    // Masked online softmax, rows r = 0 (row g) and 1 (row g + 8) of this
    // warp. Only a tile that reaches past Sk or the block's first query
    // is masked.
    const int k0 = kt * BKV;
    const bool masked = k0 + BKV > Sk || (causal && k0 + BKV - 1 > q_offset + q0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = q_offset + q0 + 16 * warp + g + 8 * r;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * j + 2 * qd + e;
          float x = s[4 * j + 2 * r + e] * scale_log2;
          if (masked && (kpos >= Sk || (causal && qpos < kpos))) x = NEG;
          s[4 * j + 2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float corr = exp2_approx(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2_approx(s[4 * j + 2 * r + e] - m_new);
          s[4 * j + 2 * r + e] = p;
          rs += p;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[r] = l[r] * corr + rs;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < S::HALVES; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) acc[c][4 * j + 2 * r + e] *= corr;
    }

    // P as A fragments, split into bf16 P_hi and P_lo. Register a of k16
    // step kk holds keys 16 kk + 8 (a >> 1) + 2 qd + {0, 1} of row r = a & 1:
    // accumulator pair 4 (2 kk + (a >> 1)) + 2 (a & 1).
    uint32_t ph[16], pl[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = 4 * (2 * kk + (a >> 1)) + 2 * (a & 1);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(s[i], s[i + 1]);
        ph[4 * kk + a] = bf16x2_bits(hi);
        pl[4 * kk + a] = bf16x2_bits(__floats2bfloat162_rn(s[i] - __low2float(hi),
                                                           s[i + 1] - __high2float(hi)));
      }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      fence_operand(ph[i]);
      fence_operand(pl[i]);
    }
#pragma unroll
    for (int c = 0; c < S::HALVES; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(acc[c][i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < S::HALVES; ++c) {
        const uint64_t desc = desc_mn128(smem_u32(vst + c * HALF_BYTES + kk * 16 * 128));
        wgmma_rs<64, 1>(acc[c], ph + 4 * kk, desc);
        wgmma_rs<64, 1>(acc[c], pl + 4 * kk, desc);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < S::HALVES; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(acc[c][i]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // One reciprocal per row (the output is rounded to bf16, so multiplying by
  // it instead of dividing each element changes nothing the output keeps),
  // and hd pairs written as one 4-byte store where q's strides allow.
  __nv_bfloat16* ob = o + b * os0 + h * os1;
  const bool pairs = hd % 2 == 0 && os2 % 2 == 0 && reinterpret_cast<uintptr_t>(ob) % 4 == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = ob + row * os2;
#pragma unroll
    for (int c = 0; c < S::HALVES; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * c + 8 * j + 2 * qd;
        const float lo = acc[c][4 * j + 2 * r] * inv, hi = acc[c][4 * j + 2 * r + 1] * inv;
        if (pairs && d + 1 < hd) {
          *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(lo, hi);
        } else {
          if (d < hd) orow[d] = __float2bfloat16_rn(lo);
          if (d + 1 < hd) orow[d + 1] = __float2bfloat16_rn(hi);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// bf16x3: float32 q, k and v (see the head of this file).
namespace x3 {
constexpr int S_PRODUCTS = 6;   // cross-products summed for S = Q K^T
constexpr int PV_PRODUCTS = 5;  // and for P V (the head of this file says why)
constexpr int P_TERMS = 2;      // terms of P those five use (hi, mid)
constexpr int CONSUMERS = 2;                  // warpgroups, 64 query rows each
constexpr int BQ = CONSUMERS * 64;            // query rows a block
constexpr int SPLITTER_WARP = CONSUMERS * 4;  // the splitter warpgroup's first warp
constexpr int THREADS = (CONSUMERS + 1) * 128;
// Registers a thread after setmaxnreg: the splitters give up what the
// consumers take, 128 x (168 - SPLIT_REGS) = 256 x (CONSUMER_REGS - 168), 168
// being what the launch bound allots each of the 384 threads (65536 / 384,
// rounded down to a multiple of 8). A consumer's increase waits for the
// registers the splitters free, so more would never start.
constexpr int SPLIT_REGS = 72;
constexpr int CONSUMER_REGS = 216;
static_assert(128 * (168 - SPLIT_REGS) == 256 * (CONSUMER_REGS - 168), "registers moved");
constexpr int P_SLOTS = 2;      // split ring: the three bf16 terms of one K or V tile a slot
constexpr int BOX_BYTES = 64 * 128;  // one TMA box: [64 rows][32 float32], 128-byte swizzle
template <int HD>
struct Smem {
  static constexpr int PLANE = (HD / 64) * HALF_BYTES;  // one bf16 term of a [64][HD] tile
  static constexpr int SPLIT = 3 * PLANE;                // its three terms
  static constexpr int F_TILE = (HD / 32) * BOX_BYTES;   // a float32 [64][HD] tile
  // TMA ring: one float32 tile a slot (Q's halves, then K, V, K, ...); at hd
  // 128 one slot is what fits beside the split tiles
  static constexpr int F_SLOTS = HD > 64 ? 1 : 2;
  // each consumer's Q terms, the split ring, the TMA ring, barriers and alignment
  static constexpr int BYTES =
      CONSUMERS * SPLIT + P_SLOTS * SPLIT + F_SLOTS * F_TILE + 1024 + 1024;
  static_assert(BYTES <= 232448, "more shared memory than a block can have");
};
}  // namespace x3

// The terms (of the left operand, of the right) of cross-product p, in the
// order of repro_torch/kernels/ref.py::FLASH_PRODUCTS: hi.hi, hi.mid, mid.hi,
// hi.lo, mid.mid, lo.hi.
__host__ __device__ constexpr int left_term(int p) { return p == 2 || p == 4 ? 1 : p == 5 ? 2 : 0; }
__host__ __device__ constexpr int right_term(int p) { return p == 1 || p == 4 ? 1 : p == 3 ? 2 : 0; }

// The splitter warpgroup's share of one float32 [64][HD] tile (nbox boxes of
// 32 columns loaded; the columns of the others read as zero), times
// `scale`, split exactly into three bf16 terms in the 128-byte-swizzled
// [64 rows][64 columns] halves that wgmma's descriptors read (TMA's bf16
// layout). Unit u is 8 consecutive columns of one row: the 8 threads of a
// shared-memory phase take 8 rows of one chunk, so the swizzle spreads
// their accesses over all 32 banks.
template <int HD>
__device__ __forceinline__ void split_tile(const uint8_t* f, uint8_t* dst, int sid, int nbox,
                                           float scale) {
  constexpr int CHUNKS = HD / 8;  // 16-byte bf16 chunks a row
#pragma unroll
  for (int it = 0; it < 64 * CHUNKS / 128; ++it) {
    const int u = sid + it * 128;
    const int r = (u & 7) | ((u / (8 * CHUNKS)) << 3);  // row
    const int j = (u >> 3) % CHUNKS;                    // bf16 chunk: columns 8j .. 8j + 7
    const int box = j >> 2, c0 = 2 * (j & 3);           // float32 box and its first chunk
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
    if (box < nbox) {
      const uint8_t* row = f + box * x3::BOX_BYTES + r * 128;
      a = *reinterpret_cast<const float4*>(row + ((c0 ^ (r & 7)) << 4));
      c = *reinterpret_cast<const float4*>(row + (((c0 + 1) ^ (r & 7)) << 4));
      a = make_float4(__fmul_rn(a.x, scale), __fmul_rn(a.y, scale), __fmul_rn(a.z, scale),
                      __fmul_rn(a.w, scale));
      c = make_float4(__fmul_rn(c.x, scale), __fmul_rn(c.y, scale), __fmul_rn(c.z, scale),
                      __fmul_rn(c.w, scale));
    }
    uint4 t[3];
    split_bf16x3_x8(a, c, t);
    const int off = (j >> 3) * HALF_BYTES + r * 128 + (((j & 7) ^ (r & 7)) << 4);
#pragma unroll
    for (int tt = 0; tt < 3; ++tt)
      *reinterpret_cast<uint4*>(dst + tt * x3::Smem<HD>::PLANE + off) = t[tt];
  }
}

template <int HD>
__global__ void __launch_bounds__(x3::THREADS, 1)
flash_attention_bf16x3_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map, const Axes axes,
                              float* __restrict__ o, long long os0, long long os1,
                              long long os2, int H, int group, int Sq, int Sk, int hd,
                              int causal, int q_offset, float scale) {
  using S = x3::Smem<HD>;
  constexpr int HALVES = HD / 64, F_SLOTS = S::F_SLOTS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* qp = smem;                              // each consumer's Q terms (q scaled)
  uint8_t* pp = qp + x3::CONSUMERS * S::SPLIT;     // P_SLOTS x a K or V tile's three terms
  uint8_t* fp = pp + x3::P_SLOTS * S::SPLIT;       // F_SLOTS x a float32 tile
  uint64_t* ffull = reinterpret_cast<uint64_t*>(fp + F_SLOTS * S::F_TILE);
  uint64_t* fempty = ffull + F_SLOTS;
  uint64_t* pfull = fempty + F_SLOTS;
  uint64_t* pempty = pfull + x3::P_SLOTS;
  uint64_t* q_full = pempty + x3::P_SLOTS;    // one a consumer warpgroup
  uint64_t* turn = q_full + x3::CONSUMERS;    // a consumer's turn to issue its wgmmas

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kvh = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * x3::BQ;  // longest causal tiles first
  int n_kt = (Sk + BKV - 1) / BKV;
  if (causal) {
    const int last_key = q_offset + min(q0 + x3::BQ, Sq) - 1;  // the block's last visible key
    n_kt = min(n_kt, last_key / BKV + 1);
  }
  const int nbox = (hd + 31) / 32;  // float32 boxes that hold columns below hd

  if (tid == 0) {
    for (int s = 0; s < F_SLOTS; ++s) {
      mbar_init(&ffull[s], 1);
      mbar_init(&fempty[s], 128);  // every splitter thread
    }
    for (int s = 0; s < x3::P_SLOTS; ++s) {
      mbar_init(&pfull[s], 128);
      mbar_init(&pempty[s], 4 * x3::CONSUMERS);  // one arrival per consumer warp
    }
    for (int w = 0; w < x3::CONSUMERS; ++w) {
      mbar_init(&q_full[w], 128);
      mbar_init(&turn[w], 4);  // one arrival per warp of the other consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  if (warp >= x3::SPLITTER_WARP) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(x3::SPLIT_REGS));
    // The splitter warpgroup. Float32 unit i is consumer i's 64 rows of Q
    // (i < CONSUMERS; none loaded past Sq), then tile (i - CONSUMERS) / 2's
    // K or V: its thread 0 TMA-loads unit i + F_SLOTS once all 128 have
    // split unit i; all 128 split unit i into consumer i's Q terms or split
    // slot (i - CONSUMERS) % P_SLOTS once both consumers have freed it.
    const int sid = tid - x3::SPLITTER_WARP * 32;
    const int n_f = x3::CONSUMERS + 2 * n_kt;
    auto boxes = [&](int i) { return i < x3::CONSUMERS && q0 + 64 * i >= Sq ? 0 : nbox; };
    auto load = [&](int i) {
      const int st = i % F_SLOTS;
      uint8_t* dst = fp + st * S::F_TILE;
      const int nb = boxes(i);
      mbar_expect_tx(&ffull[st], nb * x3::BOX_BYTES);
      if (i < x3::CONSUMERS) {
        const int r0 = q0 + 64 * i;
        for (int c = 0; c < nb; ++c)
          tma_load_4d(dst + c * x3::BOX_BYTES, &q_map, &ffull[st], 32 * c,
                      pick(axes.q, 0, b, h, r0), pick(axes.q, 1, b, h, r0),
                      pick(axes.q, 2, b, h, r0));
        return;
      }
      const int u = i - x3::CONSUMERS;
      const bool is_v = u & 1;
      const CUtensorMap* map = is_v ? &v_map : &k_map;
      const int* ax = is_v ? axes.v : axes.k;
      const int k0 = u / 2 * BKV;
      for (int c = 0; c < nb; ++c)
        tma_load_4d(dst + c * x3::BOX_BYTES, map, &ffull[st], 32 * c, pick(ax, 0, b, kvh, k0),
                    pick(ax, 1, b, kvh, k0), pick(ax, 2, b, kvh, k0));
    };
    if (sid == 0)
      for (int i = 0; i < min(n_f, F_SLOTS); ++i) load(i);
    for (int i = 0; i < n_f; ++i) {
      const int fs = i % F_SLOTS;
      mbar_wait(&ffull[fs], (i / F_SLOTS) & 1);
      uint8_t* dst = qp + i * S::SPLIT;
      const int u = i - x3::CONSUMERS, ps = u % x3::P_SLOTS;
      if (u >= 0) {
        if (u >= x3::P_SLOTS) mbar_wait(&pempty[ps], (u / x3::P_SLOTS - 1) & 1);
        dst = pp + ps * S::SPLIT;
      }
      split_tile<HD>(fp + fs * S::F_TILE, dst, sid, boxes(i), u < 0 ? scale : 1.f);
      fence_proxy_async();
      mbar_arrive(&fempty[fs]);
      mbar_arrive(u < 0 ? &q_full[i] : &pfull[ps]);
      if (sid == 0 && i + F_SLOTS < n_f) {
        mbar_wait(&fempty[fs], (i / F_SLOTS) & 1);
        load(i + F_SLOTS);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(x3::CONSUMER_REGS));
  // Consumer warpgroup wg owns query rows qw0 .. qw0 + 63. Accumulator layout
  // of m64nN: d[4j + 2r + e] is row 16 w + g + 8r, column 8j + 2qd + e. acc
  // is the float32 register sum of the tiles' P V, each summed on the
  // tensor cores into a zeroed pv. The two consumers take turns to issue
  // their wgmmas (S of tile t: 0 then 1; P V of tile t: 0 then 1), so one's
  // wgmmas run while the other computes its softmax; each hands the turn on
  // once its wgmmas are issued.
  const int wg = warp / 4, w = warp % 4, g = lane / 4, qd = lane % 4;
  const int qw0 = q0 + 64 * wg;
  const uint8_t* qpw = qp + wg * S::SPLIT;
  int turns = 0;  // this consumer's waits for its turn so far
  auto take_turn = [&] {
    mbar_wait(&turn[wg], turns & 1);
    ++turns;
  };
  auto pass_turn = [&] {
    __syncwarp();
    if (lane == 0) mbar_arrive(&turn[1 - wg]);
  };
  float acc[HALVES][32];
#pragma unroll
  for (int c = 0; c < HALVES; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  // m is kept in log2 units (the logits times log2(e)), so exp(x - m) is one 2^x.
  constexpr float LOG2E = 1.4426950408889634f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  mbar_wait(&q_full[wg], 0);
  if (wg == 1) pass_turn();  // consumer 0 issues first

  for (int kt = 0; kt < n_kt; ++kt) {
    // K's terms are split unit 2 kt, V's 2 kt + 1: slots 0 and 1 of the ring.
    const int uk = 2 * kt, uv = uk + 1;
    const uint8_t* kst = pp + (uk % x3::P_SLOTS) * S::SPLIT;
    const uint8_t* vst = pp + (uv % x3::P_SLOTS) * S::SPLIT;
    mbar_wait(&pfull[uk % x3::P_SLOTS], (uk / x3::P_SLOTS) & 1);

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    take_turn();
    wgmma_fence();
#pragma unroll
    for (int p = x3::S_PRODUCTS - 1; p >= 0; --p)  // the smallest terms first
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int off = (kk / 4) * HALF_BYTES + (kk % 4) * 32;
        wgmma_ss_n64(s, desc_b128(smem_u32(qpw + left_term(p) * S::PLANE + off)),
                     desc_b128(smem_u32(kst + right_term(p) * S::PLANE + off)));
      }
    wgmma_commit();
    pass_turn();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_operand(s[i]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&pempty[uk % x3::P_SLOTS]);

    // Masked online softmax, rows r = 0 (row g) and 1 (row g + 8) of this
    // warp, as the bf16 kernel's; the logits are already scaled (through q).
    const int k0 = kt * BKV;
    const bool masked = k0 + BKV > Sk || (causal && k0 + BKV - 1 > q_offset + qw0);
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = q_offset + qw0 + 16 * w + g + 8 * r;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * j + 2 * qd + e;
          float x = s[4 * j + 2 * r + e] * LOG2E;
          if (masked && (kpos >= Sk || (causal && qpos < kpos))) x = NEG;
          s[4 * j + 2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      corr[r] = exp2_approx(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2_approx(s[4 * j + 2 * r + e] - m_new);
          s[4 * j + 2 * r + e] = p;
          rs += p;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[r] = l[r] * corr[r] + rs;
      m[r] = m_new;
    }

    // P as A fragments, each of its first P_TERMS bf16x3 terms (register a
    // of k16 step kk holds keys 16 kk + 8 (a >> 1) + 2 qd + {0, 1} of row
    // r = a & 1: accumulator pair 4 (2 kk + (a >> 1)) + 2 (a & 1)).
    uint32_t pf[x3::P_TERMS][16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = 4 * (2 * kk + (a >> 1)) + 2 * (a & 1);
        float t0[3], t1[3];
        split_bf16x3(s[i], t0[0], t0[1], t0[2]);
        split_bf16x3(s[i + 1], t1[0], t1[1], t1[2]);
#pragma unroll
        for (int t = 0; t < x3::P_TERMS; ++t) pf[t][4 * kk + a] = pack_bf16_pair(t0[t], t1[t]);
      }
    float pv[HALVES][32];
#pragma unroll
    for (int c = 0; c < HALVES; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) pv[c][i] = 0.f;
#pragma unroll
    for (int t = 0; t < x3::P_TERMS; ++t)
#pragma unroll
      for (int i = 0; i < 16; ++i) fence_operand(pf[t][i]);
    mbar_wait(&pfull[uv % x3::P_SLOTS], (uv / x3::P_SLOTS) & 1);
    take_turn();
    wgmma_fence();
#pragma unroll
    for (int p = x3::PV_PRODUCTS - 1; p >= 0; --p)  // the smallest terms first
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < HALVES; ++c)
          wgmma_rs<64, 1>(pv[c], pf[left_term(p)] + 4 * kk,
                          desc_mn128(smem_u32(vst + right_term(p) * S::PLANE + c * HALF_BYTES +
                                              kk * 16 * 128)));
    wgmma_commit();
    pass_turn();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < HALVES; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(pv[c][i]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&pempty[uv % x3::P_SLOTS]);
#pragma unroll
    for (int c = 0; c < HALVES; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * r + e;
            acc[c][i] = acc[c][i] * corr[r] + pv[c][i];
          }
  }

  // acc / max(l, 1e-30), divided as the reference divides; hd pairs written
  // as one 8-byte store where o's strides allow.
  float* ob = o + b * os0 + h * os1;
  const bool pairs = hd % 2 == 0 && os2 % 2 == 0 && reinterpret_cast<uintptr_t>(ob) % 8 == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw0 + 16 * w + g + 8 * r;
    if (row >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    float* orow = ob + row * os2;
#pragma unroll
    for (int c = 0; c < HALVES; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * c + 8 * j + 2 * qd;
        const float lo = __fdiv_rn(acc[c][4 * j + 2 * r], den);
        const float hi = __fdiv_rn(acc[c][4 * j + 2 * r + 1], den);
        if (pairs && d + 1 < hd) {
          *reinterpret_cast<float2*>(orow + d) = make_float2(lo, hi);
        } else {
          if (d < hd) orow[d] = lo;
          if (d + 1 < hd) orow[d + 1] = hi;
        }
      }
  }
}

// A 4-D map of one of q, k, v: dims (hd, then the batch, head and seq axes
// in ascending stride order), boxes of [64 rows][128 bytes] (64 bf16 or 32
// float32 values); records the order.
bool make_qkv_map(CUtensorMap* map, const void* base, int hd, const long long* sizes,
                  const long long* strides, int* axes, bool f32 = false) {
  const int esize = f32 ? 4 : 2;
  for (int i = 0; i < 3; ++i) axes[i] = i;
  for (int i = 0; i < 3; ++i)  // insertion sort of the three axes by stride
    for (int j = i; j > 0 && strides[axes[j]] < strides[axes[j - 1]]; --j) {
      const int t = axes[j];
      axes[j] = axes[j - 1];
      axes[j - 1] = t;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd)}, str[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / esize), 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = static_cast<cuuint64_t>(sizes[axes[i]]);
    str[i] = static_cast<cuuint64_t>(strides[axes[i]]) * esize;
    if (str[i] % 16 != 0 || str[i] == 0) return false;
    if (axes[i] == 2) box[i + 1] = 64;  // 64 sequence rows
  }
  return make_map_nd(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     4, base, dims, str, box);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, const long long* st, int B,
           int H, int group, int Sq, int Sk, int hd, int causal, int q_offset, float scale,
           cudaStream_t stream) {
  using S = Smem<HD>;
  auto kern = flash_attention_wgmma_kernel<HD>;
  // All of the SM's memory as shared memory, so two blocks fit on one.
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES) !=
          cudaSuccess ||
      cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared) != cudaSuccess)
    return -1;
  const long long q_sizes[3] = {B, H, Sq}, kv_sizes[3] = {B, H / group, Sk};
  CUtensorMap q_map, k_map, v_map;
  Axes axes;
  if (!make_qkv_map(&q_map, q, hd, q_sizes, st, axes.q) ||
      !make_qkv_map(&k_map, k, hd, kv_sizes, st + 3, axes.k) ||
      !make_qkv_map(&v_map, v, hd, kv_sizes, st + 6, axes.v))
    return -1;
  const dim3 grid(static_cast<unsigned>(B) * H, (Sq + BQ - 1) / BQ);
  kern<<<grid, THREADS, S::BYTES, stream>>>(q_map, k_map, v_map, axes,
                                            static_cast<__nv_bfloat16*>(o), st[9], st[10],
                                            st[11], H, group, Sq, Sk, hd, causal, q_offset,
                                            scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16x3(const void* q, const void* k, const void* v, void* o, const long long* st,
                  int B, int H, int group, int Sq, int Sk, int hd, int causal, int q_offset,
                  float scale, cudaStream_t stream) {
  using S = x3::Smem<HD>;
  auto kern = flash_attention_bf16x3_kernel<HD>;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES) !=
          cudaSuccess ||
      cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared) != cudaSuccess)
    return -1;
  const long long q_sizes[3] = {B, H, Sq}, kv_sizes[3] = {B, H / group, Sk};
  CUtensorMap q_map, k_map, v_map;
  Axes axes;
  if (!make_qkv_map(&q_map, q, hd, q_sizes, st, axes.q, true) ||
      !make_qkv_map(&k_map, k, hd, kv_sizes, st + 3, axes.k, true) ||
      !make_qkv_map(&v_map, v, hd, kv_sizes, st + 6, axes.v, true))
    return -1;
  const dim3 grid(static_cast<unsigned>(B) * H, (Sq + x3::BQ - 1) / x3::BQ);
  kern<<<grid, x3::THREADS, S::BYTES, stream>>>(q_map, k_map, v_map, axes,
                                                static_cast<float*>(o), st[9], st[10], st[11],
                                                H, group, Sq, Sk, hd, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes. q, k, v and o are bf16 device pointers,
// each 16-byte aligned; `strides` points to 12 host int64s, the (batch,
// head, seq) strides in elements of q, k, v and o, each with a unit stride
// along hd, those of q, k and v multiples of 8 elements (TMA's 16-byte
// rule). k and v have H / group heads. Launches on `stream` and returns the
// launch's cudaError_t (0 on success), or -1 for a shape or operand the
// kernel does not take (hd > 128, a non-positive size, a stride or address
// off TMA's rule, a grid past the hardware's limits, a libcuda without TMA
// encoding).
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                            void* o, int B, int H, int group, int Sq, int Sk,
                                            int hd, const long long* strides, int causal,
                                            int q_offset, float scale, void* stream) {
  if (B <= 0 || H <= 0 || group <= 0 || H % group != 0 || Sq <= 0 || Sk <= 0 || hd <= 0 ||
      hd > 128 || q_offset < 0 || (Sq + BQ - 1) / BQ > 65535 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 || reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd > 64 ? launch<128>(q, k, v, o, strides, B, H, group, Sq, Sk, hd, causal, q_offset,
                               scale, st)
                 : launch<64>(q, k, v, o, strides, B, H, group, Sq, Sk, hd, causal, q_offset,
                              scale, st);
}

// The bf16x3 route: the same arguments with float32 q, k, v and o, the
// (batch, head, seq) strides of q, k and v multiples of 4 elements.
extern "C" int flash_attention_wgmma_bf16x3_launch(const void* q, const void* k, const void* v,
                                                   void* o, int B, int H, int group, int Sq,
                                                   int Sk, int hd, const long long* strides,
                                                   int causal, int q_offset, float scale,
                                                   void* stream) {
  if (B <= 0 || H <= 0 || group <= 0 || H % group != 0 || Sq <= 0 || Sk <= 0 || hd <= 0 ||
      hd > 128 || q_offset < 0 || (Sq + BQ - 1) / BQ > 65535 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 || reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd > 64 ? launch_bf16x3<128>(q, k, v, o, strides, B, H, group, Sq, Sk, hd, causal,
                                      q_offset, scale, st)
                 : launch_bf16x3<64>(q, k, v, o, strides, B, H, group, Sq, Sk, hd, causal,
                                     q_offset, scale, st);
}

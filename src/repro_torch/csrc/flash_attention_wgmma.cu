// Flash attention for Hopper (sm_90a): bf16 q, k, v on the tensor cores
// (wgmma), operands fed by TMA.
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

// A 4-D map of one of q, k, v: dims (hd, then the batch, head and seq axes
// in ascending stride order), boxes of [64 rows][64 bf16]; records the order.
bool make_qkv_map(CUtensorMap* map, const void* base, int hd, const long long* sizes,
                  const long long* strides, int* axes) {
  for (int i = 0; i < 3; ++i) axes[i] = i;
  for (int i = 0; i < 3; ++i)  // insertion sort of the three axes by stride
    for (int j = i; j > 0 && strides[axes[j]] < strides[axes[j - 1]]; --j) {
      const int t = axes[j];
      axes[j] = axes[j - 1];
      axes[j - 1] = t;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd)}, str[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = static_cast<cuuint64_t>(sizes[axes[i]]);
    str[i] = static_cast<cuuint64_t>(strides[axes[i]]) * 2;
    if (str[i] % 16 != 0 || str[i] == 0) return false;
    if (axes[i] == 2) box[i + 1] = 64;  // 64 sequence rows
  }
  return make_map_nd(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, str, box);
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

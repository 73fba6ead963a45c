// Flash attention for Hopper (sm_90a), float32 arithmetic on CUDA cores.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel): out = softmax(q k^T / sqrt(hd) [+ causal mask]) v over
// q [B, H, Sq, hd] and k/v [B, KVH, Sk, hd], with an online softmax whose
// running max m, running sum l and accumulator are float32, masked logits set
// to -1e30 (not -inf), l clamped at 1e-30 before the final division, and the
// output written in q's dtype. q, k and v are read in their own dtype
// (float32 or bfloat16) and every product and sum is float32.
//
// Design. The TPU kernel walks a sequential (B*H, Sq/bq, Sk/bk) grid with the
// key tiles innermost and carries m, l and the accumulator in VMEM scratch
// from one key step to the next. On Hopper blocks run in parallel and nothing
// carries between them, so one block owns one (batch*head, 64-query tile) pair
// and loops over the 64-key tiles itself: the query tile (scaled by 1/sqrt(hd)
// as the TPU kernel scales it) sits transposed in shared memory for the whole
// loop; each key step stages K (transposed) and V in shared memory, every
// thread computes a 4 x 4 block of logits, the row max and row sum go round
// the 16 threads that share a row with warp shuffles, the probabilities go
// back to shared memory, and every thread adds its 4 rows x (hd/16) columns of
// p.v to float32 registers, rescaled by exp(m_old - m_new) first. m and l for
// a row live in the registers of the 16 threads that own it (each holds the
// same value). The [Sq, Sk] logits never reach device memory. A causal block
// stops at its diagonal key tile: later tiles are fully masked, so they would
// add exp(-1e30 - m) = 0 to every sum and the result is unchanged. Blocks are
// issued longest-first (the last query tiles of a causal run hold the most key
// tiles). K and V may have fewer heads than q (grouped-query attention): head
// h reads key/value head h / group, so the caller never repeats them. Every
// tensor is addressed through its (batch, head, sequence) strides with a unit
// stride along hd, so a [B, S, H, hd] activation is read in place. Rows past
// Sq and keys past Sk are masked in the kernel (a key past Sk gets the masked
// logit, a row past Sq is not written).
//
// Bound on an H100 SXM: causal prefill of qwen3-8b at b16 s128 (k and v with
// 8 of the 32 heads) moves (2*32 + 2*8) * 16*128*128*2 B = 42 MB (q, k, v read
// once, out written once; 12.5 us at 3.35 TB/s) and does 4*hd flops per
// unmasked (query, key) pair, 4*128 * 16*32*(128*129/2) = 2.2 GFLOP (2.2 us
// at the 989 TFLOP/s dense rate of its bf16 inputs): bytes-bound. This kernel
// does its arithmetic in float32 on CUDA cores, whose 67 TFLOP/s (32 us for
// that work) caps it well above the bound. bf16 inputs take the tensor-core
// kernel, flash_attention_wgmma.cu; this one keeps float32 (and takes bf16
// when called directly, as chip_smoke.py does to compare the two).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per step
constexpr int THREADS = 256;
constexpr int LD = 68;   // padded leading dim of the transposed tiles (float4-aligned)
constexpr float NEG = -1e30f;

struct Strides {
  long long q[3], k[3], v[3], o[3];  // (batch, head, seq) strides in elements
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int HD>
constexpr int smem_floats() {
  return HD * LD + HD * LD + BK * HD + BK * LD;  // Qs, Ks, Vs, Ps
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, Strides st_, int H,
                       int group, int Sq, int Sk, int hd, int causal, int q_offset,
                       float scale) {
  constexpr int NC = HD / 64;  // 64-wide column groups of the accumulator
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [HD][LD]: q tile, transposed, scaled
  float* Ks = Qs + HD * LD;       // [HD][LD]: key tile, transposed
  float* Vs = Ks + HD * LD;       // [BK][HD]
  float* Ps = Vs + BK * HD;       // [BK][LD]: probabilities, transposed

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // key columns tx*4.. (logits), value columns tx*4 + 64c.. (acc)
  const int ty = tid / 16;  // query rows ty*4 .. ty*4+3
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int n_qt = gridDim.y;
  const int q0 = (n_qt - 1 - blockIdx.y) * BQ;  // longest causal tiles first
  const T* qb = q + b * st_.q[0] + h * st_.q[1];
  const T* kb = k + b * st_.k[0] + (h / group) * st_.k[1];
  const T* vb = v + b * st_.v[0] + (h / group) * st_.v[1];
  T* ob = o + b * st_.o[0] + h * st_.o[1];

  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    const int gq = q0 + r;
    Qs[d * LD + r] = (gq < Sq && d < hd) ? ld(qb + gq * st_.q[2] + d) * scale : 0.f;
  }

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NC; ++j) acc[i][j] = 0.f;
  }

  int n_kt = (Sk + BK - 1) / BK;
  if (causal) {
    const int last_key = q_offset + min(q0 + BQ, Sq) - 1;  // the block's last visible key
    n_kt = min(n_kt, last_key / BK + 1);
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous step's readers of Ks, Vs and Ps are done
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int c = idx / HD, d = idx % HD;
      const int gk = k0 + c;
      const bool in = gk < Sk && d < hd;
      Ks[d * LD + c] = in ? ld(kb + gk * st_.k[2] + d) : 0.f;
      Vs[c * HD + d] = in ? ld(vb + gk * st_.v[2] + d) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[d * LD + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Ks[d * LD + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty * 4 + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        if (kpos >= Sk || (causal && qpos < kpos)) s[i][j] = NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        rs += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * NC; ++j) acc[i][j] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Ps[(tx * 4 + j) * LD + ty * 4]) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&Ps[kk * LD + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 w = *reinterpret_cast<const float4*>(&Vs[kk * HD + c * 64 + tx * 4]);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][c * 4 + j] = fmaf(av[i], wv[j], acc[i][c * 4 + j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = q0 + ty * 4 + i;
    if (gq >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = c * 64 + tx * 4 + j;
        if (d < hd) st(ob + gq * st_.o[2] + d, acc[i][c * 4 + j] / denom);
      }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, const Strides& s, int B,
           int H, int group, int Sq, int Sk, int hd, int causal, int q_offset, float scale,
           cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, HD>;
  const int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B) * H, (Sq + BQ - 1) / BQ);
  kern<<<grid, THREADS, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), static_cast<T*>(o), s, H,
                                         group, Sq, Sk, hd, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes. q, k, v and o are device pointers of one
// dtype (0 = float32, 1 = bfloat16); `strides` points to 12 host int64s, the
// (batch, head, seq) strides in elements of q, k, v and o, each with a unit
// stride along hd. k and v have H / group heads. Launches on `stream` and
// returns the launch's cudaError_t (0 on success), or -1 for a shape or
// dtype the kernel does not take (hd > 128, a non-positive size, a grid
// past the hardware's limits).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int dtype, int B, int H, int group, int Sq, int Sk,
                                      int hd, const long long* strides, int causal,
                                      int q_offset, float scale, void* stream) {
  if (B <= 0 || H <= 0 || group <= 0 || H % group != 0 || Sq <= 0 || Sk <= 0 || hd <= 0 ||
      hd > 128 || q_offset < 0 || (Sq + BQ - 1) / BQ > 65535)
    return -1;
  Strides s;
  for (int i = 0; i < 3; ++i) {
    s.q[i] = strides[i];
    s.k[i] = strides[3 + i];
    s.v[i] = strides[6 + i];
    s.o[i] = strides[9 + i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = hd > 64;
  if (dtype == 0)
    return wide ? launch<float, 128>(q, k, v, o, s, B, H, group, Sq, Sk, hd, causal, q_offset,
                                     scale, st)
                : launch<float, 64>(q, k, v, o, s, B, H, group, Sq, Sk, hd, causal, q_offset,
                                    scale, st);
  if (dtype == 1)
    return wide ? launch<__nv_bfloat16, 128>(q, k, v, o, s, B, H, group, Sq, Sk, hd, causal,
                                             q_offset, scale, st)
                : launch<__nv_bfloat16, 64>(q, k, v, o, s, B, H, group, Sq, Sk, hd, causal,
                                            q_offset, scale, st);
  return -1;
}

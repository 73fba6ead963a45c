// ELP_BSD shift-add decode, the split-K choice and the split-K reduction,
// shared by the float32 packed-matmul kernels (the tiled bf16 kernel takes
// only the last two; the bf16 kernels decode by a table built on the host,
// hopper.cuh).
//
// A format reaches a kernel as an ElpFormat passed by value: per digit
// the (offset, sign_bits, index_bits) field layout and the shift, either
// affine (shift = a + b * index) or from a LUT of at most 8 entries. The
// decoded value is the sum, in digit order, of at most four exact terms
// +-2^shift, each built bitwise as (shift + 127) << 23 | sign << 31 and
// reinterpreted as float: bit-identical to
// repro_torch/kernels/ref.py::decode_values_shift_add.
#pragma once

#include <cuda_runtime.h>

#define ELP_MAX_DIGITS 4
#define ELP_MAX_LUT 8
// Host-side descriptor: n_digits, then per digit
// off, sbits, ibits, affine, a, b, lut[ELP_MAX_LUT].
#define ELP_DIGIT_INTS (6 + ELP_MAX_LUT)
#define ELP_DESC_INTS (1 + ELP_MAX_DIGITS * ELP_DIGIT_INTS)

struct ElpDigit {
  int off, sbits, ibits, affine, a, b;
  int lut[ELP_MAX_LUT];
};

struct ElpFormat {
  int n_digits;
  ElpDigit d[ELP_MAX_DIGITS];
};

// Parse the host descriptor; returns false on a format the kernels cannot take.
static inline bool elp_format_from_desc(const int* desc, ElpFormat* f) {
  f->n_digits = desc[0];
  if (f->n_digits < 1 || f->n_digits > ELP_MAX_DIGITS) return false;
  for (int i = 0; i < ELP_MAX_DIGITS; ++i) {
    const int* p = desc + 1 + i * ELP_DIGIT_INTS;
    ElpDigit& d = f->d[i];
    d.off = p[0];
    d.sbits = p[1];
    d.ibits = p[2];
    d.affine = p[3];
    d.a = p[4];
    d.b = p[5];
    for (int e = 0; e < ELP_MAX_LUT; ++e) d.lut[e] = p[6 + e];
    if (i < f->n_digits && (d.ibits < 0 || d.ibits > 3 || d.sbits < 0 || d.sbits > 1 ||
                            d.off < 0 || d.off + d.sbits + d.ibits > 8))
      return false;
  }
  return true;
}

__device__ __forceinline__ float elp_decode(unsigned code, const ElpFormat& f) {
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < ELP_MAX_DIGITS; ++i) {
    if (i < f.n_digits) {
      const ElpDigit& d = f.d[i];
      const unsigned field = (code >> d.off) & ((1u << (d.sbits + d.ibits)) - 1u);
      const unsigned idx = field & ((1u << d.ibits) - 1u);
      // A select chain over the LUT with static indices, so the format
      // struct stays in the kernel's parameter space (a dynamic index
      // would copy it to local memory).
      int shift = d.lut[0];
#pragma unroll
      for (int e = 1; e < ELP_MAX_LUT; ++e)
        if (idx == static_cast<unsigned>(e)) shift = d.lut[e];
      if (d.affine) shift = d.a + d.b * static_cast<int>(idx);
      unsigned bits = static_cast<unsigned>(shift + 127) << 23;
      if (d.sbits) bits |= ((field >> d.ibits) & 1u) << 31;
      const float term = __uint_as_float(bits);
      v = (i == 0) ? term : v + term;
    }
  }
  return v;
}

// Split-K factor for a launch of `tiles` output tiles of `k_steps` K steps
// each: the fewest waves of resident blocks per unit of work,
// ceil(tiles * s / slots) / s, over s <= max_splits with at least 8 K steps
// per split (the smallest such s on a tie). `slots` is how many blocks of
// `kernel` (with `smem` bytes of dynamic shared memory) the current device
// holds at once over all its SMs. Returns -1 when the device cannot be
// queried.
template <typename Kernel>
static inline int choose_splits(Kernel kernel, int threads, long long tiles, int k_steps,
                                int max_splits, size_t smem = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) != cudaSuccess)
    return -1;
  const long long slots = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  int best = 1;
  double best_cost = static_cast<double>((tiles + slots - 1) / slots);
  for (int s = 2; s <= max_splits && k_steps >= 8 * s; ++s) {
    const double cost = static_cast<double>((tiles * s + slots - 1) / slots) / s;
    if (cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// Second pass of a split-K product: out[i] = sf * sum_s work[s][i], summed in
// split order so the result does not depend on block scheduling.
static __global__ void splitk_reduce_kernel(const float* __restrict__ work,
                                            const float* __restrict__ sf,
                                            float* __restrict__ out, size_t mn, int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float v = work[i];
  for (int s = 1; s < splits; ++s) v += work[static_cast<size_t>(s) * mn + i];
  out[i] = v * sf[0];
}

static inline int splitk_reduce(const float* work, const float* sf, float* out, size_t mn,
                                int splits, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((mn + 255) / 256);
  splitk_reduce_kernel<<<blocks, 256, 0, stream>>>(work, sf, out, mn, splits);
  return static_cast<int>(cudaGetLastError());
}

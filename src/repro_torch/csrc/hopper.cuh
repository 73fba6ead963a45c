// Hopper (sm_90a) building blocks shared by the tensor-core kernels
// (elp_bsd_matmul_wgmma.cu, fused_decode_wgmma.cu, flash_attention_wgmma.cu):
// mbarriers, TMA loads and tensor maps, wgmma shared-memory descriptors and
// instructions, the byte-table decode of ELP_BSD codes into the register A
// operand of wgmma, the digit-plane decode of formats whose values are not
// exact in bf16, and the exact split of float32 activations into three bf16
// terms that the float32 (bf16x3) routes feed to wgmma.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; libcuda's encoder is fetched at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The byte-indexed decode table of a bf16-exact format (the wgmma and bf16x3
// routes): each code byte's bf16 value, or a nibble byte's bf16 pair.
struct DecodeTable {
  static constexpr bool PLANES = false;
  uint32_t v[256];
};

// The digit planes of a format whose values are not all exact in bf16 (the
// wgmma_digits and bf16x3_digits routes): a code's value is the sum of its
// digits' terms sign_d * 2^shift_d, each an exact bf16, so x . W is the sum
// over digits of x . P_d, P_d the plane of digit d's terms. The host's words
// (repro_torch/kernels/ref.py::plane_words): the digit count n (2 or 3), then
// eight words a digit: the biased exponents 127 + shift of its shift LUT's
// (at most 8) entries as bytes (two words), its field's offset, its index
// mask in both 16-bit halves, the left shift that takes its sign bit to bit
// 15, and the sign mask 0x80008000 (0 for an unsigned digit).
constexpr int MAX_PLANES = 3;
constexpr int PLANE_WORDS = 8;
struct DigitPlanes {
  static constexpr bool PLANES = true;
  uint32_t n;
  uint32_t w[MAX_PLANES][PLANE_WORDS];
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

// Barrier `id` (1..15; 0 is __syncthreads) over the first `threads` threads.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy reads of them (wgmma operands written by threads, not TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_b128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// The same for an MN-major tile of 64 MN elements (one 128-byte swizzled
// row per K index, 8-row K groups 1024 bytes apart), read with wgmma's
// transpose bit. Both stride fields hold the 1024 bytes: a 64-wide operand
// spans one swizzle atom along MN, so only the K-group stride is used.
__device__ __forceinline__ uint64_t desc_mn128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d[64 x 16] += A[64 x 16] (bf16 pairs in registers) . B[16 x 16] (shared memory,
// descriptor desc_b; TRANS_B = 1 for an MN-major B).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %13;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(TRANS_B), "r"(1));
}

// d[64 x 64] += A[64 x 16] (bf16 pairs in registers) . B[16 x 64] (shared memory,
// descriptor desc_b; TRANS_B = 1 for an MN-major B).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(TRANS_B), "r"(1));
}

// d[64 x 96] += A[64 x 16] (bf16 pairs in registers) . B[16 x 96] (shared memory,
// descriptor desc_b; TRANS_B = 1 for an MN-major B).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %54, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, %53;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(TRANS_B), "r"(1));
}

// d[64 x 128] += A[64 x 16] (bf16 pairs in registers) . B[16 x 128] (shared memory,
// descriptor desc_b; TRANS_B = 1 for an MN-major B).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %69;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(TRANS_B), "r"(1));
}

// d[64 x 256] += A[64 x 16] (bf16 pairs in registers) . B[16 x 256] (shared memory,
// descriptor desc_b; TRANS_B = 1 for an MN-major B).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %134, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, %133;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(TRANS_B), "r"(1));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d[64 x N] += A[64 x 16] (registers) . B[16 x N] (shared memory), N = 16, 64, 96, 128 or 256.
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t desc_b) {
  static_assert(N == 16 || N == 64 || N == 96 || N == 128 || N == 256, "no wrapper for this N");
  if constexpr (N == 16) wgmma_rs_n16<TRANS_B>(d, a, desc_b);
  else if constexpr (N == 64) wgmma_rs_n64<TRANS_B>(d, a, desc_b);
  else if constexpr (N == 96) wgmma_rs_n96<TRANS_B>(d, a, desc_b);
  else if constexpr (N == 128) wgmma_rs_n128<TRANS_B>(d, a, desc_b);
  else wgmma_rs_n256<TRANS_B>(d, a, desc_b);
}

// The exact split of a float32 x into three bf16 terms, x = hi + mid + lo,
// by truncation: hi is x with its low 16 bits cleared, mid the remainder
// x - hi (exact) truncated the same way, lo what is left (exact, and exact
// in bf16: at most 8 significant bits). Each term holds 8 of x's 24
// significand bits, so its product with a bf16-exact weight is exact in
// float32. Exact for zero and every finite x above about 2^-110 in
// magnitude (below that lo is a float32 subnormal with bits past bf16's);
// unlike rounding to nearest, hi never overflows to inf near FLT_MAX.
// Twin of repro_torch/kernels/ref.py::split_bf16x3, bit for bit.
__device__ __forceinline__ void split_bf16x3(float x, float& hi, float& mid, float& lo) {
  hi = __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
  const float r = __fsub_rn(x, hi);
  mid = __uint_as_float(__float_as_uint(r) & 0xFFFF0000u);
  lo = __fsub_rn(r, mid);
}

// Two bf16-exact floats as one bf16x2 register: a in the low half, b in the high.
__device__ __forceinline__ uint32_t pack_bf16_pair(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// Eight consecutive float32 values split into three 16-byte rows of bf16
// (hi, mid, lo), element 0 in the lowest half-word of t[.].x.
__device__ __forceinline__ void split_bf16x3_x8(const float4& a, const float4& b, uint4 (&t)[3]) {
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t w[3][4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float h0, m0, l0, h1, m1, l1;
    split_bf16x3(v[2 * p], h0, m0, l0);
    split_bf16x3(v[2 * p + 1], h1, m1, l1);
    w[0][p] = pack_bf16_pair(h0, h1);
    w[1][p] = pack_bf16_pair(m0, m1);
    w[2][p] = pack_bf16_pair(l0, l1);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = make_uint4(w[i][0], w[i][1], w[i][2], w[i][3]);
}

// The A fragments of one 64-deep K stage (four k16 steps, four registers
// each) for this thread's two weight columns. Nibble: the tile is [32 byte
// rows][128 columns]; register (column, k..k+1) is the byte of byte row k/2,
// which the table maps to the bf16 pair. u8: the tile is [64 rows][128
// columns]; the pair (k, k+1) of a column is two lookups. Rows are 128-byte
// swizzled: the 16-byte chunk c of row r sits at chunk c ^ (r % 8).
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

// One digit's terms of a code pair as one bf16x2 A register: p holds the
// even K row's code in bits 0-7 and the odd row's in bits 16-23; lo and hi
// are the digit's descriptor words (LUT bytes 0-3, LUT bytes 4-7, offset,
// index mask; sign shift, sign mask, unused). The index field selects
// the biased exponent from the LUT held in two registers (prmt; the
// selector's nibbles 0 and 2 are the two indices, 1 and 3 pick byte 0,
// masked off), which goes to bits 7-14 of each half, the sign bit to bit
// 15: the bf16 bit pattern of +-2^shift, as ref.py::digit_planes builds it.
__device__ __forceinline__ uint32_t plane_term2(uint32_t p, const uint4& lo, const uint4& hi) {
  const uint32_t idx = (p >> lo.z) & lo.w;
  const uint32_t e = __byte_perm(lo.x, lo.y, idx | (idx >> 8)) & 0x00FF00FFu;
  return (e << 7) | ((p << hi.x) & hi.y);
}

// decode_stage for digit-plane formats: the A fragments of one digit's plane
// (its descriptor words w, in shared memory) over one 64-deep K stage, in
// decode_stage's layout. u8: register (column, k..k+1) pairs the code bytes
// of rows k and k + 1 (prmt 0x2420 / 0x2521 take column / column + 1 of the
// two 16-bit words, whose upper bytes are zero). Nibble: the byte of byte row
// k/2 holds both codes, the even row's in its low nibble.
template <bool NIBBLE>
__device__ __forceinline__ void decode_stage_plane(uint32_t (&f)[16], const uint8_t* ct,
                                                   const uint32_t* w, int chunk, int inoff,
                                                   int q) {
  auto at = [&](int row) {
    return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(
        ct + row * 128 + ((chunk ^ (row & 7)) << 4) + inoff));
  };
  const uint4 lo = *reinterpret_cast<const uint4*>(w);
  const uint4 hi = *reinterpret_cast<const uint4*>(w + 4);
  auto term = [&](uint32_t p) { return plane_term2(p, lo, hi); };
  auto nib = [](uint32_t b) { return (b & 0xFu) | ((b & 0xF0u) << 12); };
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (NIBBLE) {
      const uint32_t ba = at(8 * kk + q), bb = at(8 * kk + q + 4);
      f[4 * kk + 0] = term(nib(ba & 0xFFu));  // column, k..k+1
      f[4 * kk + 1] = term(nib(ba >> 8));     // column + 1, k..k+1
      f[4 * kk + 2] = term(nib(bb & 0xFFu));  // column, k+8..k+9
      f[4 * kk + 3] = term(nib(bb >> 8));     // column + 1, k+8..k+9
    } else {
      const int k = 16 * kk + 2 * q;
      const uint32_t a0 = at(k), a1 = at(k + 1), b0 = at(k + 8), b1 = at(k + 9);
      f[4 * kk + 0] = term(__byte_perm(a0, a1, 0x2420));
      f[4 * kk + 1] = term(__byte_perm(a0, a1, 0x2521));
      f[4 * kk + 2] = term(__byte_perm(b0, b1, 0x2420));
      f[4 * kk + 3] = term(__byte_perm(b0, b1, 0x2521));
    }
  }
}

// The digit planes' words into shared memory (digit d's at 8 d), once per block.
__device__ __forceinline__ void copy_planes(uint32_t* dst, const DigitPlanes& dec, int tid,
                                            int threads) {
  for (int i = tid; i < MAX_PLANES * PLANE_WORDS; i += threads)
    dst[i] = dec.w[i / PLANE_WORDS][i % PLANE_WORDS];
}

// The digit planes from the host's words; false for a digit count the kernels do not take.
inline bool planes_from_host(DigitPlanes* dec, const uint32_t* words) {
  dec->n = words[0];
  if (dec->n < 2 || dec->n > MAX_PLANES) return false;
  for (int d = 0; d < MAX_PLANES; ++d)
    for (int i = 0; i < PLANE_WORDS; ++i) dec->w[d][i] = words[1 + d * PLANE_WORDS + i];
  return true;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda through the CUDA runtime, so a
// library links only cudart.
inline EncodeTiled encode_tiled() {
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

// A tiled map of `rank` dimensions (innermost first, dims[0] contiguous;
// strides[i] is the byte stride of dimension i + 1), 128-byte swizzle,
// out-of-bounds elements read as zero.
inline bool make_map_nd(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                        const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 2-D map of rows of `row_bytes` stride.
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                     uint64_t inner, uint64_t rows, uint64_t row_bytes, uint32_t box_inner,
                     uint32_t box_rows) {
  const cuuint64_t dims[2] = {inner, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_rows};
  return make_map_nd(map, type, 2, base, dims, strides, box);
}

}  // namespace

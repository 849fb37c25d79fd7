// Hopper (sm_90a) building blocks in inline PTX: warpgroup matrix
// multiply (wgmma) with its shared-memory descriptors, mbarriers, TMA
// tensor loads and stores, named barriers, register rebalancing, a
// launcher that takes its own thread count, and the host's tensor-map
// encoders. Used by the
// bf16 paths of flash_fwd.cu (B1), flash_bwd_dkv.cu (B2),
// flash_bwd_dq.cu (B3) and, through grouped_common.cuh,
// grouped_matmul_fwd.cu (B4), grouped_matmul_dw.cu (B5) and
// grouped_matmul_fwd_quant.cu (B6).
//
// Shared-memory operand layout ("SW128"): a tile with a 128-byte inner
// extent (64 bf16) stored row after row, 128 bytes a row, with the eight
// 16-byte chunks of row r at chunk positions c ^ (r % 8). Eight rows
// form a 1024-byte atom, and atoms must start 1024-byte aligned. This is
// the layout a TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes. A wider
// inner extent (D = 128) is two such tiles one after the other ("column
// blocks").
//
// wgmma accumulator layout (m64nN, f32): thread t of the warpgroup, warp
// w = t / 32, lane l = t % 32, holds rows 16 w + l / 4 and that + 8; for
// each 8-column chunk i it holds d[4i], d[4i+1] at columns
// 8 i + 2 (l % 4) + {0, 1} of the first row and d[4i+2], d[4i+3] at the
// same columns of the second. The A operand from registers (m64k16)
// takes the same rows: a[0] columns 2 (l % 4) + {0,1} of the first row,
// a[1] of the second, a[2] and a[3] the same 8 columns on. So an f32
// accumulator over 16 columns, rounded to bf16 pairs, is an A fragment
// as it stands (acc_to_a below).

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace dlr {
namespace hop {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor of an SW128 operand at `addr` (a
// shared-window byte address). K-major (the reduction dimension is the
// contiguous one): lbo is unused (16), sbo = 1024, the stride between
// 8-row atoms; a k16 step inside the 64-element row adds 32 bytes to
// addr. MN-major (the contiguous dimension is M or N, read with the
// transpose bit): lbo = the stride between 64-element column blocks
// along M or N, sbo = 1024, the stride between 8-row atoms along K.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;  // layout type 1: 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulator
// registers across a wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// The same for A fragments in registers, which an RS wgmma reads until
// its wait: fenced after the wait, they stay live (and unchanged) until
// then.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31,\n"
      "%32, %33, %34, %35, %36, %37, %38, %39,\n"
      "%40, %41, %42, %43, %44, %45, %46, %47,\n"
      "%48, %49, %50, %51, %52, %53, %54, %55,\n"
      "%56, %57, %58, %59, %60, %61, %62, %63},\n"
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                  uint64_t desc_a,
                                                  uint64_t desc_b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31},\n"
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

// D[64 x 256] (+)= A[64 x 16] B[16 x 256], A and B from shared memory
// (128 f32 accumulators a thread). TRANS_A / TRANS_B = 1 reads that
// operand MN-major (the transpose bit).
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_ss_m64n256k16(float (&d)[128],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31,\n"
      "%32, %33, %34, %35, %36, %37, %38, %39,\n"
      "%40, %41, %42, %43, %44, %45, %46, %47,\n"
      "%48, %49, %50, %51, %52, %53, %54, %55,\n"
      "%56, %57, %58, %59, %60, %61, %62, %63,\n"
      "%64, %65, %66, %67, %68, %69, %70, %71,\n"
      "%72, %73, %74, %75, %76, %77, %78, %79,\n"
      "%80, %81, %82, %83, %84, %85, %86, %87,\n"
      "%88, %89, %90, %91, %92, %93, %94, %95,\n"
      "%96, %97, %98, %99, %100, %101, %102, %103,\n"
      "%104, %105, %106, %107, %108, %109, %110, %111,\n"
      "%112, %113, %114, %115, %116, %117, %118, %119,\n"
      "%120, %121, %122, %123, %124, %125, %126, %127},\n"
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_A),
        "n"(TRANS_B));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A from registers (four b32 of
// bf16 pairs per thread), B from shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31,\n"
      "%32, %33, %34, %35, %36, %37, %38, %39,\n"
      "%40, %41, %42, %43, %44, %45, %46, %47,\n"
      "%48, %49, %50, %51, %52, %53, %54, %55,\n"
      "%56, %57, %58, %59, %60, %61, %62, %63},\n"
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate), "n"(TRANS_B));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A from registers (four b32 of
// bf16 pairs per thread), B from shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31},\n"
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate), "n"(TRANS_B));
}

// The 16 columns [16 kk, 16 kk + 16) of an m64 f32 accumulator, rounded
// to bf16 (nearest even), as the A fragment of an m64k16 product.
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&acc)[N], int kk,
                                         uint32_t (&a)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // chunk 2kk first row, second row; chunk 2kk + 1 first, second
    const __nv_bfloat162 h =
        __floats2bfloat162_rn(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
    a[r] = *reinterpret_cast<const uint32_t*>(&h);
  }
}

// 2^x on the special-function unit (relative error ~2^-22, subnormal
// results flushed to zero); 2^-inf = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- mbarrier ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// Makes the initialised barriers visible to the other threads and to
// the async proxy (TMA); a __syncthreads must follow.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// Wait until the phase with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// -- copies -----------------------------------------------------------------

// TMA: the box at coordinates (c0 innermost, c1, c2) of a 3-D tensor map
// into shared memory at dst (a shared-window address); completion counts
// its bytes on `bar`. Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// TMA: the box at coordinate c0 of a 1-D tensor map into shared memory
// at dst; completion counts its bytes on `bar`. Elements past the end
// arrive as zeros.
__device__ __forceinline__ void tma_load_1d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

// TMA: shared memory at src (a shared-window address, laid out as a load
// of the same box would write it) into the box at (c0, c1, c2) of a 3-D
// tensor map; elements outside the tensor are not written. The copy
// joins this thread's open bulk group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// Close this thread's open bulk group.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's bulk groups still read shared
// memory (their sources may be overwritten).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Wait until all of this thread's bulk groups have completed.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Makes this thread's shared-memory writes visible to the async proxy
// (a TMA store that reads them); a barrier among the writers must
// follow before the store is issued.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- warp specialisation ----------------------------------------------------

// Named barrier `id` (1-15; 0 is __syncthreads), complete once `threads`
// threads (a multiple of 32) have reached it through bar_sync, which
// waits for it, or bar_arrive, which does not: two warpgroups take turns
// with it while the others run on.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// Reach named barrier `id` without waiting for it.
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int REGS>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// -- segment ids (packed documents) -------------------------------------------

// The flash kernels' segment-id mode stages ids in shared memory: one
// warp of the producer warpgroup reads 32 PER of them (seg_load, lane l
// src[first + PER l + e], clamped to src[last]; issued before the wait
// for the ring stage, so the load's latency hides under it) and writes
// them (seg_publish) with, for each half, whether it holds one value and
// which (flags[2 h], flags[2 h + 1]). A consumer then tells a tile whose
// ids are all one value from the rest with a few reads (seg_mode), and
// masks element by element only where ids change inside its tile.
template <int PER>
__device__ __forceinline__ void seg_load(int (&v)[PER], const int* src,
                                         int first, int last, int lane) {
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    v[e] = __ldg(src + min(first + PER * lane + e, last));
  }
}
template <int PER>
__device__ __forceinline__ void seg_publish(int* ids, int* flags, int lane,
                                            const int (&v)[PER]) {
  bool same = true;
  const int head = __shfl_sync(0xffffffffu, v[0], lane & 16);
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    ids[PER * lane + e] = v[e];
    same = same && v[e] == head;
  }
  const uint32_t votes = __ballot_sync(0xffffffffu, same);
  if ((lane & 15) == 0) {
    const int h = lane / 16;
    flags[2 * h] = ((votes >> (16 * h)) & 0xffffu) == 0xffffu;
    flags[2 * h + 1] = head;
  }
}
// True when every id of halves [h0, h0 + n) published by seg_publish
// equals one value, written to `id`.
__device__ __forceinline__ bool seg_uniform(const int* flags, int h0, int n,
                                            int& id) {
  id = flags[2 * h0 + 1];
  bool uniform = true;
#pragma unroll
  for (int h = h0; h < h0 + n; ++h) {
    uniform = uniform && flags[2 * h] && flags[2 * h + 1] == id;
  }
  return uniform;
}
// How a (q rows, keys) tile is masked by segment: kSegNone when every
// row and key share one id (only the causal and ragged masks apply),
// kSegAll when the rows share one id and the keys another (every score
// masked), kSegById otherwise (element by element).
enum SegMode { kSegNone = 0, kSegAll = 1, kSegById = 2 };
__device__ __forceinline__ int seg_mode(const int* q_flags, int q_h0,
                                        int q_n, const int* k_flags,
                                        int k_h0, int k_n) {
  int qid, kid;
  const bool q_uniform = seg_uniform(q_flags, q_h0, q_n, qid);
  const bool k_uniform = seg_uniform(k_flags, k_h0, k_n, kid);
  const int mode = !(q_uniform && k_uniform) ? kSegById
                   : qid == kid                 ? kSegNone
                                                : kSegAll;
  // one value in the warp (every thread read the same flags); the votes
  // let the compiler know, so the masks branch as warp-uniform code
  if (__all_sync(0xffffffffu, mode == kSegNone)) return kSegNone;
  return __all_sync(0xffffffffu, mode == kSegAll) ? kSegAll : kSegById;
}

// The segment-id kernels' tile lists (B1, B2, B3): the ids' tile table
// holds the [min, max] id of each 64-id tile (flash_attention.py's
// segment_tiles, q side then k side). Two tiles can hold a same-id pair
// only if their ranges meet; on sorted ids only then do they.
__device__ __forceinline__ bool seg_meets(const int* a, int lo, int hi) {
  return __ldg(a) <= hi && lo <= __ldg(a + 1);
}
// One warp writes list[n] = c * 4 + mask(c) for each candidate c in
// [first, end) with mask(c) != 0, in order (mask: bit w set when the
// candidate's ids can meet warpgroup w's); returns n in every lane.
template <typename Mask>
__device__ __forceinline__ int seg_compact(int* list, int first, int end,
                                           int lane, Mask mask) {
  int n = 0;
  for (int base = first; base < end; base += 32) {
    const int c = base + lane;
    const int m = c < end ? mask(c) : 0;
    const uint32_t votes = __ballot_sync(0xffffffffu, m != 0);
    if (m) list[n + __popc(votes & ((1u << lane) - 1))] = c * 4 + m;
    n += __popc(votes);
  }
  return n;
}

// -- host ---------------------------------------------------------------------

// Set the dynamic shared-memory limit and launch `threads` threads a
// block; returns the first CUDA error (0 when the launch was accepted).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, void* stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return (int)cudaGetLastError();
}

// The current device's count of streaming multiprocessors, the size of
// a persistent grid (one block an SM), into *n.
inline cudaError_t sm_count(int* n) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess
             ? err
             : cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
}

// cuTensorMapEncodeTiled, reached through the runtime so a library needs
// no link against libcuda; nullptr when the installed CUDA lacks it.
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
               : nullptr;
  }();
  return fn;
}

template <typename T>
struct TmaType;
template <>
struct TmaType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType value =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct TmaType<float> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

// A 3-D map over [heads, rows, cols] of T (cols innermost), box {128
// bytes of cols, rows_box, 1}, 128-byte swizzle (an SW128 column block a
// box); reads outside the tensor return zeros, so a ragged tile never
// sees the next head's rows, and columns past `cols` read as zeros.
template <typename T>
inline bool tensor_map(CUtensorMap* map, const T* ptr, int heads, int rows,
                       int cols, int rows_box) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * sizeof(T),
                                 (cuuint64_t)cols * sizeof(T) * rows};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / sizeof(T)),
                             (cuuint32_t)rows_box, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  auto encode = encode_tiled();
  return encode != nullptr &&
         encode(map, TmaType<T>::value, 3, const_cast<T*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 1-D map over n values of T, box `box` values (box * sizeof(T) a
// multiple of 16), no swizzle; a box past the end reads zeros there.
template <typename T>
inline bool tensor_map_1d(CUtensorMap* map, const T* ptr, size_t n,
                          int box) {
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {0};  // a rank-1 map has none
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t elem[1] = {1};
  auto encode = encode_tiled();
  return encode != nullptr &&
         encode(map, TmaType<T>::value, 1, const_cast<T*>(ptr), dims,
                strides, boxes, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hop
}  // namespace dlr

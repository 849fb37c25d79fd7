// B6: grouped matmul forward over a block-scaled fp8 LHS, dequantized in
// the kernel, for Hopper (sm_90a).
//
// Replaces dlrover_tpu/ops/grouped_matmul.py::_fwd_kernel_quant
// (launched by _grouped_matmul_fwd_quant):
//
//   y[i] = (values[i] * scales[i, block(j)])[j] @ w[tile_expert[i / block_t]]
//
// values [rows, D] e4m3fn, scales [rows, D / qb] f32 (one per qb channels,
// the ops/quantize.py layout), w [E, D, F] f32, y [rows, F] f32. Rows are
// sorted by expert and padded to whole tiles, as for B4.
//
// Contract: bitwise equal to dequantize_block_scaled followed by B4's f32
// path. The A-operand loader reads eight e4m3 bytes and their scales,
// converts each value to f32 (exact) and multiplies it by its block's
// scale (one f32 multiply, rounded to nearest, never contracted into an
// FMA: __fmul_rn), which is the product dequantize_block_scaled computes;
// the tile then goes through the same shared-memory layout and the same
// scalar-FMA loop (Mma<float> of grouped_common.cuh) in the same k order
// as B4 on the dequantized rows.
//
// Bound on the H100: operations, on the CUDA cores. The product is exact
// f32 (the contract above), so the peak that applies is the 67 TFLOP/s of
// f32 FMA outside the tensor cores, not TF32. At the expert-parallel main
// shape (rows = 8448, the static bound of the exchange, D = 4096,
// F = 11008, E = 2 local experts) a call is 2 rows D F = 762 GFLOP:
// 11.4 ms at that rate, against 0.9 GB of traffic (0.27 ms).
//
// Design: B4's f32 kernel with one change. B (w) streams through the
// cp.async ring as in B4; A arrives as fp8, which cp.async cannot widen,
// so each thread loads its eight bytes and scales into registers before
// the current tile's products and stores the dequantized floats into the
// ring slot of a later tile after them: the loads are in flight while the
// FMAs run. fp8 tensor cores (wgmma) are later work; they would break the
// bitwise contract with the f32 path.

#include <cuda_fp8.h>

#include "grouped_common.cuh"

namespace dlr {
namespace gm {

constexpr int kGroupRowsQ = 8;  // row tiles per launch-order group, as B4

using Cf = Cfg<float>;
using Lq = Layout<float, false, false>;

// One thread's share of an A tile: eight consecutive k of one row.
struct AChunk {
  uint2 bytes;
  float scale[8];
};

__device__ __forceinline__ void fetch_a(AChunk& a, const uint8_t* values,
                                        const float* scales, int rows, int D,
                                        int nb, int qb, int m0, int k0) {
  const int r = threadIdx.x / 2, c = (threadIdx.x % 2) * 8;
  const int gr = m0 + r, gk = k0 + c;
  if (gr < rows && gk < D) {
    a.bytes = *reinterpret_cast<const uint2*>(values + (size_t)gr * D + gk);
    const float* srow = scales + (size_t)gr * nb;
    const int b0 = gk / qb;
    if (gk + 8 <= (b0 + 1) * qb) {
      // the eight channels share one scale block (always, when qb is a
      // multiple of 8, as the 32-channel blocks of the main path are)
      const float sc = srow[b0];
#pragma unroll
      for (int j = 0; j < 8; ++j) a.scale[j] = sc;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) a.scale[j] = srow[(gk + j) / qb];
    }
  } else {
    a.bytes = make_uint2(0u, 0u);
#pragma unroll
    for (int j = 0; j < 8; ++j) a.scale[j] = 0.f;
  }
}

__device__ __forceinline__ void store_a(const AChunk& a, float* sA) {
  const int r = threadIdx.x / 2, c = (threadIdx.x % 2) * 8;
  const __nv_fp8_e4m3* v = reinterpret_cast<const __nv_fp8_e4m3*>(&a.bytes);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sA[r * Lq::LDA + c + j] = __fmul_rn(static_cast<float>(v[j]), a.scale[j]);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    grouped_fwd_quant_kernel(const uint8_t* __restrict__ values,
                             const float* __restrict__ scales,
                             const float* __restrict__ w,
                             const int* __restrict__ tile_expert,
                             float* __restrict__ y, int rows, int D, int F,
                             int E, int nb, int block_t) {
  static_assert(Cf::BM * Cf::BK == kThreads * 8,
                "one eight-byte chunk of the A tile per thread");
  extern __shared__ __align__(128) unsigned char smem[];
  const int num_m = rows / Cf::BM, num_n = (F + Cf::BN - 1) / Cf::BN;
  const int id = blockIdx.x, per_group = kGroupRowsQ * num_n;
  const int first_m = (id / per_group) * kGroupRowsQ;
  const int group_rows = min(num_m - first_m, kGroupRowsQ);
  const int m0 = (first_m + (id % per_group) % group_rows) * Cf::BM;
  const int n0 = ((id % per_group) / group_rows) * Cf::BN;
  const int qb = D / nb;

  int e = tile_expert[m0 / block_t];
  e = min(max(e, 0), E - 1);
  const float* we = w + (size_t)e * D * F;

  float* ring = reinterpret_cast<float*>(smem);
  const int nk = (D + Cf::BK - 1) / Cf::BK;
  auto slot = [&](int kt) { return ring + (kt % kStages) * Lq::STAGE_ELEMS; };
  auto load_b = [&](int kt) {
    load_tile_async<float, Cf::BK, Cf::BN>(slot(kt) + Lq::A_ELEMS, Lq::LDB,
                                           we, F, kt * Cf::BK, n0, D, F);
  };

  Mma<float, false, false> mma;
  mma.zero();
  AChunk a;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) {
      load_b(s);
      fetch_a(a, values, scales, rows, D, nb, qb, m0, s * Cf::BK);
      store_a(a, slot(s));
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt's B has landed (this thread's)
    __syncthreads();  // ... everyone's, A too, and tile kt - 1 is done
    const int next = kt + kStages - 1;
    const bool more = next < nk;
    if (more) {
      load_b(next);
      fetch_a(a, values, scales, rows, D, nb, qb, m0, next * Cf::BK);
    }
    cp_async_commit();
    const float* sA = slot(kt);
    mma.step(sA, sA + Lq::A_ELEMS);
    // slot(next) was last read in step kt - 1, before the barrier above
    if (more) store_a(a, slot(next));
  }
  cp_async_wait<0>();
  mma.store(y, F, m0, rows, n0, F, smem);
}

int launch_fwd_quant(const void* values, const void* scales, const void* w,
                     const int* tile_expert, void* y, int rows, int D, int F,
                     int E, int nb, int block_t, void* stream) {
  if (rows <= 0) return 0;
  const dim3 grid((rows / Cf::BM) * ((F + Cf::BN - 1) / Cf::BN));
  return launch(grouped_fwd_quant_kernel, grid, Lq::SMEM, stream,
                static_cast<const uint8_t*>(values),
                static_cast<const float*>(scales),
                static_cast<const float*>(w), tile_expert,
                static_cast<float*>(y), rows, D, F, E, nb, block_t);
}

}  // namespace gm
}  // namespace dlr

extern "C" int dlr_grouped_matmul_fwd_quant_f32(
    const void* values, const void* scales, const void* w,
    const int* tile_expert, void* y, int rows, int D, int F, int E, int nb,
    int block_t, void* stream) {
  return dlr::gm::launch_fwd_quant(values, scales, w, tile_expert, y, rows, D,
                                   F, E, nb, block_t, stream);
}

DLR_DEFINE_ERROR_STRING(dlr_grouped_matmul_fwd_quant_error)

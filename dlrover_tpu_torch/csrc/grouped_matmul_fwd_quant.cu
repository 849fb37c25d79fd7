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
// path. Each consumer lane reads eight e4m3 bytes at a time and their
// scale, converts each value to f32 (exact) and multiplies it by its
// block's scale (one f32 multiply, rounded to nearest, never contracted
// into an FMA: __fmul_rn), which is the product dequantize_block_scaled
// computes; the A tile then goes through the same shared-memory layout and
// the same FMA loop (ffma::persistent_gemm of grouped_common.cuh) in the
// same k order as B4 on the dequantized rows. Rows at or past live_rows
// (the expert-parallel regroup's sentinel rows) come out as zeros and
// their tiles are not computed.
//
// Bound on the H100: operations, on the CUDA cores: the 67 TFLOP/s of
// f32 FMA. A 3xTF32 split on the tensor cores (3 products at 494.7
// TFLOP/s) would bound it 2.5x lower, but the tensor cores truncate their
// f32 sums: even one k8 wgmma into a fresh accumulator reads a bias of
// -3.2e-8 to -3.8e-8 against an f64 product, 15-40 times this loop's
// (chip_stages.py tf32, PERF.md). At the expert-parallel main shape
// (rows = 8448, the static bound of the exchange, D = 4096, F = 11008,
// E = 2 local experts, live_rows 2048) a call is 2 live D F = 185 GFLOP:
// 2.8 ms at that rate (762 GFLOP, 11.4 ms, over all rows).
//
// Design: B4's f32 loop with A written by the consumers. B (w) streams
// through the TMA ring as for B4's y; A arrives as fp8 with its scales,
// which TMA cannot widen, so each consumer warp dequantizes the 16 rows
// of the A tile it reads, one stage ahead (its loads issued before the
// stage's products, its stores after), each warp on its own: the warps
// need no barrier among them, only the loop's proxy fence before each
// stage's release (grouped_common.cuh). The scale block of a channel is
// found without an integer division (about 30 instructions a division;
// they and an untaken per-channel path laid out in the loop cost 0.9 ms
// of 5.5: PERF.md), and the per-channel scale path is an instantiation
// of its own (ONE_SCALE false, qb not a multiple of 8). fp8 tensor cores
// (wgmma) would break the bitwise contract with the f32 path.

#include <cuda_fp8.h>

#include "grouped_common.cuh"

namespace dlr {
namespace gm {

constexpr int kGroupRowsQ = 8;  // row tiles per launch-order group, as B4

// y [rows, F] = dequant(values, scales) @ w[e] on ffma::persistent_gemm,
// B as B4's y (four [32 k][32 n] TMA boxes of w[e] a stage) and A
// written by the consumers: each warp dequantizes the 16 rows of the
// stage's A tile that it reads (a lane sixteen values of one row) into
// the SW128 layout TMA gives B4's x, one stage ahead, so the FMAs run on
// the same values in the same order as B4 on the dequantized rows.
// ONE_SCALE: qb is a multiple of 8, so the eight channels of a chunk
// share one scale block (the main path's 32-channel blocks); else each
// channel's scale is read, a path the main instantiation does not carry.
template <bool ONE_SCALE>
struct QuantForm {
  static constexpr bool kKMajorA = true, kKMajorB = false;
  static constexpr bool kLiveK = false, kAByTma = false;
  static constexpr uint32_t kBytes = ffma::kB;
  const CUtensorMap* tw;  // w [E, D, F], box {32, 32}
  const uint8_t* values;
  const float* scales;
  const int* tile_expert;
  float* out;
  int N, D, E, nb, qb, block_t, num_live_m, num_n, num_tiles, live;
  float inv_qb;  // 1 / qb, for block()

  // gk / qb for 0 <= gk < 2^24 without an integer division: the f32
  // quotient is within one of it, and one step either way corrects it
  __device__ int block(int gk) const {
    int b = __float2int_rz(static_cast<float>(gk) * inv_qb);
    b += (b + 1) * qb <= gk;
    b -= b * qb > gk;
    return b;
  }

  __device__ ws::Tile tile(int id) const {
    return ffma::live_first_tile(id, num_live_m, num_n, kGroupRowsQ,
                                 tile_expert, block_t, E,
                                 (D + ffma::BK - 1) / ffma::BK);
  }

  __device__ void load(uint32_t, uint32_t b, uint64_t* bar,
                       const ws::Tile& t, int k) const {
#pragma unroll
    for (int c = 0; c < ffma::BN / 32; ++c) {
      hop::tma_load_3d(b + c * 4096, tw, bar, t.n0 + 32 * c, k, t.e);
    }
  }

  // a lane's share of a stage: two chunks of eight e4m3 bytes of one row
  // and the scale of each chunk's first channel
  struct ARaw {
    uint2 bytes[2];
    float scale[2];
  };

  __device__ void fetch_a(ARaw& r, const ws::Tile& tile, int k, int row,
                          int half) const {
    const size_t m = tile.m0 + row;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gk = k + 16 * half + 8 * h;
      r.bytes[h] = make_uint2(0u, 0u);
      r.scale[h] = 0.f;
      if (gk < D) {
        r.bytes[h] = *reinterpret_cast<const uint2*>(values + m * D + gk);
        r.scale[h] = __ldg(scales + m * nb + block(gk));
      }
    }
  }

  // value = float(e4m3) * scale, one f32 multiply rounded to nearest
  // (never contracted into an FMA: __fmul_rn), which is the product
  // dequantize_block_scaled computes; zeros past D (a chunk of eight is
  // wholly inside D or past it: D % 8 == 0). Without ONE_SCALE each
  // channel's scale is read here (the chunk's first one was fetched).
  __device__ void put_a(const ARaw& r, unsigned char* sA,
                        const ws::Tile& tile, int k, int row,
                        int half) const {
    const float* srow = scales + (size_t)(tile.m0 + row) * nb;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gk = k + 16 * half + 8 * h;
      const __nv_fp8_e4m3* v =
          reinterpret_cast<const __nv_fp8_e4m3*>(&r.bytes[h]);
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float sc = r.scale[h];
        if constexpr (!ONE_SCALE) {
          if (gk < D && j > 0) sc = __ldg(srow + block(gk + j));
        }
        x[j] = gk < D ? __fmul_rn(static_cast<float>(v[j]), sc) : 0.f;
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kc = 4 * half + 2 * h + c;  // 4-channel chunk of k
        *reinterpret_cast<float4*>(sA + row * 128 +
                                   ((kc ^ (row & 7)) * 16)) =
            make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]);
      }
    }
  }
};

template <bool ONE_SCALE>
__global__ void __launch_bounds__(ffma::kThreads, 1)
    grouped_fwd_quant_f32_kernel(const __grid_constant__ CUtensorMap tw,
                                 const uint8_t* __restrict__ values,
                                 const float* __restrict__ scales,
                                 const int* __restrict__ tile_expert,
                                 const int* __restrict__ live_rows,
                                 float* __restrict__ y, int rows, int D,
                                 int F, int E, int nb, int block_t,
                                 int num_n) {
  static_assert(ffma::BM * ffma::BK == ffma::kConsumers * 16,
                "sixteen values of the A tile per consumer lane");
  const int live = ffma::live_row_count(live_rows, rows);
  const int num_m = rows / ffma::BM;
  const int qb = D / nb;
  const QuantForm<ONE_SCALE> form{&tw,
                       values,
                       scales,
                       tile_expert,
                       y,
                       F,
                       D,
                       E,
                       nb,
                       qb,
                       block_t,
                       (live + ffma::BM - 1) / ffma::BM,
                       num_n,
                       num_m * num_n,
                       live,
                       1.f / static_cast<float>(qb)};
  ffma::persistent_gemm(form);
}

int launch_fwd_quant(const void* values, const void* scales, const void* w,
                     const int* tile_expert, const int* live_rows, void* y,
                     int rows, int D, int F, int E, int nb, int block_t,
                     void* stream) {
  if (rows <= 0) return 0;
  CUtensorMap tw;
  if (!hop::tensor_map(&tw, static_cast<const float*>(w), E, D, F, 32)) {
    return (int)cudaErrorInvalidValue;
  }
  const int num_n = (F + ffma::BN - 1) / ffma::BN;
  const int tiles = (rows / ffma::BM) * num_n;
  int sms = 0;
  const cudaError_t err = hop::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles < sms ? tiles : sms);
  const auto kernel = (D / nb) % 8 == 0 ? grouped_fwd_quant_f32_kernel<true>
                                        : grouped_fwd_quant_f32_kernel<false>;
  return hop::launch(kernel, grid, ffma::kThreads, ffma::kSmem, stream, tw,
                     static_cast<const uint8_t*>(values),
                     static_cast<const float*>(scales), tile_expert,
                     live_rows, static_cast<float*>(y), rows, D, F, E, nb,
                     block_t, num_n);
}

}  // namespace gm
}  // namespace dlr

extern "C" int dlr_grouped_matmul_fwd_quant_f32(
    const void* values, const void* scales, const void* w,
    const int* tile_expert, const int* live_rows, void* y, int rows, int D,
    int F, int E, int nb, int block_t, void* stream) {
  return dlr::gm::launch_fwd_quant(values, scales, w, tile_expert, live_rows,
                                   y, rows, D, F, E, nb, block_t, stream);
}

DLR_DEFINE_ERROR_STRING(dlr_grouped_matmul_fwd_quant_error)

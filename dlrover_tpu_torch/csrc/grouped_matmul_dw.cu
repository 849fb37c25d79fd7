// B5: grouped matmul weight gradient for Hopper (sm_90a).
//
// Replaces dlrover_tpu/ops/grouped_matmul.py::_dw_kernel (launched by
// _grouped_matmul_dw): dw[e] = sum over expert e's row tiles of
// x_tile^T @ dy_tile, f32, for x [rows, D] and dy [rows, F] sorted by
// expert.
//
// Bound on the H100: operations. At the main path's shape (9216 rows,
// D = 4096, F = 11008, E = 8, bf16 in, f32 out) a call is 831 GFLOP
// against 1.72 GB (1.44 GB of it the f32 output): 0.840 ms at 989
// TFLOP/s, 0.51 ms of memory traffic.
//
// Design: the TPU kernel runs row tiles innermost on its sequential grid
// and lets each expert's first tile initialise the resident output block,
// the later ones accumulate into it. CUDA blocks run in no order, so here
// each output tile (expert e, D tile, F tile) has exactly one owner,
// which finds e's contiguous run of row tiles itself, by binary search in
// the non-decreasing tile_expert, and loops over it as the reduction
// dimension of one product. No atomics, so the result is deterministic;
// an expert that owns no tile gets zeros written (an empty reduction),
// never left as garbage.
//
// bf16 (grouped_dw_wgmma_kernel): the persistent wgmma loop of
// grouped_common.cuh over 128 (D) x 256 (F) tiles, expert by expert (one
// expert's x and dy rows, 35 MB at the main shape, stay in the 50 MB
// L2 while its tiles run), D tiles fastest. A = x^T and B = dy are both
// read MN-major (transpose bits) from 64-row TMA boxes of x and dy; a
// k step is 64 of the expert's rows, and since block_t is a multiple of
// 128 a step never straddles two experts and the loop bounds are exact
// (TMA zero-fills only outside the tensor, not past an expert's rows).
// Each tile reduces only about 18 k steps at the main shape, so the
// epilogue matters: the f32 tile (128 KB) leaves through the staged TMA
// stores of grouped_common.cuh, which drain while the producer's next
// stages land and the next tile's products run.
//
// f32 (the parity path, grouped_dw_kernel): one block an output tile,
// the cp.async + scalar-FMA loop (gemm_tile) of grouped_common.cuh.

#include "grouped_common.cuh"

namespace dlr {
namespace gm {

// First index i in [0, n) with te[i] >= v (n when there is none).
__device__ __forceinline__ int lower_bound(const int* te, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (te[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// dw[e] [D, F] = x[r0:r1]^T @ dy[r0:r1]: as a product, A = x^T is KM
// (m = d, k = row, row stride D) and B = dy is KN (row stride F).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    grouped_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const int* __restrict__ tile_expert,
                      float* __restrict__ dw, int rows, int D, int F,
                      int num_tiles, int block_t) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int e = blockIdx.z;
  const int first = lower_bound(tile_expert, num_tiles, e);
  const int last = lower_bound(tile_expert, num_tiles, e + 1);
  const int r0 = first * block_t, r1 = min(last * block_t, rows);
  gemm_tile<T, true, false, float>(
      x, D, dy, F, dw + (size_t)e * D * F, F, blockIdx.y * Cfg<T>::BM, D,
      blockIdx.x * Cfg<T>::BN, F, r0, r1, smem);
}

template <typename T>
int launch_dw(const void* x, const void* dy, const int* tile_expert,
              float* dw, int rows, int D, int F, int E, int num_tiles,
              int block_t, void* stream) {
  constexpr int BM = Cfg<T>::BM, BN = Cfg<T>::BN;
  if (E <= 0 || D <= 0 || F <= 0) return 0;
  const dim3 grid((F + BN - 1) / BN, (D + BM - 1) / BM, E);
  return launch(grouped_dw_kernel<T>, grid, Layout<T, true, false>::SMEM,
                stream, static_cast<const T*>(x), static_cast<const T*>(dy),
                tile_expert, dw, rows, D, F, num_tiles, block_t);
}

// -- bf16 --------------------------------------------------------------------

// Output tile id: expert id / (num_m num_n), then D tiles fastest.
struct DwForm {
  static constexpr int kTransA = 1, kTransB = 1;
  using Out = float;
  const CUtensorMap* tx;   // x [1, rows, D], box {64, 64}
  const CUtensorMap* tdy;  // dy [1, rows, F], box {64, 64}
  const CUtensorMap* tdw;  // dw [E, D, F], box {32, 16}
  const int* tile_expert;
  int D, F, te_len, block_t, num_m, num_n, num_tiles;

  __device__ ws::Tile tile(int id) const {
    const int per_expert = num_m * num_n;
    const int e = id / per_expert, r = id % per_expert;
    const int first = lower_bound(tile_expert, te_len, e);
    const int last = lower_bound(tile_expert, te_len, e + 1);
    return {e, (r % num_m) * ws::BM, (r / num_m) * ws::BN, first * block_t,
            max(last - first, 0) * (block_t / ws::BK)};
  }

  __device__ void load(uint32_t a, uint32_t b, uint64_t* bar,
                       const ws::Tile& t, int k) const {
#pragma unroll
    for (int c = 0; c < ws::BM / 64; ++c) {
      hop::tma_load_3d(a + c * ws::kBlock, tx, bar, t.m0 + 64 * c, k, 0);
    }
#pragma unroll
    for (int c = 0; c < ws::BN / 64; ++c) {
      hop::tma_load_3d(b + c * ws::kBlock, tdy, bar, t.n0 + 64 * c, k, 0);
    }
  }

  __device__ void store_box(uint32_t src, int col, int row,
                            const ws::Tile& t) const {
    if (col < F && row < D) hop::tma_store_3d(tdw, src, col, row, t.e);
  }
};

__global__ void __launch_bounds__(ws::kThreads, 1)
    grouped_dw_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                            const __grid_constant__ CUtensorMap tdy,
                            const __grid_constant__ CUtensorMap tdw,
                            const int* __restrict__ tile_expert, int D,
                            int F, int te_len, int block_t, int num_m,
                            int num_n, int num_tiles) {
  const DwForm form{&tx, &tdy, &tdw, tile_expert, D, F,
                    te_len, block_t, num_m, num_n, num_tiles};
  ws::persistent_gemm(form);
}

int launch_dw_bf16(const void* x, const void* dy, const int* tile_expert,
                   float* dw, int rows, int D, int F, int E, int te_len,
                   int block_t, void* stream) {
  using bf16 = __nv_bfloat16;
  if (E <= 0 || D <= 0 || F <= 0) return 0;
  // no rows: the maps stay unencoded and unread, every tile is an empty
  // reduction and writes zeros
  CUtensorMap tx{}, tdy{}, tdw;
  if ((rows > 0 &&
       (!hop::tensor_map(&tx, static_cast<const bf16*>(x), 1, rows, D, 64) ||
        !hop::tensor_map(&tdy, static_cast<const bf16*>(dy), 1, rows, F,
                         64))) ||
      !hop::tensor_map(&tdw, dw, E, D, F, 16)) {
    return (int)cudaErrorInvalidValue;
  }
  const int num_m = (D + ws::BM - 1) / ws::BM;
  const int num_n = (F + ws::BN - 1) / ws::BN;
  const int num_tiles = E * num_m * num_n;
  int sms = 0;
  const cudaError_t err = hop::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  return hop::launch(grouped_dw_wgmma_kernel,
                     dim3(num_tiles < sms ? num_tiles : sms),
                     ws::kThreads, ws::kSmem, stream, tx, tdy, tdw,
                     tile_expert, D, F, te_len, block_t, num_m, num_n,
                     num_tiles);
}

}  // namespace gm
}  // namespace dlr

extern "C" int dlr_grouped_matmul_dw_bf16(const void* x, const void* dy,
                                          const int* tile_expert, float* dw,
                                          int rows, int D, int F, int E,
                                          int num_tiles, int block_t,
                                          void* stream) {
  return dlr::gm::launch_dw_bf16(x, dy, tile_expert, dw, rows, D, F, E,
                                 num_tiles, block_t, stream);
}

extern "C" int dlr_grouped_matmul_dw_f32(const void* x, const void* dy,
                                         const int* tile_expert, float* dw,
                                         int rows, int D, int F, int E,
                                         int num_tiles, int block_t,
                                         void* stream) {
  return dlr::gm::launch_dw<float>(x, dy, tile_expert, dw, rows, D, F, E,
                                   num_tiles, block_t, stream);
}

DLR_DEFINE_ERROR_STRING(dlr_grouped_matmul_dw_error)

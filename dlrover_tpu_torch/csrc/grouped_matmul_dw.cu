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
// each output tile (expert e, D tile, F tile) has exactly one block,
// which finds e's contiguous run of row tiles itself, by binary search in
// the non-decreasing tile_expert, and loops over it as the reduction
// dimension of one product. No atomics, so the result is deterministic;
// an expert that owns no tile gets zeros written (an empty reduction),
// never left as garbage.

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

}  // namespace gm
}  // namespace dlr

extern "C" int dlr_grouped_matmul_dw_bf16(const void* x, const void* dy,
                                          const int* tile_expert, float* dw,
                                          int rows, int D, int F, int E,
                                          int num_tiles, int block_t,
                                          void* stream) {
  return dlr::gm::launch_dw<__nv_bfloat16>(x, dy, tile_expert, dw, rows, D,
                                           F, E, num_tiles, block_t, stream);
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

// B4: grouped matmul forward for Hopper (sm_90a), and its dX.
//
// Replaces dlrover_tpu/ops/grouped_matmul.py::_fwd_kernel (launched by
// _grouped_matmul_fwd): y[i] = x[i] @ w[tile_expert[i / block_t]], rows
// sorted by expert and padded to whole tiles, f32 accumulation, output in
// x's dtype. The reference's backward runs the same kernel over
// swapaxes(w, 1, 2) for dx = dy @ w[e]^T; here the transposed read is a
// flag (the "NK" layout of grouped_common.cuh), so w^T (721 MB at the
// main shape) is never materialised.
//
// Bound on the H100: operations. At the main path's shape (Tp = 9216
// rows, D = 4096, F = 11008, E = 8, bf16) a call is 2 Tp D F = 831 GFLOP
// against about 1.0 GB read and written: 0.840 ms at 989 TFLOP/s.
//
// Design: one block per 128-row tile x 128-column tile of y. The Pallas
// grid carries the tile's expert by scalar prefetch into the weight
// BlockSpec's index map; here each block reads its own tile_expert entry
// (clamped to [0, E) so a bad entry cannot read outside w). Blocks are
// ordered in groups of 8 row tiles, column tiles within a group, so the
// row tiles and weight columns in flight stay in the 50 MB L2.

#include "grouped_common.cuh"

namespace dlr {
namespace gm {

constexpr int kGroupRows = 8;  // row tiles per launch-order group

// y [rows, N] = x [rows, K] @ (TRANS ? w[e]^T : w[e]) with w [E, D, F]:
// N = F, K = D plainly; N = D, K = F transposed.
template <typename T, bool TRANS>
__global__ void __launch_bounds__(kThreads, 2)
    grouped_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const int* __restrict__ tile_expert, T* __restrict__ y,
                       int rows, int D, int F, int E, int block_t) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int BM = Cfg<T>::BM, BN = Cfg<T>::BN;
  const int N = TRANS ? D : F, K = TRANS ? F : D;
  const int num_m = rows / BM, num_n = (N + BN - 1) / BN;
  // launch order -> (row tile, column tile), kGroupRows row tiles at a time
  const int id = blockIdx.x, per_group = kGroupRows * num_n;
  const int first_m = (id / per_group) * kGroupRows;
  const int group_rows = min(num_m - first_m, kGroupRows);
  const int m_tile = first_m + (id % per_group) % group_rows;
  const int n_tile = (id % per_group) / group_rows;
  const int m0 = m_tile * BM, n0 = n_tile * BN;

  int e = tile_expert[m0 / block_t];
  e = min(max(e, 0), E - 1);
  const T* we = w + (size_t)e * D * F;
  // w[e] is [D][F]: as B it is KN (k = d, n = f) or, transposed, NK
  // (n = d, k = f); the row stride is F either way
  gemm_tile<T, false, TRANS, T>(x, K, we, F, y, N, m0, rows, n0, N, 0, K,
                                smem);
}

template <typename T>
int launch_fwd(const void* x, const void* w, const int* tile_expert, void* y,
               int rows, int D, int F, int E, int block_t, int transpose_w,
               void* stream) {
  constexpr int BM = Cfg<T>::BM, BN = Cfg<T>::BN;
  if (rows <= 0) return 0;
  const int N = transpose_w ? D : F;
  const dim3 grid((rows / BM) * ((N + BN - 1) / BN));
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  if (transpose_w) {
    return launch(grouped_fwd_kernel<T, true>, grid,
                  Layout<T, false, true>::SMEM, stream, xp, wp, tile_expert,
                  yp, rows, D, F, E, block_t);
  }
  return launch(grouped_fwd_kernel<T, false>, grid,
                Layout<T, false, false>::SMEM, stream, xp, wp, tile_expert,
                yp, rows, D, F, E, block_t);
}

}  // namespace gm
}  // namespace dlr

extern "C" int dlr_grouped_matmul_fwd_bf16(const void* x, const void* w,
                                           const int* tile_expert, void* y,
                                           int rows, int D, int F, int E,
                                           int block_t, int transpose_w,
                                           void* stream) {
  return dlr::gm::launch_fwd<__nv_bfloat16>(x, w, tile_expert, y, rows, D, F,
                                            E, block_t, transpose_w, stream);
}

extern "C" int dlr_grouped_matmul_fwd_f32(const void* x, const void* w,
                                          const int* tile_expert, void* y,
                                          int rows, int D, int F, int E,
                                          int block_t, int transpose_w,
                                          void* stream) {
  return dlr::gm::launch_fwd<float>(x, w, tile_expert, y, rows, D, F, E,
                                    block_t, transpose_w, stream);
}

DLR_DEFINE_ERROR_STRING(dlr_grouped_matmul_fwd_error)

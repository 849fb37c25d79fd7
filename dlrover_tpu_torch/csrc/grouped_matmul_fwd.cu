// B4: grouped matmul forward for Hopper (sm_90a), and its dX.
//
// Replaces dlrover_tpu/ops/grouped_matmul.py::_fwd_kernel (launched by
// _grouped_matmul_fwd): y[i] = x[i] @ w[tile_expert[i / block_t]], rows
// sorted by expert and padded to whole tiles, f32 accumulation, output in
// x's dtype. The reference's backward runs the same kernel over
// swapaxes(w, 1, 2) for dx = dy @ w[e]^T; here the transposed read is a
// flag, so w^T (721 MB at the main shape) is never materialised.
//
// Bound on the H100: operations. At the main path's shape (Tp = 9216
// rows, D = 4096, F = 11008, E = 8, bf16) a call is 2 Tp D F = 831 GFLOP
// against about 1.0 GB read and written: 0.840 ms at 989 TFLOP/s.
//
// The Pallas grid carries each row tile's expert by scalar prefetch into
// the weight BlockSpec's index map; here the owner of each output tile
// reads its own tile_expert entry (clamped to [0, E) so a bad entry
// cannot read outside w). Tiles are ordered in groups of kGroupRows row
// tiles, column tiles within a group, so the row tiles and weight
// columns in flight stay in the 50 MB L2.
//
// bf16 (grouped_fwd_wgmma_kernel): the persistent wgmma loop of
// grouped_common.cuh over 128-row x 256-column tiles of the output. A
// (x, or dy for dx) is K-major from one 64 x 128 TMA box a stage. For y
// w[e] [D][F] is B read MN-major (transpose bit), four 64 x 64 boxes a
// stage; for dx the same w[e] is B read K-major, one 64 x 256 box of its
// [D][F] rows, in place. The 3-D map over [E, D, F] reads zeros past
// expert e's D rows and F columns, so a ragged K needs no mask, and the
// TMA stores of y write nothing past a ragged N.
//
// f32 (the parity path, grouped_fwd_kernel, whose arithmetic B6 shares
// bit for bit): one block a 128 x 64 tile, the cp.async + scalar-FMA
// loop (gemm_tile) of grouped_common.cuh, reading w^T as its "NK"
// layout.

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

// -- bf16 --------------------------------------------------------------------

// y [rows, N] = x [rows, K] @ (TRANS_W ? w[e]^T : w[e]): B is MN-major
// for y (kTransB = 1), K-major for dx.
template <int TRANS_W>
struct FwdForm {
  static constexpr int kTransA = 0, kTransB = TRANS_W ? 0 : 1;
  using Out = __nv_bfloat16;
  const CUtensorMap* tx;  // x [1, rows, K], box {64, 128}
  const CUtensorMap* tw;  // w [E, D, F], box {64, 64} (y) or {64, 256} (dx)
  const CUtensorMap* ty;  // y [1, rows, N], box {64, 16}
  const int* tile_expert;
  int N, K, E, block_t, num_m, num_n, num_tiles;

  __device__ ws::Tile tile(int id) const {
    const int per_group = kGroupRows * num_n;
    const int first_m = (id / per_group) * kGroupRows;
    const int group_rows = min(num_m - first_m, kGroupRows);
    const int m0 = (first_m + (id % per_group) % group_rows) * ws::BM;
    const int n0 = ((id % per_group) / group_rows) * ws::BN;
    const int e = min(max(tile_expert[m0 / block_t], 0), E - 1);
    return {e, m0, n0, 0, (K + ws::BK - 1) / ws::BK};
  }

  __device__ void load(uint32_t a, uint32_t b, uint64_t* bar,
                       const ws::Tile& t, int k) const {
    hop::tma_load_3d(a, tx, bar, k, t.m0, 0);
    if constexpr (TRANS_W != 0) {
      hop::tma_load_3d(b, tw, bar, k, t.n0, t.e);
    } else {
#pragma unroll
      for (int c = 0; c < ws::BN / 64; ++c) {
        hop::tma_load_3d(b + c * ws::kBlock, tw, bar, t.n0 + 64 * c, k, t.e);
      }
    }
  }

  __device__ void store_box(uint32_t src, int col, int row,
                            const ws::Tile&) const {
    if (col < N) hop::tma_store_3d(ty, src, col, row, 0);  // rows are whole
  }
};

template <int TRANS_W>
__global__ void __launch_bounds__(ws::kThreads, 1)
    grouped_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                             const __grid_constant__ CUtensorMap tw,
                             const __grid_constant__ CUtensorMap ty,
                             const int* __restrict__ tile_expert, int N,
                             int K, int E, int block_t, int num_m,
                             int num_n) {
  const FwdForm<TRANS_W> form{&tx, &tw, &ty, tile_expert, N, K,
                              E, block_t, num_m, num_n, num_m * num_n};
  ws::persistent_gemm(form);
}

int launch_fwd_bf16(const void* x, const void* w, const int* tile_expert,
                    void* y, int rows, int D, int F, int E, int block_t,
                    int transpose_w, void* stream) {
  using bf16 = __nv_bfloat16;
  if (rows <= 0) return 0;
  const int N = transpose_w ? D : F, K = transpose_w ? F : D;
  CUtensorMap tx, tw, ty;
  if (!hop::tensor_map(&tx, static_cast<const bf16*>(x), 1, rows, K,
                       ws::BM) ||
      !hop::tensor_map(&tw, static_cast<const bf16*>(w), E, D, F,
                       transpose_w ? ws::BN : ws::BK) ||
      !hop::tensor_map(&ty, static_cast<const bf16*>(y), 1, rows, N, 16)) {
    return (int)cudaErrorInvalidValue;
  }
  const int num_m = rows / ws::BM, num_n = (N + ws::BN - 1) / ws::BN;
  int sms = 0;
  const cudaError_t err = hop::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(num_m * num_n < sms ? num_m * num_n : sms);
  if (transpose_w) {
    return hop::launch(grouped_fwd_wgmma_kernel<1>, grid, ws::kThreads,
                       ws::kSmem, stream, tx, tw, ty, tile_expert, N, K, E,
                       block_t, num_m, num_n);
  }
  return hop::launch(grouped_fwd_wgmma_kernel<0>, grid, ws::kThreads,
                     ws::kSmem, stream, tx, tw, ty, tile_expert, N, K, E,
                     block_t, num_m, num_n);
}

}  // namespace gm
}  // namespace dlr

extern "C" int dlr_grouped_matmul_fwd_bf16(const void* x, const void* w,
                                           const int* tile_expert, void* y,
                                           int rows, int D, int F, int E,
                                           int block_t, int transpose_w,
                                           void* stream) {
  return dlr::gm::launch_fwd_bf16(x, w, tile_expert, y, rows, D, F, E,
                                  block_t, transpose_w, stream);
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

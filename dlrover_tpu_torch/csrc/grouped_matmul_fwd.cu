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
// f32 (grouped_fwd_f32_kernel: the expert-parallel rank's products,
// whose arithmetic B6 shares bit for bit): ffma::persistent_gemm of
// grouped_common.cuh on the CUDA cores, bound by the 67 TFLOP/s of f32
// FMA (at the rank's up projection, x [8448, 4096] of which 2048 rows
// live, w [2, 4096, 11008]: 185 GFLOP, 2.8 ms). x by TMA; w[e] for y as
// four [32 k][32 n] boxes a stage (MN-major), for dx one [128 n][32 k]
// box of its [D][F] rows (K-major), in place. Each output is the same
// fmaf chain over k in order as the cp.async loop it replaced, so the
// outputs are bit for bit that loop's. Row tiles at or past live_rows
// are written as zeros without reading x or w.

#include "grouped_common.cuh"

namespace dlr {
namespace gm {

constexpr int kGroupRows = 8;  // row tiles per launch-order group

// -- f32 ---------------------------------------------------------------------

// y [rows, N] = x [rows, K] @ (TRANS_W ? w[e]^T : w[e]) on
// ffma::persistent_gemm: A (x, or dy for dx) by TMA as one 32 x 128 box
// a stage; w[e] [D][F] as four [32 k][32 n] boxes for y, one
// [128 n][32 k] box of its [D][F] rows for dx, read in place. The 3-D
// map over [E, D, F] reads zeros past expert e's D rows and F columns,
// so a ragged K needs no mask.
template <int TRANS_W>
struct FwdF32Form {
  static constexpr bool kKMajorA = true, kKMajorB = TRANS_W != 0;
  static constexpr bool kLiveK = false, kAByTma = true;
  static constexpr uint32_t kBytes = ffma::kStage;
  struct ARaw {};
  const CUtensorMap* tx;  // x [1, rows, K], box {32, 128}
  const CUtensorMap* tw;  // w [E, D, F], box {32, 32} (y) or {32, 128} (dx)
  const int* tile_expert;
  float* out;
  int N, K, E, block_t, num_live_m, num_n, num_tiles, live;

  __device__ ws::Tile tile(int id) const {
    return ffma::live_first_tile(id, num_live_m, num_n, kGroupRows,
                                tile_expert, block_t, E,
                                (K + ffma::BK - 1) / ffma::BK);
  }

  __device__ void load(uint32_t a, uint32_t b, uint64_t* bar,
                       const ws::Tile& t, int k) const {
    hop::tma_load_3d(a, tx, bar, k, t.m0, 0);
    if constexpr (TRANS_W != 0) {
      hop::tma_load_3d(b, tw, bar, k, t.n0, t.e);
    } else {
#pragma unroll
      for (int c = 0; c < ffma::BN / 32; ++c) {
        hop::tma_load_3d(b + c * 4096, tw, bar, t.n0 + 32 * c, k, t.e);
      }
    }
  }
};

template <int TRANS_W>
__global__ void __launch_bounds__(ffma::kThreads, 1)
    grouped_fwd_f32_kernel(const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap tw,
                           const int* __restrict__ tile_expert,
                           const int* __restrict__ live_rows,
                           float* __restrict__ y, int rows, int N, int K,
                           int E, int block_t, int num_n) {
  const int live = ffma::live_row_count(live_rows, rows);
  const int num_m = rows / ffma::BM;
  const FwdF32Form<TRANS_W> form{
      &tx,   &tw,     tile_expert, y, N, K, E, block_t,
      (live + ffma::BM - 1) / ffma::BM, num_n, num_m * num_n, live};
  ffma::persistent_gemm(form);
}

int launch_fwd_f32(const void* x, const void* w, const int* tile_expert,
                   const int* live_rows, void* y, int rows, int D, int F,
                   int E, int block_t, int transpose_w, void* stream) {
  if (rows <= 0) return 0;
  const int N = transpose_w ? D : F, K = transpose_w ? F : D;
  CUtensorMap tx, tw;
  if (!hop::tensor_map(&tx, static_cast<const float*>(x), 1, rows, K,
                       ffma::BM) ||
      !hop::tensor_map(&tw, static_cast<const float*>(w), E, D, F,
                       transpose_w ? ffma::BN : 32)) {
    return (int)cudaErrorInvalidValue;
  }
  const int num_n = (N + ffma::BN - 1) / ffma::BN;
  const int tiles = (rows / ffma::BM) * num_n;
  int sms = 0;
  const cudaError_t err = hop::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles < sms ? tiles : sms);
  float* yp = static_cast<float*>(y);
  if (transpose_w) {
    return hop::launch(grouped_fwd_f32_kernel<1>, grid, ffma::kThreads,
                       ffma::kSmem, stream, tx, tw, tile_expert, live_rows,
                       yp, rows, N, K, E, block_t, num_n);
  }
  return hop::launch(grouped_fwd_f32_kernel<0>, grid, ffma::kThreads,
                     ffma::kSmem, stream, tx, tw, tile_expert, live_rows, yp,
                     rows, N, K, E, block_t, num_n);
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
                                          const int* tile_expert,
                                          const int* live_rows, void* y,
                                          int rows, int D, int F, int E,
                                          int block_t, int transpose_w,
                                          void* stream) {
  return dlr::gm::launch_fwd_f32(x, w, tile_expert, live_rows, y, rows, D,
                                 F, E, block_t, transpose_w, stream);
}

DLR_DEFINE_ERROR_STRING(dlr_grouped_matmul_fwd_error)

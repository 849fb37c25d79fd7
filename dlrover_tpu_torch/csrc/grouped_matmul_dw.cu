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
// f32 (grouped_dw_f32_kernel: the expert-parallel rank's dW, its inputs
// f32): ffma::persistent_gemm of grouped_common.cuh on the CUDA cores,
// bound by the 67 TFLOP/s of f32 FMA (at the rank's up projection, x
// [8448, 4096] of which 2048 rows live, dy [8448, 11008]: 185 GFLOP, 2.8
// ms). Each 128 (D) x 128 (F) output tile of each expert has one owner,
// which reduces over the expert's rows from first * block_t to
// min(last * block_t, live_rows): the regroup's sentinel tiles, which it
// gives the last local expert, are not read. x^T and dy are both read
// MN-major, four [32 rows][32 columns] TMA boxes each a stage; each
// output is one fmaf chain over the rows in order, the arithmetic of the
// cp.async loop this replaced, so the outputs are bit for bit that
// loop's wherever the rows past live_rows are zero. Each block first
// ranks the experts by the length of their ranges in shared memory, and
// the tiles of the longest go first (a skewed layout does not end on one
// expert's tiles); within an expert the tiles run across the wider of D
// and F, so the narrower operand's columns stay in the L2 while the
// wider one's stream.

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

// -- f32 ---------------------------------------------------------------------

// An output tile of dw and its reduction: rows [k0, k_end) of x and dy,
// nk whole stages of them from k0 (the tail, fewer than a stage, when
// live_rows ends inside one, runs from global memory).
struct DwTile : ws::Tile {
  int k_end;
};

// dw[e] [D, F] = x[k0:k_end]^T dy[k0:k_end] on ffma::persistent_gemm. A =
// x^T, B = dy, both MN-major: four [32 rows][32 columns] boxes each a
// stage, zeros past D and F. span holds, in shared memory, each rank r's
// expert and row range (span[3 r], [3 r + 1], [3 r + 2]), the longest
// range first.
struct DwF32Form {
  static constexpr bool kKMajorA = false, kKMajorB = false;
  static constexpr bool kLiveK = true, kAByTma = true;
  static constexpr uint32_t kBytes = ffma::kStage;
  struct ARaw {};
  const CUtensorMap* tx;   // x [1, rows, D], box {32, 32}
  const CUtensorMap* tdy;  // dy [1, rows, F], box {32, 32}
  const float* x;
  const float* dy;
  const int* span;
  float* out;
  int M, N, num_m, num_n, num_tiles;

  __device__ DwTile tile(int id) const {
    const int per_expert = num_m * num_n;
    const int r = id / per_expert, t = id % per_expert;
    // across the wider of D and F: the narrower operand's columns are
    // read again by every tile in flight, from the L2
    const bool m_fast = M <= N;
    const int m_tile = m_fast ? t % num_m : t / num_n;
    const int n_tile = m_fast ? t / num_m : t % num_n;
    const int k0 = span[3 * r + 1], k_end = span[3 * r + 2];
    DwTile tile;
    tile.e = span[3 * r];
    tile.m0 = m_tile * ffma::BM;
    tile.n0 = n_tile * ffma::BN;
    tile.k0 = k0;
    tile.nk = (k_end - k0) / ffma::BK;
    tile.k_end = k_end;
    return tile;
  }

  __device__ void load(uint32_t a, uint32_t b, uint64_t* bar,
                       const DwTile& t, int k) const {
#pragma unroll
    for (int c = 0; c < ffma::BM / 32; ++c) {
      hop::tma_load_3d(a + c * 4096, tx, bar, t.m0 + 32 * c, k, 0);
    }
#pragma unroll
    for (int c = 0; c < ffma::BN / 32; ++c) {
      hop::tma_load_3d(b + c * 4096, tdy, bar, t.n0 + 32 * c, k, 0);
    }
  }

  // the rows past the last whole stage, from global memory: the same
  // fmaf chains, on in row order (rows 4 ty + 64 h + [0, 4) and columns
  // 4 tx + 64 h + [0, 4), as stage_fma; zeros past D and F)
  __device__ void tail(float (&acc)[8][8], const DwTile& t, int ty,
                       int tx) const {
    for (int k = t.k0 + t.nk * ffma::BK; k < t.k_end; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = t.m0 + 4 * ty + 64 * h, n = t.n0 + 4 * tx + 64 * h;
        const float4 va =
            m < M ? *reinterpret_cast<const float4*>(x + (size_t)k * M + m)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 vb =
            n < N ? *reinterpret_cast<const float4*>(dy + (size_t)k * N + n)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
        a[4 * h] = va.x;
        a[4 * h + 1] = va.y;
        a[4 * h + 2] = va.z;
        a[4 * h + 3] = va.w;
        b[4 * h] = vb.x;
        b[4 * h + 1] = vb.y;
        b[4 * h + 2] = vb.z;
        b[4 * h + 3] = vb.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
};

// Shared memory past ffma::kSmem: 5 ints an expert (its range, then the
// ranked table DwF32Form reads).
__global__ void __launch_bounds__(ffma::kThreads, 1)
    grouped_dw_f32_kernel(const __grid_constant__ CUtensorMap tx,
                          const __grid_constant__ CUtensorMap tdy,
                          const float* __restrict__ x,
                          const float* __restrict__ dy,
                          const int* __restrict__ tile_expert,
                          const int* __restrict__ live_rows,
                          float* __restrict__ dw, int rows, int D, int F,
                          int E, int te_len, int block_t, int num_m,
                          int num_n) {
  extern __shared__ unsigned char smem_raw[];
  int* const range = reinterpret_cast<int*>(smem_raw + ffma::kSmem);
  int* const span = range + 2 * E;
  const int live = ffma::live_row_count(live_rows, rows);
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int k0 = lower_bound(tile_expert, te_len, e) * block_t;
    const int end = lower_bound(tile_expert, te_len, e + 1) * block_t;
    range[2 * e] = k0;
    range[2 * e + 1] = max(min(end, live), k0);
  }
  __syncthreads();
  // rank: longer ranges first, then the lower expert
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int len = range[2 * e + 1] - range[2 * e];
    int r = 0;
    for (int o = 0; o < E; ++o) {
      const int l = range[2 * o + 1] - range[2 * o];
      r += l > len || (l == len && o < e);
    }
    span[3 * r] = e;
    span[3 * r + 1] = range[2 * e];
    span[3 * r + 2] = range[2 * e + 1];
  }
  // persistent_gemm's __syncthreads (after its barriers' init) publishes
  // the table
  const DwF32Form form{&tx, &tdy, x, dy, span, dw, D, F, num_m, num_n,
                       E * num_m * num_n};
  ffma::persistent_gemm(form);
}

int launch_dw_f32(const void* x, const void* dy, const int* tile_expert,
                  const int* live_rows, float* dw, int rows, int D, int F,
                  int E, int te_len, int block_t, void* stream) {
  if (E <= 0 || D <= 0 || F <= 0) return 0;
  // no rows: the maps stay unencoded and unread, every tile is an empty
  // reduction and writes zeros
  CUtensorMap tx{}, tdy{};
  if (rows > 0 &&
      (!hop::tensor_map(&tx, static_cast<const float*>(x), 1, rows, D, 32) ||
       !hop::tensor_map(&tdy, static_cast<const float*>(dy), 1, rows, F,
                        32))) {
    return (int)cudaErrorInvalidValue;
  }
  const int num_m = (D + ffma::BM - 1) / ffma::BM;
  const int num_n = (F + ffma::BN - 1) / ffma::BN;
  const int tiles = E * num_m * num_n;
  int sms = 0;
  const cudaError_t err = hop::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  return hop::launch(grouped_dw_f32_kernel, dim3(tiles < sms ? tiles : sms),
                     ffma::kThreads, ffma::kSmem + 5 * sizeof(int) * E,
                     stream, tx, tdy, static_cast<const float*>(x),
                     static_cast<const float*>(dy), tile_expert, live_rows,
                     dw, rows, D, F, E, te_len, block_t, num_m, num_n);
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
                                         const int* tile_expert,
                                         const int* live_rows, float* dw,
                                         int rows, int D, int F, int E,
                                         int num_tiles, int block_t,
                                         void* stream) {
  return dlr::gm::launch_dw_f32(x, dy, tile_expert, live_rows, dw, rows, D,
                                F, E, num_tiles, block_t, stream);
}

DLR_DEFINE_ERROR_STRING(dlr_grouped_matmul_dw_error)

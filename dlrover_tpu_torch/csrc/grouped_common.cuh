// The tiled matrix product shared by the grouped-matmul kernels
// (grouped_matmul_fwd.cu, grouped_matmul_dw.cu).
//
// One block computes one BM x BN tile of C = op(A) op(B) over a range
// [k_begin, k_end) of the reduction dimension:
//
//   A is "MK" (A[m * lda + k]) or "KM" (A[k * lda + m], i.e. A^T stored),
//   B is "KN" (B[k * ldb + n]) or "NK" (B[n * ldb + k], i.e. B^T stored),
//
// so a transposed operand is read in place and never materialised. Tiles
// of A and B stream through a ring of kStages shared-memory buffers with
// cp.async (16-byte copies, zero-filled past the edges of M, N and K), so
// the next tiles load while the current one is multiplied.
//
// bf16: 128x128x64 tiles, eight warps each holding a 64x32 block of f32
// accumulators in registers as WMMA 16x16x16 fragments for the whole
// K loop; the result goes through shared memory once, to be written with
// masked, coalesced stores. The tile shape changes no bit of the
// result: every shape sums K in the same k16 order (PERF.md, PR 2, has
// the times before and after the move from 128x128x32 with 4 stages).
//
// f32 (the parity path): 128x64x16 tiles, each thread an 8x4 block of
// scalar FMA accumulators in registers.
//
// Every operand's contiguous dimension must be a multiple of 8 elements
// and its base 16-byte aligned (the wrapper checks), so a 16-byte chunk
// is either wholly inside or wholly outside the matrix.

#pragma once

#include <mma.h>

#include <type_traits>

#include "flash_common.cuh"

namespace dlr {
namespace gm {

constexpr int kStages = 3;

template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int BM = 128, BN = 128, BK = 64, PAD = 8;
};
template <>
struct Cfg<float> {
  static constexpr int BM = 128, BN = 64, BK = 16, PAD = 4;
};

// Shared-memory layout of one pipeline stage: the A tile, then the B
// tile, each stored with its global layout's contiguous dimension
// innermost (plus PAD elements against bank conflicts).
template <typename T, bool A_KM, bool B_NK>
struct Layout {
  using C = Cfg<T>;
  static constexpr int A_ROWS = A_KM ? C::BK : C::BM;
  static constexpr int A_COLS = A_KM ? C::BM : C::BK;
  static constexpr int B_ROWS = B_NK ? C::BN : C::BK;
  static constexpr int B_COLS = B_NK ? C::BK : C::BN;
  static constexpr int LDA = A_COLS + C::PAD;
  static constexpr int LDB = B_COLS + C::PAD;
  static constexpr int A_ELEMS = A_ROWS * LDA;
  static constexpr int STAGE_ELEMS = A_ELEMS + B_ROWS * LDB;
  static constexpr int LDC = C::BN + 4;  // f32 staging of the bf16 result
  static constexpr size_t PIPE_BYTES =
      (size_t)kStages * STAGE_ELEMS * sizeof(T);
  static constexpr size_t C_BYTES = (size_t)C::BM * LDC * sizeof(float);
  static constexpr size_t SMEM =
      PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying an R x C tile (contiguous along C in global and shared
// memory) whose top-left element is (r0, c0) of a matrix with row stride
// ld; rows >= r_lim and columns >= c_lim arrive as zeros.
template <typename T, int R, int C>
__device__ __forceinline__ void load_tile_async(T* dst, int ldd, const T* src,
                                                int ld, int r0, int c0,
                                                int r_lim, int c_lim) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CHUNKS = C / V;
  static_assert(C % V == 0, "tile width must be whole 16-byte chunks");
  for (int idx = threadIdx.x; idx < R * CHUNKS; idx += kThreads) {
    const int r = idx / CHUNKS, c = (idx % CHUNKS) * V;
    const int gr = r0 + r, gc = c0 + c;
    const bool ok = gr < r_lim && gc < c_lim;
    cp_async16(dst + r * ldd + c, ok ? src + (size_t)gr * ld + gc : src,
               ok ? 16 : 0);
  }
}

template <typename T, bool A_KM, bool B_NK>
struct Mma;

// bf16: warp w owns rows (w / 4) * 64 .. +64 and columns (w % 4) * 32 ..
// +32 of the tile, as 4 x 2 WMMA accumulator fragments.
template <bool A_KM, bool B_NK>
struct Mma<__nv_bfloat16, A_KM, B_NK> {
  using T = __nv_bfloat16;
  using L = Layout<T, A_KM, B_NK>;
  using LA = std::conditional_t<A_KM, nvcuda::wmma::col_major,
                                nvcuda::wmma::row_major>;
  using LB = std::conditional_t<B_NK, nvcuda::wmma::col_major,
                                nvcuda::wmma::row_major>;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      acc[4][2];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);
  }

  __device__ void step(const T* sA, const T* sB) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
    const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
#pragma unroll
    for (int kk = 0; kk < Cfg<T>::BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = wm + i * 16;
        wmma::load_matrix_sync(
            a[i], A_KM ? sA + kk * L::LDA + m : sA + m * L::LDA + kk, L::LDA);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn + j * 16;
        wmma::load_matrix_sync(
            b[j], B_NK ? sB + n * L::LDB + kk : sB + kk * L::LDB + n, L::LDB);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

  // Through shared memory (free once the pipeline has drained) to
  // masked, coalesced stores.
  template <typename Out>
  __device__ void store(Out* out, int ldc, int m0, int M, int n0, int N,
                        unsigned char* smem) {
    using namespace nvcuda;
    constexpr int BM = Cfg<T>::BM, BN = Cfg<T>::BN;
    float* sC = reinterpret_cast<float*>(smem);
    const int warp = threadIdx.x / 32;
    const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(sC + (wm + i * 16) * L::LDC + wn + j * 16,
                                acc[i][j], L::LDC, wmma::mem_row_major);
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * BN; idx += kThreads) {
      const int r = idx / BN, c = idx % BN;
      if (m0 + r < M && n0 + c < N) {
        out[(size_t)(m0 + r) * ldc + n0 + c] = from_f<Out>(sC[r * L::LDC + c]);
      }
    }
  }
};

// f32: thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i (i < 8) and
// columns tx + 16 j (j < 4) of the tile.
template <bool A_KM, bool B_NK>
struct Mma<float, A_KM, B_NK> {
  using L = Layout<float, A_KM, B_NK>;
  float acc[8][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  __device__ void step(const float* sA, const float* sB) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
    for (int k = 0; k < Cfg<float>::BK; ++k) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = ty + 16 * i;
        a[i] = A_KM ? sA[k * L::LDA + m] : sA[m * L::LDA + k];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 16 * j;
        b[j] = B_NK ? sB[n * L::LDB + k] : sB[k * L::LDB + n];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  template <typename Out>
  __device__ void store(Out* out, int ldc, int m0, int M, int n0, int N,
                        unsigned char*) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        if (m < M && n < N) out[(size_t)m * ldc + n] = from_f<Out>(acc[i][j]);
      }
    }
  }
};

// C[m0:m0+BM, n0:n0+BN] = sum over k in [k_begin, k_end) of
// op(A)[m, k] op(B)[k, n], written to out (row stride ldc) where m < M
// and n < N. An empty k range writes zeros.
template <typename T, bool A_KM, bool B_NK, typename Out>
__device__ void gemm_tile(const T* __restrict__ A, int lda,
                          const T* __restrict__ B, int ldb, Out* out,
                          int ldc, int m0, int M, int n0, int N, int k_begin,
                          int k_end, unsigned char* smem) {
  using C = Cfg<T>;
  using L = Layout<T, A_KM, B_NK>;
  T* ring = reinterpret_cast<T*>(smem);
  const int nk = k_end > k_begin ? (k_end - k_begin + C::BK - 1) / C::BK : 0;

  auto load = [&](int kt) {
    T* sA = ring + (kt % kStages) * L::STAGE_ELEMS;
    T* sB = sA + L::A_ELEMS;
    const int k = k_begin + kt * C::BK;
    if constexpr (A_KM) {
      load_tile_async<T, C::BK, C::BM>(sA, L::LDA, A, lda, k, m0, k_end, M);
    } else {
      load_tile_async<T, C::BM, C::BK>(sA, L::LDA, A, lda, m0, k, M, k_end);
    }
    if constexpr (B_NK) {
      load_tile_async<T, C::BN, C::BK>(sB, L::LDB, B, ldb, n0, k, N, k_end);
    } else {
      load_tile_async<T, C::BK, C::BN>(sB, L::LDB, B, ldb, k, n0, k_end, N);
    }
  };

  Mma<T, A_KM, B_NK> mma;
  mma.zero();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed (this thread's part)
    __syncthreads();  // ... everyone's, and tile kt - 1 is no longer read
    if (kt + kStages - 1 < nk) load(kt + kStages - 1);
    cp_async_commit();
    const T* sA = ring + (kt % kStages) * L::STAGE_ELEMS;
    mma.step(sA, sA + L::A_ELEMS);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the epilogue's staging
  mma.store(out, ldc, m0, M, n0, N, smem);
}

}  // namespace gm
}  // namespace dlr

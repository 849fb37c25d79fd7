// The tiled matrix products shared by the grouped-matmul kernels
// (grouped_matmul_fwd.cu, grouped_matmul_dw.cu, and the f32 loop of
// grouped_matmul_fwd_quant.cu).
//
// Each computes tiles of C = op(A) op(B) over a range of the reduction
// dimension k, with every operand read in place (a transposed one is
// never materialised). The three forms, and what each needs:
//
//   B4 y   = x w[e]      A = x  [M rows][K]     K-major
//                        B = w[e] [K = D][N = F] MN-major (N contiguous)
//   B4 dx  = dy w[e]^T   A = dy [M rows][K]     K-major
//                        B = w[e] read as [N = D][K = F], K-major
//   B5 dw[e] = x^T dy    A = x^T: x [K rows][M = D], MN-major
//                        B = dy [K rows][N = F]  MN-major
//
// bf16 (ws::persistent_gemm, on hopper_common.cuh): a persistent grid,
// one block an SM, each walking output tiles of BM x BN = 128 x 256 in
// the order the kernel's Form gives. A producer warp keeps TMA loads of
// the A and B tiles (64 deep in k) in flight through a kStages-deep
// mbarrier ring of 128-byte-swizzled shared memory, running on into the
// next tile while the consumers finish this one; two consumer
// warpgroups own 64 rows x 256 columns each and accumulate in registers
// (wgmma SS m64n256k16, the operands' majorness a transpose bit, one
// product group kept in flight). The epilogue stages each warp's rows
// through two swizzled 2 KB boxes of shared memory and writes them with
// TMA stores, which drain under the next tile's loads and products
// (stores straight from the accumulators, 8 rows of 16 or 32 bytes an
// instruction, left B5 0.1-0.2 ms and B4 up to 0.13 ms slower:
// PERF.md). TMA reads
// zeros outside each tensor and writes nothing outside it, so a ragged
// M, N or K edge needs no mask.
//
// f32 (the parity path, gemm_tile): one block a 128x64 tile, a ring of
// kStages shared-memory buffers fed by cp.async (16-byte copies,
// zero-filled past the edges of M, N and K), each thread an 8x4 block of
// scalar FMA accumulators in registers. A is "MK" (A[m * lda + k]) or
// "KM" (A[k * lda + m]), B "KN" (B[k * ldb + n]) or "NK" (B[n * ldb + k]).
//
// Every operand's contiguous dimension must be a multiple of 8 elements
// and its base 16-byte aligned (the wrapper checks): a 16-byte chunk is
// either wholly inside or wholly outside the matrix, and the TMA maps'
// strides are whole 16 bytes.

#pragma once

#include <type_traits>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace dlr {
namespace gm {

constexpr int kStages = 3;

template <typename T>
struct Cfg;
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
  static constexpr size_t SMEM = (size_t)kStages * STAGE_ELEMS * sizeof(T);
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

// -- bf16: wgmma from TMA-fed shared memory ---------------------------------

namespace ws {

constexpr int BM = 128;  // output rows of a tile: two consumer warpgroups
constexpr int BN = 256;  // output columns of a tile
constexpr int BK = 64;   // k of a ring stage: one 128-byte swizzled row
constexpr int kStages = 4;
constexpr int kConsumers = 256;  // threads of the two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kAcc = BN / 2;  // f32 accumulators a consumer thread
constexpr uint32_t kBlock = 64 * 128;  // an SW128 block of 64 rows
constexpr uint32_t kA = BM * BK * 2;   // a stage's A tile (16 KB)
constexpr uint32_t kStage = kA + BN * BK * 2;  // and its B tile (32 KB)
// Epilogue staging: kBoxes SW128 boxes of 16 rows x 128 bytes per
// consumer warp, written from the accumulators and stored by TMA in
// turns.
constexpr int kBoxes = 2;
constexpr uint32_t kBox = 16 * 128;
constexpr uint32_t kStaging = kStages * kStage;
constexpr uint32_t kBars = kStaging + (kConsumers / 32) * kBoxes * kBox;
constexpr size_t kSmem = kBars + 128 + 1024;  // + mbarriers, align slack

// The mbarriers: a stage's tiles arrived; a stage released by the eight
// consumer warps.
struct Bars {
  uint64_t full[kStages], empty[kStages];
};

// An output tile: rows [m0, m0 + BM) and columns [n0, n0 + BN) of expert
// e's product, reduced over k in [k0, k0 + nk BK).
struct Tile {
  int e, m0, n0, k0, nk;
};

// The descriptor of k16 step kk of a stage's operand tile at addr (a
// warpgroup's 64 rows of A, or all of B). K-major: rows of 128 bytes of
// k, a step is 32 bytes along them. MN-major: rows of k, 64 elements of
// M or N each, in blocks of 64 rows kBlock apart along M or N; a step is
// 16 rows.
template <int MN_MAJOR>
__device__ __forceinline__ uint64_t operand_desc(uint32_t addr, int kk) {
  return MN_MAJOR ? hop::desc_sw128(addr + kk * 16 * 128, kBlock, 1024)
                  : hop::desc_sw128(addr + kk * 32, 16, 1024);
}

// Store one consumer warp's 16 rows of the tile (rows row0 + [0, 16),
// columns n0 + [0, BN)) through its kBoxes staging boxes at stage (a
// generic pointer; stage_s its shared-window address): each 128-byte
// column slice of the rows is written in the SW128 layout, then handed
// to a TMA store (form.store_box) that drains while the warp goes on.
// slice counts the warp's slices across tiles: slice s uses box
// s % kBoxes. Form::Out is the output type (f32 or bf16).
template <class Form>
__device__ __forceinline__ void store_rows(const Form& form,
                                           const float (&acc)[kAcc],
                                           const Tile& tile, int row0,
                                           unsigned char* stage,
                                           uint32_t stage_s, int lane,
                                           int& slice) {
  using Out = typename Form::Out;
  constexpr int kPerBox = 128 / sizeof(Out);  // columns a box row holds
  constexpr int kGroups = kPerBox / 8;  // accumulator 8-column groups
  const int q = lane % 4, r0 = lane / 4;
#pragma unroll
  for (int j = 0; j < BN / kPerBox; ++j, ++slice) {
    const uint32_t at = (slice % kBoxes) * kBox;
    unsigned char* box = stage + at;
    // the store that read this box kBoxes slices ago is done with it
    if (lane == 0) hop::bulk_wait_read<kBoxes - 1>();
    __syncwarp();
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int c = j * kGroups + g;  // 8-column group of the tile
      const uint32_t byte = (8 * g + 2 * q) * sizeof(Out);
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows r0 and r0 + 8
        const int r = r0 + 8 * h;
        unsigned char* p =
            box + r * 128 + (((byte / 16) ^ (r % 8)) * 16) + byte % 16;
        if constexpr (std::is_same_v<Out, float>) {
          *reinterpret_cast<float2*>(p) =
              make_float2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(p) =
              __floats2bfloat162_rn(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
        }
      }
    }
    hop::fence_async_shared();
    __syncwarp();
    if (lane == 0) {
      form.store_box(stage_s + at, tile.n0 + j * kPerBox, row0, tile);
      hop::bulk_commit();
    }
  }
}

// The persistent, warp-specialised main loop. Form gives kTransA and
// kTransB (1: that operand MN-major), Out, num_tiles, tile(id) (the same
// answer to the producer and the consumers), load(a, b, bar, tile, k)
// (the TMA loads of the stage at k into a and b, completing on bar:
// kStage bytes, zeros outside the tensors included) and store_box(src,
// col, row, tile) (a TMA store of the 16-row SW128 box at src to output
// (row, col) of the tile's expert, skipping a box wholly outside the
// output). Launch with kThreads threads and kSmem bytes.
template <class Form>
__device__ __forceinline__ void persistent_gemm(const Form& form) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = hop::smem_u32(base);
  Bars& bar = *reinterpret_cast<Bars*>(base + kBars);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&bar.full[s], 1);
      hop::mbar_init(&bar.empty[s], kConsumers / 32);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: one thread walks the block's tiles and their k steps,
    // a stage at a time as the consumers release them
    hop::regs_dealloc<24>();
    if (threadIdx.x == kConsumers) {
      int it = 0;  // k steps loaded so far, across tiles
      for (int id = blockIdx.x; id < form.num_tiles; id += gridDim.x) {
        const Tile tile = form.tile(id);
        for (int kt = 0; kt < tile.nk; ++kt, ++it) {
          const int s = it % kStages;
          if (it >= kStages) {
            hop::mbar_wait(&bar.empty[s], (it / kStages - 1) & 1);
          }
          hop::mbar_arrive_expect_tx(&bar.full[s], kStage);
          const uint32_t a = ring + s * kStage;
          form.load(a, a + kA, &bar.full[s], tile, tile.k0 + kt * BK);
        }
      }
    }
    return;
  }
  hop::regs_alloc<240>();

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile,
  // which is A's SW128 block wg in either majorness
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  unsigned char* stage = base + kStaging + warp * kBoxes * kBox;
  const uint32_t stage_s = ring + kStaging + warp * kBoxes * kBox;
  int it = 0;     // k steps consumed so far, across tiles
  int slice = 0;  // staged output slices so far, across tiles
  Tile tile = form.tile(blockIdx.x);  // the grid has no more blocks than tiles
  for (int id = blockIdx.x; id < form.num_tiles; id += gridDim.x) {
    float acc[kAcc];
#pragma unroll
    for (int x = 0; x < kAcc; ++x) acc[x] = 0.f;  // an empty k range: zeros
    for (int kt = 0; kt < tile.nk; ++kt, ++it) {
      const int s = it % kStages;
      hop::mbar_wait(&bar.full[s], (it / kStages) & 1);
      const uint32_t a = ring + s * kStage + wg * kBlock;
      const uint32_t b = ring + s * kStage + kA;
      hop::wgmma_fence();
      hop::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        hop::wgmma_ss_m64n256k16<Form::kTransB, Form::kTransA>(
            acc, operand_desc<Form::kTransA>(a, kk),
            operand_desc<Form::kTransB>(b, kk), 1);
      }
      hop::wgmma_commit();
      // this step's products stay in flight; the step before is done
      // with its stage
      hop::wgmma_wait<1>();
      hop::fence_regs(acc);
      if (kt > 0 && lane == 0) {
        hop::mbar_arrive(&bar.empty[(it + kStages - 1) % kStages]);
      }
    }
    // the next tile's decode (global reads) runs under the last products
    const int next_id = id + gridDim.x;
    const Tile next = next_id < form.num_tiles ? form.tile(next_id) : tile;
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    if (tile.nk > 0 && lane == 0) {
      hop::mbar_arrive(&bar.empty[(it + kStages - 1) % kStages]);
    }
    store_rows(form, acc, tile, tile.m0 + 16 * warp, stage, stage_s, lane,
               slice);
    tile = next;
  }
  if (lane == 0) hop::bulk_wait_all();  // the last stores have landed
}

}  // namespace ws

}  // namespace gm
}  // namespace dlr

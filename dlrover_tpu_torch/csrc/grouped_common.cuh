// The tiled matrix products shared by the grouped-matmul kernels
// (grouped_matmul_fwd.cu, grouped_matmul_dw.cu and
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
// f32 B4, B5 and B6 (ffma::persistent_gemm; the expert-parallel rank's
// products): on the CUDA cores, bound by the 67 TFLOP/s of f32 FMA. The
// tensor cores' 3xTF32 split would bound it lower, but they truncate
// their f32 sums (a bias 15-40 times this loop's: chip_stages.py tf32).
// A persistent grid, one producer thread keeping TMA loads of 128 x 32 A
// and B tiles (SW128) in a 4-stage mbarrier ring; 256 consumer threads,
// setmaxnreg 240, each an 8 x 8 block of a 128 x 128 output tile, four k
// at a time from 16-byte shared reads; each output one fmaf chain over k
// in order (the arithmetic of the cp.async loop it replaced, bit for
// bit). B4 and B6: row tiles at or past live_rows come out as zeros with
// no load; live tiles go first. B5: live_rows ends each expert's
// reduction over its rows.
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

// -- f32: TMA-fed FMA on the CUDA cores ---------------------------------------

namespace ffma {

constexpr int BM = 128;  // output rows of a tile
constexpr int BN = 128;  // output columns of a tile
constexpr int BK = 32;   // k of a ring stage: one 128-byte row of f32
constexpr int kStages = 4;
constexpr int kConsumers = 256;  // a 16 x 16 grid of 8 x 8 output blocks
// and a producer warpgroup, so that setmaxnreg can hand the consumers 240
// registers (the products' 128 live values and their next loads)
constexpr int kThreads = kConsumers + 128;
constexpr uint32_t kA = BM * BK * 4;  // a stage's A tile (16 KB)
constexpr uint32_t kB = BN * BK * 4;  // and its B tile (16 KB)
constexpr uint32_t kStage = kA + kB;
constexpr uint32_t kBars = kStages * kStage;
constexpr size_t kSmem = kBars + 128 + 1024;  // + mbarriers, align slack

// The mbarriers: a stage's TMA loads landed; a stage released by the
// eight consumer warps.
struct Bars {
  uint64_t full[kStages], empty[kStages];
};

// acc[i][j] += A[m][k] B[k][n] for this thread's rows m (K_MAJOR_A:
// ty + 16 i; else 4 ty + i % 4 + 64 (i / 4)) and columns n (K_MAJOR_B:
// tx + 16 j; else 4 tx + j % 4 + 64 (j / 4)), k over the stage's 32 in
// order: one fmaf chain an output, as the cp.async loop these kernels
// replaced. A K-major operand is the stage's SW128 tile [128 m or n][32
// k] (B4's x; B's w[e] read as [D][F] for dx); an MN-major one TMA's
// four SW128 boxes [32 k][32 m or n], box c holding m or n in [32 c, 32 c
// + 32) (B5's x^T and dy; B4's w[e] [D][F] for y). Every shared-memory
// read is 16 bytes: four k of a K-major row, or four m or n of an MN-major
// one; the lanes of a warp that read different rows, or different
// columns of one row, read different bank groups.
template <bool K_MAJOR_A, bool K_MAJOR_B>
__device__ __forceinline__ void stage_fma(float (&acc)[8][8],
                                          const unsigned char* sA,
                                          const unsigned char* sB, int ty,
                                          int tx) {
#pragma unroll
  for (int kc = 0; kc < BK / 4; ++kc) {  // four k at a time
    float4 a[8], b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if constexpr (K_MAJOR_A) {  // a[i]: k 4 kc + [0, 4) of row m
        const int m = ty + 16 * i;
        a[i] = *reinterpret_cast<const float4*>(sA + m * 128 +
                                                ((kc ^ (m & 7)) * 16));
      } else {  // a[2 kk + h]: rows 4 ty + 64 h + [0, 4) at k 4 kc + kk
        const int k = 4 * kc + i / 2, box = ty / 8 + 2 * (i % 2);
        a[i] = *reinterpret_cast<const float4*>(
            sA + box * 4096 + k * 128 + (((ty & 7) ^ (k & 7)) * 16));
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (K_MAJOR_B) {  // b[j]: k 4 kc + [0, 4) of column n
        const int n = tx + 16 * j;
        b[j] = *reinterpret_cast<const float4*>(sB + n * 128 +
                                                ((kc ^ (n & 7)) * 16));
      } else {  // b[2 kk + h]: columns 4 tx + 64 h + [0, 4) at k 4 kc + kk
        const int k = 4 * kc + j / 2, box = tx / 8 + 2 * (j % 2);
        b[j] = *reinterpret_cast<const float4*>(
            sB + box * 4096 + k * 128 + (((tx & 7) ^ (k & 7)) * 16));
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av =
            K_MAJOR_A
                ? reinterpret_cast<const float*>(&a[i])[kk]
                : reinterpret_cast<const float*>(&a[2 * kk + i / 4])[i % 4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float bv =
              K_MAJOR_B
                  ? reinterpret_cast<const float*>(&b[j])[kk]
                  : reinterpret_cast<const float*>(&b[2 * kk + j / 4])[j % 4];
          acc[i][j] = fmaf(av, bv, acc[i][j]);
        }
      }
    }
  }
}

// The persistent, warp-specialised loop over 128 x 128 output tiles in
// f32. Form gives kKMajorA and kKMajorB (stage_fma), kLiveK (live bounds
// the reduction, not the output rows: B5, below), kAByTma (A arrives by
// TMA with B; else each consumer warp writes the 16 rows of each stage's
// A tile that it reads, rows 2 w + [0, 2) + 16 i for warp w, one stage
// ahead: ARaw, fetch_a(raw, tile, k, row, half) issues a lane's loads of
// row ``row``, k + 16 half + [0, 16), before the stage's products,
// put_a(raw, sA, tile, k, row, half) writes them after), kBytes
// (a stage's TMA bytes), num_tiles, live (rows at or past it are written
// as zeros), tile(id) (nk = 0 for a tile of dead rows: no load, no
// product), load(a, b, bar, tile, k) (the TMA loads of the stage at k),
// N and out (the [rows][N] f32 output). With kLiveK the form's tile(id)
// bounds nk by live itself, tail(acc, tile, ty, tx) adds the rows of k
// past the tile's last whole stage, and the output is out [E][M][N]: a
// tile's rows are those of its expert's [M][N] block, masked at M. Launch
// with kThreads threads and kSmem bytes.
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
      int it = 0;  // stages loaded so far, across tiles
      for (int id = blockIdx.x; id < form.num_tiles; id += gridDim.x) {
        const auto tile = form.tile(id);
        for (int kt = 0; kt < tile.nk; ++kt, ++it) {
          const int s = it % kStages;
          if (it >= kStages) {
            hop::mbar_wait(&bar.empty[s], (it / kStages - 1) & 1);
          }
          hop::mbar_arrive_expect_tx(&bar.full[s], Form::kBytes);
          const uint32_t a = ring + s * kStage;
          form.load(a, a + kA, &bar.full[s], tile, tile.k0 + kt * BK);
        }
      }
    }
    return;
  }
  hop::regs_alloc<240>();

  const int t = threadIdx.x, ty = t / 16, tx = t % 16, lane = t % 32;
  // the A row this lane writes when the consumers write A (of the 16
  // this warp reads), and which half of the stage's 32 k
  const int a_row = 2 * (t / 32) + (lane / 2) % 2 + 16 * (lane / 4);
  const int a_half = lane % 2;
  int it = 0;  // stages consumed so far, across tiles
  for (int id = blockIdx.x; id < form.num_tiles; id += gridDim.x) {
    const auto tile = form.tile(id);
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;  // a dead tile: zeros
    typename Form::ARaw raw;
    if constexpr (!Form::kAByTma) {
      if (tile.nk > 0) {
        form.fetch_a(raw, tile, tile.k0, a_row, a_half);
        form.put_a(raw, base + (it % kStages) * kStage, tile, tile.k0, a_row,
                   a_half);
        __syncwarp();  // the warp's lanes read each other's rows
      }
    }
    for (int kt = 0; kt < tile.nk; ++kt, ++it) {
      const int s = it % kStages;
      const bool more = kt + 1 < tile.nk;
      const int k_next = tile.k0 + (kt + 1) * BK;
      if constexpr (!Form::kAByTma) {
        if (more) form.fetch_a(raw, tile, k_next, a_row, a_half);
      }
      hop::mbar_wait(&bar.full[s], (it / kStages) & 1);
      const unsigned char* stage = base + s * kStage;
      stage_fma<Form::kKMajorA, Form::kKMajorB>(acc, stage, stage + kA, ty,
                                                tx);
      // The release lets the producer refill the stage by TMA, the async
      // proxy; the stage's reads above are generic-proxy loads, the last
      // of which ptxas issues just before the arrive (their FFMAs after
      // it). The proxy fence orders them before that refill. Without it
      // B6 came out wrong in about 1 % of its calls on the card: 16 rows
      // of one warp, the tile's first 32 (or 64) columns, the first TMA
      // box of a refill (PERF.md).
      hop::fence_async_shared();
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&bar.empty[s]);
      if constexpr (!Form::kAByTma) {
        // this warp last read these rows of that stage kStages - 1
        // steps ago, and released it since
        if (more) {
          form.put_a(raw, base + ((it + 1) % kStages) * kStage, tile,
                     k_next, a_row, a_half);
          __syncwarp();
        }
      }
    }
    if constexpr (Form::kLiveK) form.tail(acc, tile, ty, tx);
    // straight from the registers: rows at or past live are zeros (with
    // kLiveK, rows at or past M are not written)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = tile.m0 + (Form::kKMajorA ? ty + 16 * i
                                              : 4 * ty + i % 4 + 64 * (i / 4));
      bool dead = false;
      float* row;
      if constexpr (Form::kLiveK) {
        if (m >= form.M) continue;
        row = form.out + ((size_t)tile.e * form.M + m) * form.N + tile.n0;
      } else {
        dead = m >= form.live;
        row = form.out + (size_t)m * form.N + tile.n0;
      }
      if constexpr (Form::kKMajorB) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tx + 16 * j;
          if (tile.n0 + n < form.N) row[n] = dead ? 0.f : acc[i][j];
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = 4 * tx + 64 * h;
          if (tile.n0 + n < form.N) {
            *reinterpret_cast<float4*>(row + n) =
                dead ? make_float4(0.f, 0.f, 0.f, 0.f)
                     : make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                   acc[i][4 * h + 2], acc[i][4 * h + 3]);
          }
        }
      }
    }
  }
}

// Which output tile the launch order's id is: the tiles of live rows
// first, num_live_m of them down and num_n across, in groups of
// kGroupRows row tiles (column tiles within a group, so the row tiles and
// weight columns in flight stay in the L2); then the dead ones, nk = 0.
// e is row tile m's expert, clamped to [0, E) so a bad entry cannot read
// outside w.
__device__ __forceinline__ ws::Tile live_first_tile(
    int id, int num_live_m, int num_n, int group_rows_max,
    const int* tile_expert, int block_t, int E, int nk) {
  const int live_tiles = num_live_m * num_n;
  int m_tile, n_tile;
  if (id < live_tiles) {
    const int per_group = group_rows_max * num_n;
    const int first_m = (id / per_group) * group_rows_max;
    const int group_rows = min(num_live_m - first_m, group_rows_max);
    m_tile = first_m + (id % per_group) % group_rows;
    n_tile = (id % per_group) / group_rows;
  } else {
    m_tile = num_live_m + (id - live_tiles) / num_n;
    n_tile = (id - live_tiles) % num_n;
    nk = 0;
  }
  const int m0 = m_tile * BM;
  const int e = min(max(tile_expert[m0 / block_t], 0), E - 1);
  return {e, m0, n_tile * BN, 0, nk};
}

// rows at or past *live_rows (all rows when live_rows is null; clamped
// to [0, rows]) are dead; row tiles from the first wholly dead one on
// are not computed.
__device__ __forceinline__ int live_row_count(const int* live_rows,
                                              int rows) {
  return live_rows == nullptr ? rows : min(max(__ldg(live_rows), 0), rows);
}

}  // namespace ffma

}  // namespace gm
}  // namespace dlr

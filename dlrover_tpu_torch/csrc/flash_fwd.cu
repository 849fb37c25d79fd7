// B1: flash-attention forward for Hopper (sm_90a).
//
// Replaces dlrover_tpu/ops/flash_attention.py::_flash_fwd_kernel (launched
// by _flash_forward): online-softmax attention with an f32 running max,
// normaliser and accumulator, blocks above the causal diagonal skipped,
// query head h reading KV head h / group, writing O and a per-row f32
// logsumexp.
//
// Bound on the H100: operations. At the main path's shape (H=32, H_kv=8,
// S=4096, D=128, bf16, causal) the two products are 137 GFLOP against
// about 84 MB of input and output, i.e. ~1600 FLOP per byte, far above
// the card's ~295 FLOP/byte ridge: 0.139 ms at 989 TFLOP/s.
//
// bf16 design (flash_fwd_bf16_kernel): one block per (128-row q tile,
// head, batch), 384 threads, one block an SM, the q tiles with the most
// causal work first. One producer warp keeps TMA loads of 128-key K and V
// tiles in flight through a 2-stage shared-memory ring (mbarriers for
// full and empty stages; 3-D tensor maps, so a ragged tile reads zeros,
// never the next head's rows); Q is loaded once and stays. Two consumer
// warpgroups own 64 q rows each and hold S, P and O in registers
// (setmaxnreg gives them 240 registers a thread, the producer 24). Both
// products are wgmma: S = Q K^T (m64n128k16, Q and K from 128-byte-
// swizzled shared memory) and O += P V (P rounded to bf16 in registers
// and fed as the A operand; V read in place, MN-major, through the
// transpose bit). The online softmax works in base 2 on the accumulator
// layout (a row spans a quad of lanes), masks only the tiles that cross
// the diagonal or the ragged end, and advances in 64-key steps: the
// first half's P V runs on the tensor cores while the second half's max
// and exponentials are computed. (A 128-key step moved the full-width
// loss above the reference path's; PERF.md has the runs.) The
// segment-id kernels run this design on a 64-wide head tile at head
// dims up to 64, every kernel on a 128-wide one above; columns past D
// read as zeros, which change neither S nor the stored part of O.
//
// 64-wide head tile (flash_fwd_d64_kernel: head dims up to 64,
// unsegmented, causal, not causal or prefix-LM; GLM's main path). The
// blocks above, with the same tiles, 64-key steps, sums and order, so O
// and lse are bit for bit the above design's at D <= 64 (PERF.md), and:
//   - persistent blocks, one an SM, walk the blocks above as items in
//     their order (item w, w + gridDim.x, ...), with Q double-buffered:
//     the next item's Q and first K/V tiles load under this item's last
//     tiles. One K/V tile a block had cost 0.142 ms of the 0.449 at
//     GLM's shape (H100 80GB HBM3, 700 W): launch, barriers, Q's
//     latency and the epilogue, for each of 4096 blocks;
//   - each tile's next S is issued behind its first P V and runs under
//     its second softmax step; the second P V runs under the next tile's
//     first step. Every wgmma wait is on every path (a conditional one
//     made ptxas serialize every wgmma);
//   - 4 ring stages of K and V.
// By stages (chip_stages.py, the fwd64- set) the softmax's own
// instructions hold it: with no product and no exponential it still
// takes most of its time (PERF.md). Neither turns between the
// warpgroups, nor S issued a whole tile ahead into a second register
// buffer, nor three consumer warpgroups over 192 rows made it faster.
//
// f32 (the parity path, flash_fwd_f32_kernel): 32x32 tiles staged in
// shared memory, scalar FMA products (flash_common.cuh).
//
// Segment-id mode (packed documents; the reference's segmented=True,
// flash_attention.py:127-131): a separate instantiation of each kernel
// (SEG = true, entry points dlr_flash_fwd_seg_*) takes int32 ids seg_q
// [B, Sq] and seg_k [B, Sk] and keeps a score only where the query's id
// equals the key's, on top of the causal mask; the SEG = false kernels
// are the unsegmented ones, unchanged. The bf16 kernel also takes the
// ids' tile table seg_tiles [B, ceil(Sq / 64) + ceil(Sk / 64), 2]: the
// [min, max] id of each 64-id tile, q side then k side, built on the
// device once a layer's forward (flash_attention.py's segment_tiles) and
// handed on to B2 and B3 for its backward. Before the role split one
// warp lists in shared memory the block's K/V tiles (0 .. nkt, after the
// causal cut; all of them when not causal) one of whose 64-key halves at
// or below a warpgroup's diagonal has a [min, max] meeting that of the
// warpgroup's 64 rows, each with a bit for each warpgroup it meets (B3's
// list: the two kernels share a tile geometry); the producer and both
// consumer warpgroups walk that list, so the mbarrier phases stay in
// step, and a warpgroup whose bit is clear waits for the stage and
// releases it unread. The test never drops a tile that holds a same-id
// pair, for any ids, and on sorted ids lists exactly those tiles; a tile
// it drops would have added exact zeros (with finite inputs the rescale
// factor of a masked step is 1, or 0 while the row has seen no key). A
// listed tile can still hold a document boundary, and ids need not be
// sorted (a pad tail of -1 follows higher ids), so no listed tile goes
// unchecked. One warp of the producer warpgroup (otherwise idle but for
// its TMA thread) reads the ids by plain loads, issued before it waits
// for the ring stage, into shared memory: the block's 128 q ids once,
// each listed K/V tile's 128 k ids beside the tile, with "these 64 ids
// are one value" flags (hop::seg_load, hop::seg_publish), announced by
// one more mbarrier a stage. From the flags a consumer warpgroup learns
// how its rows and the tile's keys meet (hop::seg_mode, voted
// warp-uniform): one id on both sides, the unsegmented masks alone; one
// id each but two ids, every score -inf; ids changing inside the tile, a
// pass that sets -inf where a key's id differs from its row's. Both run
// as warp-uniform branches apart from the unsegmented mask: merged into
// its per-element loop (a predicated body on every tile), or with ids in
// registers (spills under the consumers' 240), the packed row took
// 1.5-2.3x the unsegmented time (PERF.md, section 6). The f32 kernel
// visits every causal tile, stages the ids beside its tiles, masks
// element by element and ignores the table. A row that sees no key at
// all (the pair form's kv-side ids may lack its id) keeps l = 0: it
// stores out = 0 and lse = NEG_INF (finfo(float32).min, not -inf), the
// reference's values; a block whose list is empty runs no tile and
// stores those values for all its rows.
//
// Prefix-LM mode (GLM's mask; the reference's prefix=True,
// flash_attention.py:122-126): a third instantiation of each kernel (PFX
// = true, entry points dlr_flash_fwd_pfx_*, always causal) takes int32
// prefix_len [B] and lets query i see key j iff j <= i or j < p, p =
// prefix_len[b]. A block reads p once (thread 0, into shared memory,
// before the barrier that follows the mbarriers' set-up), and the
// producer warp and the consumers derive the same schedule from it: k
// tiles 0 .. max(i + 1, ceil(p / BK)) - 1, p clamped to [0, Sk] for the
// schedule only. A tile wholly inside the prompt needs no mask even
// above the diagonal; only a tile that crosses a warpgroup's diagonal and
// is not wholly prompt keys (or crosses the ragged end) takes the
// per-element pass, which sets -inf where col > row and col >= p, the
// reference's rule for any p. That pass is a warp-uniform branch of its
// own: the unsegmented instantiation's code is unchanged. Tiles are
// visited with j rising, so key 0, which every row sees, comes first: a
// half-step above the diagonal and past the prompt can be masked whole
// for every row of a warpgroup, and by then each row's running max is
// finite, so exp2 of -inf - m is 0 and no clamp is needed.

#include <type_traits>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace dlr {

// -- f32 ---------------------------------------------------------------------

size_t fwd_smem_bytes(int D, bool seg) {
  using T = float;
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK, PAD = Tile<T>::PAD;
  const int ldt = D + PAD;
  return round128(sizeof(T) * BQ * ldt)        // Q
         + 2 * round128(sizeof(T) * BK * ldt)  // K, V
         + round128(sizeof(float) * BQ * (BK + kFPad))  // S
         + round128(sizeof(T) * BQ * (BK + PAD))        // P
         + round128(sizeof(float) * BQ * (D + kFPad))   // O accumulator
         + (seg ? round128(sizeof(int) * BQ) + round128(sizeof(int) * BK)
                : 0);  // segment ids of the rows and of the K/V tile
}

template <bool SEG, bool PFX>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int H, int Hkv, int Sq,
                         int Sk, int D, float scale, int causal,
                         const int* __restrict__ seg_q,
                         const int* __restrict__ seg_k,
                         const int* __restrict__ prefix_len) {
  using T = float;
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK, PAD = Tile<T>::PAD;
  constexpr int LANES = kThreads / BQ;  // threads sharing one row
  constexpr int COLS = BK / LANES;      // S columns per thread
  const int ldt = D + PAD, lds = BK + kFPad, ldp = BK + PAD, ldo = D + kFPad;

  const int nqt = (Sq + BQ - 1) / BQ;
  const int i = nqt - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);

  extern __shared__ __align__(128) unsigned char smem[];
  SmemCarve carve{smem};
  T* sQ = carve.take<T>(BQ * ldt);
  T* sK = carve.take<T>(BK * ldt);
  T* sV = carve.take<T>(BK * ldt);
  float* sS = carve.take<float>(BQ * lds);
  T* sP = carve.take<T>(BQ * ldp);
  float* sO = carve.take<float>(BQ * ldo);
  int* sSegQ = SEG ? carve.take<int>(BQ) : nullptr;
  int* sSegK = SEG ? carve.take<int>(BK) : nullptr;

  const size_t q_row0 = ((size_t)b * H + h) * Sq + (size_t)i * BQ;
  const T* k_head = k + ((size_t)b * Hkv + hk) * Sk * D;
  const T* v_head = v + ((size_t)b * Hkv + hk) * Sk * D;
  load_tile(sQ, ldt, q + q_row0 * D, min(BQ, Sq - i * BQ), BQ, D);
  zero_f32(sO, ldo, BQ, D);
  if constexpr (SEG) {  // rows past Sq read 0 and are never stored
    for (int t = threadIdx.x; t < BQ; t += blockDim.x) {
      sSegQ[t] = i * BQ + t < Sq ? seg_q[(size_t)b * Sq + i * BQ + t] : 0;
    }
  }

  const int r = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int row = i * BQ + r;
  float m_run = kNegInf, l_run = 0.f;
  int nkt = (Sk + BK - 1) / BK;
  if (causal) nkt = min(nkt, (i * BQ + BQ - 1) / BK + 1);
  // prefix-LM mode: every tile of prompt keys as well
  const int plen = PFX ? prefix_len[b] : 0;
  if (PFX) nkt = max(nkt, (min(max(plen, 0), Sk) + BK - 1) / BK);

  for (int j = 0; j < nkt; ++j) {
    __syncthreads();  // the previous tile's readers of sK/sV/sP are done
    const int kvalid = min(BK, Sk - j * BK);
    load_tile(sK, ldt, k_head + (size_t)j * BK * D, kvalid, BK, D);
    load_tile(sV, ldt, v_head + (size_t)j * BK * D, kvalid, BK, D);
    if constexpr (SEG) {
      for (int t = threadIdx.x; t < BK; t += blockDim.x) {
        sSegK[t] = t < kvalid ? seg_k[(size_t)b * Sk + j * BK + t] : 0;
      }
    }
    __syncthreads();
    tile_mma<false, true>(sQ, ldt, sK, ldt, sS, lds, BQ, BK, D, false);
    __syncthreads();

    float s[COLS];
    float mx = kNegInf;
#pragma unroll
    for (int t = 0; t < COLS; ++t) {
      const int c = lane + t * LANES, col = j * BK + c;
      const bool ok = col < Sk && (!causal || col <= row ||
                                   (PFX && col < plen)) &&
                      (!SEG || sSegK[c] == sSegQ[r]);
      s[t] = ok ? sS[r * lds + c] * scale : kNegInf;
      mx = fmaxf(mx, s[t]);
    }
    const float m_new = fmaxf(m_run, group_max<LANES>(mx));
    // a row with every column masked so far keeps m at -inf; clamp the
    // subtrahend so exp() sees a finite argument (its l stays 0)
    const float m_sub = m_new <= kNegInf * 0.5f ? 0.f : m_new;
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < COLS; ++t) {
      const float p = expf(s[t] - m_sub);
      psum += p;
      sP[r * ldp + lane + t * LANES] = from_f<T>(p);
    }
    const float alpha = expf(m_run - m_sub);
    l_run = alpha * l_run + group_sum<LANES>(psum);
    m_run = m_new;
    for (int d = lane; d < D; d += LANES) sO[r * ldo + d] *= alpha;
    __syncthreads();
    tile_mma<false, false>(sP, ldp, sV, ldt, sO, ldo, BQ, D, BK, true);
  }
  __syncthreads();

  if (row < Sq) {
    const float l_safe = l_run == 0.f ? 1.f : l_run;
    T* o_row = o + (q_row0 + r) * D;
    for (int d = lane; d < D; d += LANES) {
      o_row[d] = from_f<T>(sO[r * ldo + d] / l_safe);
    }
    if (lane == 0) lse[q_row0 + r] = m_run + logf(l_safe);
  }
}

// -- bf16 --------------------------------------------------------------------

namespace fwd {

using bf16 = __nv_bfloat16;
constexpr int BQ = 128;  // q rows a block: two consumer warpgroups of 64
constexpr int BK = 128;  // keys a K/V tile
constexpr int kStages = 2;
constexpr int kConsumers = 256;  // threads of the two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory at head-dim tile DP (64 or 128): Q, then kStages x (K,
// V), each tile DP / 64 SW128 column blocks of its rows x 128 bytes (one
// TMA box each), then the mbarriers.
template <int DP>
struct Layout {
  static constexpr uint32_t kQ = BQ * DP * 2;
  static constexpr uint32_t kKV = BK * DP * 2;  // one K or one V tile
  static constexpr uint32_t kBars = kQ + 2 * kStages * kKV;
  static constexpr size_t kSmem = kBars + 128 + 1024;  // + align slack
  // segment-id mode, after the mbarriers: the block's q ids and their
  // flags (hop::seg_publish), then a stage's k ids and flags each
  static constexpr uint32_t kIds = kBars + 128;
  static constexpr int kQIds = BQ + 8, kKIds = BK + 8;  // ints
  static constexpr size_t kIdBytes = (kQIds + kStages * kKIds) * 4;
  // then the block's list of K/V tiles, one int a tile
  static constexpr uint32_t kList = kIds + kIdBytes;
};

// The mbarriers: Q arrived; K, V of a stage arrived; a stage released by
// both consumer warpgroups; (segment-id mode) a stage's k ids written.
// Then (prefix-LM mode) the block's prefix length; (segment-id mode) the
// length of the block's list of K/V tiles.
struct Bars {
  uint64_t q_full, k_full[kStages], v_full[kStages], empty[kStages];
  uint64_t ids_full[kStages];
  int prefix, count;
};

// One step of the online softmax over S columns [64 HALF, 64 HALF + 64)
// of this thread's two rows: the running max m (base 2), this thread's
// share l of the row sum, the factors a that rescale what came before,
// and p = exp2(s scale_log2 - m) written over s.
template <int HALF>
__device__ __forceinline__ void softmax_step(float (&sacc)[64], float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& a0, float& a1,
                                             float scale_log2) {
  constexpr int C0 = 8 * HALF;  // first 8-column chunk
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int c = C0; c < C0 + 8; ++c) {
    mx0 = fmaxf(mx0, fmaxf(sacc[4 * c], sacc[4 * c + 1]));
    mx1 = fmaxf(mx1, fmaxf(sacc[4 * c + 2], sacc[4 * c + 3]));
  }
#pragma unroll
  for (int lane = 1; lane <= 2; lane <<= 1) {  // the row's quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, lane));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, lane));
  }
  const float mn0 = fmaxf(m0, mx0 * scale_log2);
  const float mn1 = fmaxf(m1, mx1 * scale_log2);
  // a row with every column masked so far keeps m at -inf; clamp the
  // subtrahend so exp2 sees a finite argument (its l stays 0)
  const float ms0 = mn0 == -INFINITY ? 0.f : mn0;
  const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
  a0 = hop::ex2(m0 - ms0);
  a1 = hop::ex2(m1 - ms1);
  m0 = mn0;
  m1 = mn1;
  float r0 = 0.f, r1 = 0.f;
#pragma unroll
  for (int c = C0; c < C0 + 8; ++c) {
    sacc[4 * c] = hop::ex2(fmaf(sacc[4 * c], scale_log2, -ms0));
    sacc[4 * c + 1] = hop::ex2(fmaf(sacc[4 * c + 1], scale_log2, -ms0));
    sacc[4 * c + 2] = hop::ex2(fmaf(sacc[4 * c + 2], scale_log2, -ms1));
    sacc[4 * c + 3] = hop::ex2(fmaf(sacc[4 * c + 3], scale_log2, -ms1));
    r0 += sacc[4 * c] + sacc[4 * c + 1];
    r1 += sacc[4 * c + 2] + sacc[4 * c + 3];
  }
  l0 = l0 * a0 + r0;
  l1 = l1 * a1 + r1;
}

// O rows *= a (first row a0, second a1).
template <int N>
__device__ __forceinline__ void rescale(float (&oacc)[N], float a0,
                                        float a1) {
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    oacc[4 * c] *= a0;
    oacc[4 * c + 1] *= a0;
    oacc[4 * c + 2] *= a1;
    oacc[4 * c + 3] *= a1;
  }
}

// Issue O += P V over keys [64 HALF, 64 HALF + 64) of the tile: P (bf16)
// from registers, V [keys][DP] read MN-major through the transpose bit.
template <int DP, int HALF>
__device__ __forceinline__ void pv(float (&oacc)[DP / 2],
                                   const uint32_t (&pa)[8][4], uint32_t sV) {
  hop::wgmma_fence();
  hop::fence_regs(oacc);
#pragma unroll
  for (int kk = 4 * HALF; kk < 4 * HALF + 4; ++kk) {
    const uint64_t dv = hop::desc_sw128(sV + kk * 16 * 128, BK * 128, 1024);
    if constexpr (DP == 128) {
      hop::wgmma_rs_m64n128k16<1>(oacc, pa[kk], dv, 1);
    } else {
      hop::wgmma_rs_m64n64k16<1>(oacc, pa[kk], dv, 1);
    }
  }
  hop::wgmma_commit();
}

template <int DP, bool SEG, bool PFX>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          bf16* __restrict__ o, float* __restrict__ lse,
                          int H, int Hkv, int Sq, int Sk, int D,
                          float scale_log2, int causal,
                          const int* __restrict__ seg_q,
                          const int* __restrict__ seg_k,
                          const int* __restrict__ prefix_len,
                          const int* __restrict__ seg_tiles) {
  using L = Layout<DP>;
  constexpr int NO = DP / 2;  // O accumulator registers a thread
  const int nqt = (Sq + BQ - 1) / BQ;
  // every head's last q tile first: the heaviest causal blocks lead
  const int i = nqt - 1 - blockIdx.x / H;
  const int h = blockIdx.x % H, b = blockIdx.y;
  int nkt = (Sk + BK - 1) / BK;
  if (causal) nkt = min(nkt, i + 1);  // BQ == BK: tiles 0..i

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sQ = hop::smem_u32(base);
  auto sK = [&](int s) { return sQ + L::kQ + s * 2 * L::kKV; };
  auto sV = [&](int s) { return sK(s) + L::kKV; };
  Bars& bar = *reinterpret_cast<Bars*>(base + L::kBars);
  // segment-id mode: the q ids and flags, then stage s's k ids and flags
  int* sid = reinterpret_cast<int*>(base + L::kIds);
  auto kids = [&](int s) { return sid + L::kQIds + s * L::kKIds; };
  // segment-id mode: the listed K/V tiles, tile * 4 + a bit for each
  // warpgroup whose rows' ids the tile's can meet
  int* list = reinterpret_cast<int*>(base + L::kList);
  // the K/V tile of step j
  auto k_tile = [&](int j) {
    if constexpr (SEG) {
      return list[j] >> 2;
    } else {
      return j;
    }
  };
  if (threadIdx.x == 0) {
    hop::mbar_init(&bar.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&bar.k_full[s], 1);
      hop::mbar_init(&bar.v_full[s], 1);
      hop::mbar_init(&bar.empty[s], kConsumers);
      if constexpr (SEG) hop::mbar_init(&bar.ids_full[s], 32);
    }
    hop::mbar_fence_init();
    if constexpr (PFX) bar.prefix = prefix_len[b];
  }
  if constexpr (SEG) {
    // one warp lists the K/V tiles 0 .. nkt whose ids can meet this q
    // tile's: by the [min, max] ids of its two 64-row halves (warpgroup
    // w's rows) and of each 64-key half of a K/V tile
    if (threadIdx.x < 32) {
      const int nq = (Sq + 63) / 64, nk = (Sk + 63) / 64;
      const int* tab_q = seg_tiles + (size_t)b * (nq + nk) * 2;
      const int* tab_k = tab_q + nq * 2;
      int lo[2], hi[2];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const int qt = min(2 * i + w, nq - 1);
        lo[w] = __ldg(tab_q + 2 * qt);
        hi[w] = __ldg(tab_q + 2 * qt + 1);
      }
      const int n = hop::seg_compact(list, 0, nkt, threadIdx.x, [&](int jt) {
        int m = 0;
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const int qt = 2 * i + w;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kt = 2 * jt + e;
            if (qt < nq && kt < nk && !(causal && kt > qt) &&
                hop::seg_meets(tab_k + 2 * kt, lo[w], hi[w])) {
              m |= 1 << w;
            }
          }
        }
        return m;
      });
      if (threadIdx.x == 0) bar.count = n;
    }
  }
  __syncthreads();
  // prefix-LM mode: the prompt's k tiles too (p clamped for the schedule)
  const int plen = PFX ? bar.prefix : 0;
  if (PFX) nkt = max(nkt, (min(max(plen, 0), Sk) + BK - 1) / BK);
  if constexpr (SEG) nkt = bar.count;

  if (threadIdx.x >= kConsumers) {
    // producer: one thread keeps the TMA loads of the ring in flight; in
    // segment-id mode its warp writes the ids
    hop::regs_dealloc<24>();
    const int pt = threadIdx.x - kConsumers;
    if constexpr (SEG) {  // announced with tile 0's k ids; a row past
      // Sq (never stored) takes the last row's id
      if (pt < 32) {
        int v[BQ / 32];
        hop::seg_load(v, seg_q + (size_t)b * Sq, i * BQ, Sq - 1, pt);
        hop::seg_publish(sid, sid + BQ, pt, v);
      }
    }
    if (SEG ? pt < 32 : pt == 0) {
      const int hk = h / (H / Hkv);
      if (pt == 0) {
        hop::mbar_arrive_expect_tx(&bar.q_full, L::kQ);
        for (int c = 0; c < DP / 64; ++c) {
          hop::tma_load_3d(sQ + c * BQ * 128, &tq, &bar.q_full, c * 64,
                           i * BQ, b * H + h);
        }
      }
      for (int j = 0; j < nkt; ++j) {
        const int s = j % kStages, jt = k_tile(j);
        int v[BK / 32];  // segment-id mode: the tile's k ids
        if constexpr (SEG) {
          hop::seg_load(v, seg_k + (size_t)b * Sk, jt * BK, Sk - 1, pt);
        }
        // the stage's previous tile, j - kStages, is released
        if (j >= kStages) hop::mbar_wait(&bar.empty[s], (j / kStages - 1) & 1);
        if (pt == 0) {
          hop::mbar_arrive_expect_tx(&bar.k_full[s], L::kKV);
          for (int c = 0; c < DP / 64; ++c) {
            hop::tma_load_3d(sK(s) + c * BK * 128, &tk, &bar.k_full[s],
                             c * 64, jt * BK, b * Hkv + hk);
          }
          hop::mbar_arrive_expect_tx(&bar.v_full[s], L::kKV);
          for (int c = 0; c < DP / 64; ++c) {
            hop::tma_load_3d(sV(s) + c * BK * 128, &tv, &bar.v_full[s],
                             c * 64, jt * BK, b * Hkv + hk);
          }
        }
        if constexpr (SEG) {  // a key past Sk (masked) took the last's id
          hop::seg_publish(kids(s), kids(s) + BK, pt, v);
          hop::mbar_arrive(&bar.ids_full[s]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns q rows [64 wg, 64 wg + 64) of the tile
  hop::regs_alloc<240>();
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int quad = t % 4;
  const int row0 = i * BQ + wg * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int row1 = row0 + 8;
  const uint32_t sQw = sQ + wg * 64 * 128;

  float oacc[NO];
#pragma unroll
  for (int x = 0; x < NO; ++x) oacc[x] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, base-2 units
  float l0 = 0.f, l1 = 0.f;  // this thread's share of the row sums

  hop::mbar_wait(&bar.q_full, 0);
  for (int j = 0; j < nkt; ++j) {
    const int s = j % kStages, phase = (j / kStages) & 1, jt = k_tile(j);

    // segment-id mode: how this warpgroup's rows and the tile's keys
    // mask (hop::SegMode), read before the products, while their
    // accumulators are not yet live
    int seg = hop::kSegNone;
    if constexpr (SEG) {
      hop::mbar_wait(&bar.ids_full[s], phase);
      // the tile's ids can meet none of this warpgroup's rows (it was
      // listed for the other's): the stage is released unread
      if (!((list[j] >> wg) & 1)) {
        hop::mbar_wait(&bar.k_full[s], phase);
        hop::mbar_wait(&bar.v_full[s], phase);
        hop::mbar_arrive(&bar.empty[s]);
        continue;
      }
      seg = hop::seg_mode(sid + BQ, wg, 1, kids(s) + BK, 0, 2);
    }

    // S = Q K^T over DP / 16 k16 steps
    float sacc[64];
    hop::mbar_wait(&bar.k_full[s], phase);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      // BQ == BK: Q and K column blocks have the same stride
      const uint32_t off = (kk / 4) * BK * 128 + (kk % 4) * 32;
      hop::wgmma_ss_m64n128k16<0>(
          sacc, hop::desc_sw128(sQw + off, 16, 1024),
          hop::desc_sw128(sK(s) + off, 16, 1024), kk > 0);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(sacc);
    // segment-id mode: a tile masked whole, or by id where ids change
    // (warp-uniform branches, apart from the unsegmented mask below)
    if (seg == hop::kSegAll) {
#pragma unroll
      for (int x = 0; x < 64; ++x) sacc[x] = -INFINITY;
    } else if (seg == hop::kSegById) {
      const int* kid = kids(s);
      const int qid0 = sid[row0 - i * BQ], qid1 = sid[row1 - i * BQ];
#pragma unroll
      for (int x = 0; x < 64; ++x) {
        const int c = 8 * (x / 4) + 2 * quad + (x & 1);
        if (kid[c] != ((x & 2) ? qid1 : qid0)) sacc[x] = -INFINITY;
      }
    }
    // mask the tiles that cross the ragged end or this warpgroup's
    // diagonal; in prefix-LM mode not those wholly inside the prompt
    if constexpr (PFX) {
      if ((jt + 1) * BK > Sk ||
          (jt * BK + BK - 1 > i * BQ + wg * 64 && jt * BK + BK > plen)) {
#pragma unroll
        for (int x = 0; x < 64; ++x) {
          const int col = jt * BK + 8 * (x / 4) + 2 * quad + (x & 1);
          const int row = (x & 2) ? row1 : row0;
          if (col >= Sk || (col > row && col >= plen)) sacc[x] = -INFINITY;
        }
      }
    } else if ((jt + 1) * BK > Sk ||
               (causal && jt * BK + BK - 1 > i * BQ + wg * 64)) {
#pragma unroll
      for (int x = 0; x < 64; ++x) {
        const int col = jt * BK + 8 * (x / 4) + 2 * quad + (x & 1);
        const int row = (x & 2) ? row1 : row0;
        if (col >= Sk || (causal && col > row)) sacc[x] = -INFINITY;
      }
    }

    // the softmax state advances every 64 keys, two steps a tile: P of
    // the first half goes to the tensor cores while the second half's
    // max and exponentials are computed
    float a0, a1;
    uint32_t pa[8][4];
    softmax_step<0>(sacc, m0, m1, l0, l1, a0, a1, scale_log2);
    rescale<NO>(oacc, a0, a1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hop::acc_to_a(sacc, kk, pa[kk]);
    hop::mbar_wait(&bar.v_full[s], phase);
    pv<DP, 0>(oacc, pa, sV(s));
    softmax_step<1>(sacc, m0, m1, l0, l1, a0, a1, scale_log2);
#pragma unroll
    for (int kk = 4; kk < 8; ++kk) hop::acc_to_a(sacc, kk, pa[kk]);
    hop::wgmma_wait<0>();
    hop::fence_regs(oacc);
    rescale<NO>(oacc, a0, a1);
    pv<DP, 1>(oacc, pa, sV(s));
    hop::wgmma_wait<0>();
    hop::fence_regs(oacc);
    hop::mbar_arrive(&bar.empty[s]);  // this thread is done with stage s
  }

#pragma unroll
  for (int lane = 1; lane <= 2; lane <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, lane);
    l1 += __shfl_xor_sync(0xffffffffu, l1, lane);
  }
  const float ls0 = l0 == 0.f ? 1.f : l0, ls1 = l1 == 0.f ? 1.f : l1;
  const float inv0 = 1.f / ls0, inv1 = 1.f / ls1;
  const size_t head_row = ((size_t)b * H + h) * Sq;
#pragma unroll
  for (int c = 0; c < NO / 4; ++c) {
    const int col = 8 * c + 2 * quad;
    if (col < D) {
      if (row0 < Sq) {
        *reinterpret_cast<__nv_bfloat162*>(o + (head_row + row0) * D + col) =
            __floats2bfloat162_rn(oacc[4 * c] * inv0, oacc[4 * c + 1] * inv0);
      }
      if (row1 < Sq) {
        *reinterpret_cast<__nv_bfloat162*>(o + (head_row + row1) * D + col) =
            __floats2bfloat162_rn(oacc[4 * c + 2] * inv1,
                                  oacc[4 * c + 3] * inv1);
      }
    }
  }
  if (quad == 0) {  // lse in natural-log units, as the backward reads it
    // (segment-id mode: a row that saw no key stores NEG_INF, not -inf,
    // and the product and the sum are rounded one by one: the tile
    // list's branches led the compiler to fuse them into one FMA, which
    // moved lse by an ulp against the kernel before lists)
    if (row0 < Sq) {
      lse[head_row + row0] =
          SEG ? (l0 == 0.f ? kNegInf
                           : __fadd_rn(__fmul_rn(m0, kLn2), logf(ls0)))
              : m0 * kLn2 + logf(ls0);
    }
    if (row1 < Sq) {
      lse[head_row + row1] =
          SEG ? (l1 == 0.f ? kNegInf
                           : __fadd_rn(__fmul_rn(m1, kLn2), logf(ls1)))
              : m1 * kLn2 + logf(ls1);
    }
  }
}

template <int DP, bool SEG, bool PFX = false>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int H, int Hkv, int Sq, int Sk, int D,
                float scale, int causal, void* stream,
                const int* seg_q = nullptr, const int* seg_k = nullptr,
                const int* prefix_len = nullptr,
                const int* seg_tiles = nullptr) {
  // the row max is taken on unscaled scores: it needs scale > 0
  if (!(scale > 0.f)) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!hop::tensor_map(&tq, static_cast<const bf16*>(q), B * H, Sq, D, BQ) ||
      !hop::tensor_map(&tk, static_cast<const bf16*>(k), B * Hkv, Sk, D,
                       BK) ||
      !hop::tensor_map(&tv, static_cast<const bf16*>(v), B * Hkv, Sk, D,
                       BK)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((Sq + BQ - 1) / BQ * H, B);
  // segment-id mode: the ids, then the list (one int a K/V tile)
  const size_t smem =
      Layout<DP>::kSmem +
      (SEG ? Layout<DP>::kIdBytes + (Sk + BK - 1) / BK * sizeof(int) : 0);
  return hop::launch(flash_fwd_bf16_kernel<DP, SEG, PFX>, grid, kThreads,
                     smem, stream, tq, tk, tv, static_cast<bf16*>(o), lse, H,
                     Hkv, Sq, Sk, D, scale * kLog2e, causal, seg_q, seg_k,
                     prefix_len, seg_tiles);
}

// -- bf16, 64-wide head tile ----------------------------------------------
//
// The unsegmented kernel at head dims up to 64 (header: "64-wide head
// tile"): the blocks, tiles and 64-key softmax steps of
// flash_fwd_bf16_kernel as the items of persistent blocks, one an SM, Q
// double-buffered; each tile's next S issued behind its first P V; a
// 4-stage ring.
namespace d64 {

constexpr int kStages = 4;

struct Layout {
  static constexpr uint32_t kQ = BQ * 64 * 2;   // one of the two Q buffers
  static constexpr uint32_t kKV = BK * 64 * 2;  // one K or one V tile
  static constexpr uint32_t kStage0 = 2 * kQ;
  static constexpr uint32_t kBars = kStage0 + kStages * 2 * kKV;
  static constexpr size_t kSmem = kBars + 256 + 1024;  // + align slack
};

// Q of a buffer arrived, and released by both consumer warpgroups; K, V
// of a stage arrived; a stage released by both consumer warpgroups.
struct Bars {
  uint64_t q_full[2], q_empty[2];
  uint64_t k_full[kStages], v_full[kStages], empty[kStages];
};

// Item w of a launch: q tile i of head h of batch b, every head's last q
// tile first (flash_fwd_bf16_kernel's blocks, in its order), and its k
// tiles 0 .. nkt - 1; (prefix-LM mode) the prompt's length.
struct Item {
  int i, h, b, plen, nkt;
  __device__ Item(int w, int H, int Sq, int Sk, int causal,
                  const int* prefix_len, bool pfx) {
    const int nqt = (Sq + BQ - 1) / BQ, per_b = nqt * H;
    b = w / per_b;
    i = nqt - 1 - (w % per_b) / H;
    h = w % H;
    plen = pfx ? __ldg(prefix_len + b) : 0;
    nkt = (Sk + BK - 1) / BK;
    if (causal) nkt = min(nkt, i + 1);  // BQ == BK: tiles 0..i
    // prefix-LM mode: the prompt's k tiles too (p clamped for the
    // schedule)
    if (pfx) nkt = max(nkt, (min(max(plen, 0), Sk) + BK - 1) / BK);
  }
};

template <bool PFX>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_d64_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         bf16* __restrict__ o, float* __restrict__ lse,
                         int items, int H, int Hkv, int Sq, int Sk, int D,
                         float scale_log2, int causal,
                         const int* __restrict__ prefix_len) {
  using L = Layout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  auto sQ = [&](int n) { return hop::smem_u32(base) + (n & 1) * L::kQ; };
  auto sK = [&](int s) {
    return hop::smem_u32(base) + L::kStage0 + s * 2 * L::kKV;
  };
  auto sV = [&](int s) { return sK(s) + L::kKV; };
  Bars& bar = *reinterpret_cast<Bars*>(base + L::kBars);
  if (threadIdx.x == 0) {
    for (int n = 0; n < 2; ++n) {
      hop::mbar_init(&bar.q_full[n], 1);
      hop::mbar_init(&bar.q_empty[n], kConsumers);
    }
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&bar.k_full[s], 1);
      hop::mbar_init(&bar.v_full[s], 1);
      hop::mbar_init(&bar.empty[s], kConsumers);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: one thread loads each item's Q into the buffer the item
    // before last released, and keeps the ring full with the items' K
    // and V tiles; g counts the ring's tiles over all items
    hop::regs_dealloc<24>();
    if (threadIdx.x == kConsumers) {
      int g = 0;
      for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
        const Item it(w, H, Sq, Sk, causal, prefix_len, PFX);
        const int hk = it.h / (H / Hkv);
        if (n >= 2) hop::mbar_wait(&bar.q_empty[n & 1], (n / 2 - 1) & 1);
        hop::mbar_arrive_expect_tx(&bar.q_full[n & 1], L::kQ);
        hop::tma_load_3d(sQ(n), &tq, &bar.q_full[n & 1], 0, it.i * BQ,
                         it.b * H + it.h);
        for (int j = 0; j < it.nkt; ++j, ++g) {
          const int s = g % kStages;
          // the stage's previous tile, g - kStages, is released
          if (g >= kStages) {
            hop::mbar_wait(&bar.empty[s], (g / kStages - 1) & 1);
          }
          hop::mbar_arrive_expect_tx(&bar.k_full[s], L::kKV);
          hop::tma_load_3d(sK(s), &tk, &bar.k_full[s], 0, j * BK,
                           it.b * Hkv + hk);
          hop::mbar_arrive_expect_tx(&bar.v_full[s], L::kKV);
          hop::tma_load_3d(sV(s), &tv, &bar.v_full[s], 0, j * BK,
                           it.b * Hkv + hk);
        }
      }
    }
    return;
  }
  hop::regs_alloc<240>();

  // consumers: warpgroup wg owns q rows [64 wg, 64 wg + 64) of each item
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int quad = t % 4;
  const int r0 = wg * 64 + (t / 32) * 16 + (t % 32) / 4;  // row0 - i BQ

  float oacc[32];
  float m0, m1, l0, l1;  // running max (base 2), this thread's row sums
  float a0, a1;          // a softmax step's rescale factors
  float sacc[64];        // S of the tile, then its P
  uint32_t pa[8][4];     // P in bf16, the A fragments of P V

  // S = Q K^T of item n's q rows and the K tile in stage s
  auto issue_s = [&](int n, int s) {
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hop::wgmma_ss_m64n128k16<0>(
          sacc, hop::desc_sw128(sQ(n) + wg * 64 * 128 + kk * 32, 16, 1024),
          hop::desc_sw128(sK(s) + kk * 32, 16, 1024), kk > 0);
    }
    hop::wgmma_commit();
  };
  auto retire = [&](int first) {  // a P V's fragments, after its wait
    hop::fence_regs(oacc);
#pragma unroll
    for (int kk = first; kk < first + 4; ++kk) hop::fence_regs(pa[kk]);
  };

  int g = 0;  // the ring's tiles over all items
  for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
    const Item it(w, H, Sq, Sk, causal, prefix_len, PFX);
    const int q_lo = it.i * BQ + wg * 64;
    const int row0 = it.i * BQ + r0, row1 = row0 + 8;
#pragma unroll
    for (int x = 0; x < 32; ++x) oacc[x] = 0.f;
    m0 = m1 = -INFINITY;
    l0 = l1 = 0.f;

    // Tile j (ring tile g + j), whose S is in sacc; the last tile's
    // second P V may still run under its first softmax step. With NEXT,
    // tile j + 1's S is issued behind this tile's first P V and has
    // arrived when the tile ends, its second P V still running.
    auto tile = [&](int j, auto next) {
      constexpr bool NEXT = decltype(next)::value;
      const int s = (g + j) % kStages, phase = ((g + j) / kStages) & 1;
      // Only a tile that crosses the ragged end or this warpgroup's
      // diagonal (in prefix-LM mode: and is not wholly prompt keys)
      // masks, in a branch of its own: -inf where col >= Sk or col > row
      // (prefix-LM mode: and col >= p).
      const int k_lo = j * BK;
      if (k_lo + BK > Sk ||
          (causal && k_lo + BK - 1 > q_lo && !(PFX && k_lo + BK <= it.plen))) {
#pragma unroll
        for (int x = 0; x < 64; ++x) {
          const int col = k_lo + 8 * (x / 4) + 2 * quad + (x & 1);
          const int row = (x & 2) ? row1 : row0;
          if (col >= Sk || (causal && col > row && !(PFX && col < it.plen))) {
            sacc[x] = -INFINITY;
          }
        }
      }
      // the softmax state advances every 64 keys, two steps a tile
      softmax_step<0>(sacc, m0, m1, l0, l1, a0, a1, scale_log2);
      // the last tile's second P V (none before tile 0: the wait is
      // unconditional all the same, or ptxas serializes every wgmma)
      hop::wgmma_wait<0>();
      retire(4);
      if (j > 0) hop::mbar_arrive(&bar.empty[(g + j - 1) % kStages]);
      rescale<32>(oacc, a0, a1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hop::acc_to_a(sacc, kk, pa[kk]);
      hop::mbar_wait(&bar.v_full[s], phase);
      pv<64, 0>(oacc, pa, sV(s));
      softmax_step<1>(sacc, m0, m1, l0, l1, a0, a1, scale_log2);
#pragma unroll
      for (int kk = 4; kk < 8; ++kk) hop::acc_to_a(sacc, kk, pa[kk]);
      if constexpr (NEXT) {
        const int gn = g + j + 1;
        hop::mbar_wait(&bar.k_full[gn % kStages], (gn / kStages) & 1);
        issue_s(n, gn % kStages);
        hop::wgmma_wait<1>();  // the first P V
      } else {
        hop::wgmma_wait<0>();
      }
      retire(0);
      rescale<32>(oacc, a0, a1);
      pv<64, 1>(oacc, pa, sV(s));
      if constexpr (NEXT) {
        hop::wgmma_wait<1>();  // the next tile's S
        hop::fence_regs(sacc);
      }
    };

    // every item has a tile (the tensor maps refuse an empty sequence)
    hop::mbar_wait(&bar.q_full[n & 1], (n / 2) & 1);
    hop::mbar_wait(&bar.k_full[g % kStages], (g / kStages) & 1);
    issue_s(n, g % kStages);
    hop::wgmma_wait<0>();
    hop::fence_regs(sacc);
    for (int j = 0; j + 1 < it.nkt; ++j) tile(j, std::true_type());
    tile(it.nkt - 1, std::false_type());
    hop::wgmma_wait<0>();
    retire(4);
    hop::mbar_arrive(&bar.empty[(g + it.nkt - 1) % kStages]);
    hop::mbar_arrive(&bar.q_empty[n & 1]);  // every S of the item is done
    g += it.nkt;

#pragma unroll
    for (int lane = 1; lane <= 2; lane <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, lane);
      l1 += __shfl_xor_sync(0xffffffffu, l1, lane);
    }
    const float ls0 = l0 == 0.f ? 1.f : l0, ls1 = l1 == 0.f ? 1.f : l1;
    const float inv0 = 1.f / ls0, inv1 = 1.f / ls1;
    const size_t head_row = ((size_t)it.b * H + it.h) * Sq;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = 8 * c + 2 * quad;
      if (col < D) {
        if (row0 < Sq) {
          *reinterpret_cast<__nv_bfloat162*>(o + (head_row + row0) * D +
                                             col) =
              __floats2bfloat162_rn(oacc[4 * c] * inv0,
                                    oacc[4 * c + 1] * inv0);
        }
        if (row1 < Sq) {
          *reinterpret_cast<__nv_bfloat162*>(o + (head_row + row1) * D +
                                             col) =
              __floats2bfloat162_rn(oacc[4 * c + 2] * inv1,
                                    oacc[4 * c + 3] * inv1);
        }
      }
    }
    if (quad == 0) {  // lse in natural-log units; product and sum rounded
      // one by one, as flash_fwd_bf16_kernel's unsegmented lse is
      if (row0 < Sq) {
        lse[head_row + row0] = __fadd_rn(__fmul_rn(m0, kLn2), logf(ls0));
      }
      if (row1 < Sq) {
        lse[head_row + row1] = __fadd_rn(__fmul_rn(m1, kLn2), logf(ls1));
      }
    }
  }
}

template <bool PFX>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hkv, int Sq, int Sk, int D, float scale,
           int causal, void* stream, const int* prefix_len = nullptr) {
  // the row max is taken on unscaled scores: it needs scale > 0
  if (!(scale > 0.f)) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!hop::tensor_map(&tq, static_cast<const bf16*>(q), B * H, Sq, D, BQ) ||
      !hop::tensor_map(&tk, static_cast<const bf16*>(k), B * Hkv, Sk, D,
                       BK) ||
      !hop::tensor_map(&tv, static_cast<const bf16*>(v), B * Hkv, Sk, D,
                       BK)) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return (int)err;
  const int items = (Sq + BQ - 1) / BQ * H * B;
  return hop::launch(flash_fwd_d64_kernel<PFX>, dim3(min(items, sms)),
                     kThreads, Layout::kSmem, stream, tq, tk, tv,
                     static_cast<bf16*>(o), lse, items, H, Hkv, Sq, Sk, D,
                     scale * kLog2e, causal, prefix_len);
}

}  // namespace d64
}  // namespace fwd

template <bool SEG, bool PFX = false>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Hkv, int Sq, int Sk, int D,
                   float scale, int causal, void* stream,
                   const int* seg_q = nullptr, const int* seg_k = nullptr,
                   const int* prefix_len = nullptr) {
  const dim3 grid((Sq + Tile<float>::BQ - 1) / Tile<float>::BQ, H, B);
  return launch(flash_fwd_f32_kernel<SEG, PFX>, grid, fwd_smem_bytes(D, SEG),
                stream, static_cast<const float*>(q),
                static_cast<const float*>(k), static_cast<const float*>(v),
                static_cast<float*>(o), lse, H, Hkv, Sq, Sk, D, scale, causal,
                seg_q, seg_k, prefix_len);
}

}  // namespace dlr

extern "C" int dlr_flash_fwd_bf16(const void* q, const void* k,
                                  const void* v, void* o, float* lse, int B,
                                  int H, int Hkv, int Sq, int Sk, int D,
                                  float scale, int causal, void* stream) {
  return D <= 64
             ? dlr::fwd::d64::launch<false>(q, k, v, o, lse, B, H, Hkv, Sq,
                                            Sk, D, scale, causal, stream)
             : dlr::fwd::launch_bf16<128, false>(q, k, v, o, lse, B, H, Hkv,
                                                 Sq, Sk, D, scale, causal,
                                                 stream);
}

extern "C" int dlr_flash_fwd_f32(const void* q, const void* k, const void* v,
                                 void* o, float* lse, int B, int H, int Hkv,
                                 int Sq, int Sk, int D, float scale,
                                 int causal, void* stream) {
  return dlr::launch_fwd_f32<false>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, D,
                                    scale, causal, stream);
}

// segment-id mode: seg_q [B, Sq] and seg_k [B, Sk] int32, and their tile
// table seg_tiles [B, ceil(Sq / 64) + ceil(Sk / 64), 2] int32 (the f32
// kernel visits every tile and does not read it)
extern "C" int dlr_flash_fwd_seg_bf16(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      const int* seg_q, const int* seg_k,
                                      const int* seg_tiles, int B, int H,
                                      int Hkv, int Sq, int Sk, int D,
                                      float scale, int causal,
                                      void* stream) {
  return D <= 64
             ? dlr::fwd::launch_bf16<64, true>(q, k, v, o, lse, B, H, Hkv,
                                               Sq, Sk, D, scale, causal,
                                               stream, seg_q, seg_k, nullptr,
                                               seg_tiles)
             : dlr::fwd::launch_bf16<128, true>(q, k, v, o, lse, B, H, Hkv,
                                                Sq, Sk, D, scale, causal,
                                                stream, seg_q, seg_k, nullptr,
                                                seg_tiles);
}

extern "C" int dlr_flash_fwd_seg_f32(const void* q, const void* k,
                                     const void* v, void* o, float* lse,
                                     const int* seg_q, const int* seg_k,
                                     const int* seg_tiles, int B, int H,
                                     int Hkv, int Sq, int Sk, int D,
                                     float scale, int causal, void* stream) {
  (void)seg_tiles;
  return dlr::launch_fwd_f32<true>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, D,
                                   scale, causal, stream, seg_q, seg_k);
}

// prefix-LM mode: prefix_len [B] int32; always causal (the flag is
// ignored)
extern "C" int dlr_flash_fwd_pfx_bf16(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      const int* prefix_len, int B, int H,
                                      int Hkv, int Sq, int Sk, int D,
                                      float scale, int causal, void* stream) {
  (void)causal;
  return D <= 64
             ? dlr::fwd::d64::launch<true>(q, k, v, o, lse, B, H, Hkv, Sq,
                                           Sk, D, scale, 1, stream,
                                           prefix_len)
             : dlr::fwd::launch_bf16<128, false, true>(
                   q, k, v, o, lse, B, H, Hkv, Sq, Sk, D, scale, 1, stream,
                   nullptr, nullptr, prefix_len);
}

extern "C" int dlr_flash_fwd_pfx_f32(const void* q, const void* k,
                                     const void* v, void* o, float* lse,
                                     const int* prefix_len, int B, int H,
                                     int Hkv, int Sq, int Sk, int D,
                                     float scale, int causal, void* stream) {
  (void)causal;
  return dlr::launch_fwd_f32<false, true>(q, k, v, o, lse, B, H, Hkv, Sq, Sk,
                                          D, scale, 1, stream, nullptr,
                                          nullptr, prefix_len);
}

DLR_DEFINE_ERROR_STRING(dlr_flash_fwd_error)

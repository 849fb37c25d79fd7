// B2: flash-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces dlrover_tpu/ops/flash_attention.py::_flash_bwd_dkv_kernel
// (launched by _flash_backward): the probability tile is recomputed from
// the saved logsumexp, p = exp(q k^T * scale - lse), and
//   dV += p^T dO,   dS = p * (dO V^T - delta) * scale,   dK += dS^T Q,
// summed over the GQA group's query heads and the q tiles at or below
// the diagonal. delta = rowsum(dO * O) - dlse comes in precomputed.
//
// Bound on the H100: operations. Four products per visible (q, k) pair:
// 275 GFLOP at the main path's shape (H=32, H_kv=8, S=4096, D=128, bf16,
// causal), 0.278 ms at 989 TFLOP/s.
//
// The TPU grid (b, h_kv, j, g, i) keeps dK/dV in VMEM scratch while its
// two innermost dimensions run in order; CUDA blocks run in no order, so
// both of those dimensions become loops inside the block, and each dK/dV
// tile has a single writer: no atomics and no second pass.
//
// bf16 design (flash_bwd_dkv_bf16_kernel, on hopper_common.cuh): one
// block per (128-key tile, KV head, batch), 384 threads, one block an
// SM, the key tiles with the most causal work issued first (the heaviest
// block's steps equal the average load of an SM at the main shape). The
// scores are computed transposed, keys as the wgmma M dimension: two
// consumer warpgroups own 64 key rows each, with their K and V loaded
// once by TMA into 128-byte-swizzled shared memory, and dK, dV
// accumulating in registers for the whole block (setmaxnreg gives the
// consumers 240 registers a thread, the producer 24). Per 64-row q tile
// of the loop over (query head, q tile):
//   S^T = K Q^T, dP^T = V dO^T   wgmma SS m64n64k16, K-major operands;
//         dP^T is issued before P^T's exponentials and runs beside them;
//   P^T = exp2(S^T scale log2e - lse log2e), dS^T = P^T (dP^T - delta)
//         scale, in registers, lse and delta per column (a column is a
//         q row); only tiles crossing the diagonal or a ragged end mask,
//         and a warpgroup whose keys the q tile cannot see skips it;
//   dV += P^T dO, dK += dS^T Q   wgmma RS m64n{DP}k16: P^T and dS^T
//         rounded to bf16 in the accumulator layout are the A fragments
//         as they stand, dO and Q are read MN-major (transpose bit).
// A producer warp keeps TMA loads of Q, dO, lse and delta (3-D maps for
// the tiles, 1-D for the rows) in flight through a 2-stage mbarrier
// ring. The segment-id kernels run this design on a 64-wide head tile
// at head dims up to 64, every kernel on a 128-wide one above; columns
// past D read as zeros, which change none of the four products' stored
// parts.
//
// 64-wide head tile (flash_bwd_dkv_d64_kernel: head dims up to 64,
// unsegmented, causal, not causal or prefix-LM; GLM's main path). The
// blocks and products above, with the same sums in the same order, so
// the outputs are bit for bit the above design's at D <= 64. Measured by
// stages at GLM's shape (PERF.md), the time there went on neither
// the exponentials nor the ring's waits: a step's scores and gradients
// cost more than their products, and the work around them most. So:
//   - 128 q rows a step: S^T and dP^T are m64n128k16 SS products (half
//     the shared-memory reads a flop of m64n64, half the steps, waits
//     and lse/delta boxes), dV and dK eight m64n64k16 RS k16 steps in
//     the q-row order two 64-row steps take; the accumulators fit
//     (64 + 64 + 32 + 32 of 240 registers);
//   - the diagonal and prompt masks are a branch of their own that only
//     a step crossing them takes (per element, they had cost every step
//     a branch for each score);
//   - 4 ring stages of Q, dO, lse and delta.
// (Warpgroup turns, which B3 takes, measured no faster here.)
//
// f32 (the parity path, flash_bwd_dkv_kernel<float>): 32x32 tiles staged
// in shared memory, scalar FMA products (flash_common.cuh); the probability
// and dS tiles are written over the f32 S/dP tiles they come from (after
// a barrier), which keeps it inside the shared-memory limit.
//
// Segment-id mode (packed documents; the reference's _recompute_p with
// seg_q and seg_k, flash_attention.py:550-557): a separate instantiation
// of each kernel (SEG = true, entry points dlr_flash_bwd_dkv_seg_*) takes
// int32 ids seg_q [B, Sq] and seg_k [B, Sk] and sets p = 0 where a q
// row's id differs from the key's, on top of the causal mask; the SEG =
// false kernels are unchanged. The bf16 kernel also takes the ids' tile
// table seg_tiles [B, ceil(Sq / 64) + ceil(Sk / 64), 2]: the [min, max]
// id of each 64-id tile, q side then k side, built on the device once a
// layer's forward (flash_attention.py's segment_tiles), where B1 walks it
// first, and kept for the backward. Before the role split
// one warp lists in shared memory the block's q tiles (i0 .. nqt, after
// the causal cut) whose [min, max] meets that of one of its two 64-key
// halves, each with a bit for each warpgroup whose half it meets; the
// producer and both consumer warpgroups walk that list, group x count
// steps, so the mbarrier phases stay in step, and a warpgroup whose bit
// is clear skips the step as the causal skip does. The test never drops
// a tile that holds a same-id pair, for any ids, and on sorted ids lists
// exactly those tiles. A block whose list is empty (pair-form keys no row
// shares an id with) loads K and V, runs no step and stores dK = dV = 0.
// With the scores transposed, seg_k indexes the accumulator's rows and
// seg_q its columns. On a listed step, as in B1 (flash_fwd.cu), one
// producer warp stages the ids in shared memory with per-64 "one value"
// flags, the block's 128 k ids once and each step's 64 q ids beside its
// tiles, and a consumer warpgroup masks the step not at all by segment,
// whole (every p = exp2(-inf) through the lse it subtracts), or, where
// ids change inside it, by a warp-uniform pass that sets S^T to -inf
// apart from the unsegmented mask. Ids need not be sorted. The f32
// kernel visits every causal tile, stages the ids beside its tiles and
// ignores the table. A row that saw no key has lse = NEG_INF from the
// forward; the lse is clamped to 0 first, as the reference does, so
// every p of that row stays exactly 0.
//
// Prefix-LM mode (GLM's mask; the reference's _recompute_p with
// prefix_len, flash_attention.py:594-597): a third instantiation of each
// kernel (PFX = true, entry points dlr_flash_bwd_dkv_pfx_*, always
// causal) takes int32 prefix_len [B]; key j is visible to q row i iff j
// <= i or j < p. Each thread reads p at the block's start, where the
// schedule is fixed before the first barrier (as in the other
// instantiations, whose code stays as it was: a read through shared
// memory after the barrier moved it), and the producer and consumers
// start the q-tile loop at 0 when the key tile holds prompt keys (j BK <
// p, p clamped to [0, Sk] for the schedule only), at the diagonal
// otherwise. A warpgroup whose 64 keys are all prompt keys masks no
// step; one that crosses the diagonal and the end of the prompt masks by
// element (p = 0 where key > row and key >= p), inside the unsegmented
// mask's warp-uniform branch, the mode's terms compiled away in the
// other instantiations. Every row sees key 0,
// so lse is finite and a masked p is exactly 0. The heaviest-first order
// of the key tiles is the causal one: prompt key tiles now carry every q
// tile, and they come first all the same.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace dlr {

template <typename T>
size_t dkv_smem_bytes(int D, bool seg) {
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK, PAD = Tile<T>::PAD;
  const int ldt = D + PAD;
  return 2 * round128(sizeof(T) * BK * ldt)                 // K, V
         + 2 * round128(sizeof(T) * BQ * ldt)               // Q, dO
         + 2 * round128(sizeof(float) * BQ * (BK + kFPad))  // S|P, dP|dS
         + 2 * round128(sizeof(float) * BK * (D + kFPad))   // dK, dV acc
         + 2 * round128(sizeof(float) * BQ)                 // lse, delta
         + (seg ? round128(sizeof(int) * BK) + round128(sizeof(int) * BQ)
                : 0);  // segment ids of the keys and of the q tile
}

template <typename T, bool SEG, bool PFX>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int Hkv, int Sq, int Sk,
                         int D, float scale, int causal,
                         const int* __restrict__ seg_q,
                         const int* __restrict__ seg_k,
                         const int* __restrict__ prefix_len) {
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK, PAD = Tile<T>::PAD;
  constexpr int ELEMS = BQ * BK / kThreads;  // S elements per thread
  const int ldt = D + PAD, lds = BK + kFPad, ldp = BK + PAD, lda = D + kFPad;

  const int j = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;

  extern __shared__ __align__(128) unsigned char smem[];
  SmemCarve carve{smem};
  T* sK = carve.take<T>(BK * ldt);
  T* sV = carve.take<T>(BK * ldt);
  T* sQ = carve.take<T>(BQ * ldt);
  T* sdO = carve.take<T>(BQ * ldt);
  float* sS = carve.take<float>(BQ * lds);
  float* sdP = carve.take<float>(BQ * lds);
  float* sdK = carve.take<float>(BK * lda);
  float* sdV = carve.take<float>(BK * lda);
  float* sLse = carve.take<float>(BQ);
  float* sDelta = carve.take<float>(BQ);
  int* sSegK = SEG ? carve.take<int>(BK) : nullptr;
  int* sSegQ = SEG ? carve.take<int>(BQ) : nullptr;
  // P and dS in the input type, over the f32 tiles they are made from
  T* sP = reinterpret_cast<T*>(sS);
  T* sdS = reinterpret_cast<T*>(sdP);

  const size_t kv_row0 = ((size_t)b * Hkv + hk) * Sk + (size_t)j * BK;
  const int kvalid = min(BK, Sk - j * BK);
  load_tile(sK, ldt, k + kv_row0 * D, kvalid, BK, D);
  load_tile(sV, ldt, v + kv_row0 * D, kvalid, BK, D);
  zero_f32(sdK, lda, BK, D);
  zero_f32(sdV, lda, BK, D);
  if constexpr (SEG) {
    for (int t = threadIdx.x; t < BK; t += blockDim.x) {
      sSegK[t] = t < kvalid ? seg_k[(size_t)b * Sk + j * BK + t] : 0;
    }
  }

  const int nqt = (Sq + BQ - 1) / BQ;
  // q tiles strictly above this k tile's diagonal see none of its keys,
  // unless (prefix-LM mode) it holds prompt keys
  const int plen = PFX ? prefix_len[b] : 0;
  const int i0 = causal && !(PFX && j * BK < min(max(plen, 0), Sk))
                     ? (j * BK) / BQ
                     : 0;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int i = i0; i < nqt; ++i) {
      __syncthreads();  // the previous tile's readers are done
      const size_t q_row0 = ((size_t)b * H + h) * Sq + (size_t)i * BQ;
      const int qvalid = min(BQ, Sq - i * BQ);
      load_tile(sQ, ldt, q + q_row0 * D, qvalid, BQ, D);
      load_tile(sdO, ldt, dout + q_row0 * D, qvalid, BQ, D);
      load_rows(sLse, lse + q_row0, qvalid, BQ);
      load_rows(sDelta, delta + q_row0, qvalid, BQ);
      if constexpr (SEG) {
        for (int t = threadIdx.x; t < BQ; t += blockDim.x) {
          sSegQ[t] = t < qvalid ? seg_q[(size_t)b * Sq + i * BQ + t] : 0;
        }
      }
      __syncthreads();
      tile_mma<false, true>(sQ, ldt, sK, ldt, sS, lds, BQ, BK, D, false);
      tile_mma<false, true>(sdO, ldt, sV, ldt, sdP, lds, BQ, BK, D, false);
      __syncthreads();

      float p[ELEMS], ds[ELEMS];
#pragma unroll
      for (int e = 0; e < ELEMS; ++e) {
        const int idx = threadIdx.x + e * kThreads;
        const int r = idx / BK, c = idx % BK;
        const int row = i * BQ + r, col = j * BK + c;
        const bool ok = row < Sq && col < Sk &&
                        (!causal || col <= row || (PFX && col < plen)) &&
                        (!SEG || sSegQ[r] == sSegK[c]);
        // segment-id mode: a row that saw no key has lse NEG_INF
        const float l =
            SEG && sLse[r] <= kNegInf * 0.5f ? 0.f : sLse[r];
        p[e] = ok ? expf(sS[r * lds + c] * scale - l) : 0.f;
        ds[e] = p[e] * (sdP[r * lds + c] - sDelta[r]) * scale;
      }
      __syncthreads();  // every f32 S/dP read lands before the overwrite
#pragma unroll
      for (int e = 0; e < ELEMS; ++e) {
        const int idx = threadIdx.x + e * kThreads;
        const int r = idx / BK, c = idx % BK;
        sP[r * ldp + c] = from_f<T>(p[e]);
        sdS[r * ldp + c] = from_f<T>(ds[e]);
      }
      __syncthreads();
      tile_mma<true, false>(sP, ldp, sdO, ldt, sdV, lda, BK, D, BQ, true);
      tile_mma<true, false>(sdS, ldp, sQ, ldt, sdK, lda, BK, D, BQ, true);
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < kvalid * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D;
    dk[(kv_row0 + r) * D + d] = from_f<T>(sdK[r * lda + d]);
    dv[(kv_row0 + r) * D + d] = from_f<T>(sdV[r * lda + d]);
  }
}

template <typename T, bool SEG, bool PFX = false>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int H, int Hkv, int Sq, int Sk, int D, float scale,
               int causal, void* stream, const int* seg_q = nullptr,
               const int* seg_k = nullptr, const int* prefix_len = nullptr) {
  const dim3 grid((Sk + Tile<T>::BK - 1) / Tile<T>::BK, Hkv, B);
  return launch(flash_bwd_dkv_kernel<T, SEG, PFX>, grid,
                dkv_smem_bytes<T>(D, SEG), stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk),
                static_cast<T*>(dv), H, Hkv, Sq, Sk, D, scale, causal, seg_q,
                seg_k, prefix_len);
}


// -- bf16 --------------------------------------------------------------------

namespace dkv {

using bf16 = __nv_bfloat16;
constexpr int BK = 128;  // keys a block: two consumer warpgroups of 64
constexpr int BQ = 64;   // q rows a step
constexpr int kStages = 2;
constexpr int kConsumers = 256;  // threads of the two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory at head-dim tile DP (64 or 128): K and V (DP / 64 SW128
// column blocks of BK rows each), kStages x (Q, dO) tiles (DP / 64
// column blocks of BQ rows), kStages x (lse, delta) rows, the mbarriers.
// A row box starts at the 16-byte boundary at or before the tile's first
// row (TMA's alignment), so it holds BQ + 4 values.
constexpr int kRowBox = BQ + 4;
template <int DP>
struct Layout {
  static constexpr uint32_t kKV = BK * DP * 2;  // K or V
  static constexpr uint32_t kQ = BQ * DP * 2;   // one Q or dO tile
  static constexpr uint32_t kRow = 384;  // one lse or delta box, aligned
  static constexpr uint32_t kStage0 = 2 * kKV;
  static constexpr uint32_t kRows = kStage0 + kStages * 2 * kQ;
  static constexpr uint32_t kBars = kRows + kStages * 2 * kRow;
  static constexpr uint32_t kStageTx = 2 * kQ + 2 * kRowBox * 4;
  static constexpr size_t kSmem = kBars + 128 + 1024;  // + align slack
  // segment-id mode, after the mbarriers: the block's k ids and their
  // flags (hop::seg_publish), then a stage's q ids and flags each
  static constexpr uint32_t kIds = kBars + 128;
  static constexpr int kKIds = BK + 8, kQIds = BQ + 8;  // ints
  static constexpr size_t kIdBytes = (kKIds + kStages * kQIds) * 4;
  // then the block's list of steps, one int a q tile
  static constexpr uint32_t kList = kIds + kIdBytes;
};

// The mbarriers: K and V arrived; a stage's Q, dO, lse and delta
// arrived; a stage released by both consumer warpgroups; (segment-id
// mode) a stage's q ids written. Then (segment-id mode) the length of the
// block's list of q tiles.
struct Bars {
  uint64_t kv_full, full[kStages], empty[kStages];
  uint64_t ids_full[kStages];
  int count;
};

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][N]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hop::fence_regs(a[kk]);
}

// Issue acc = A B^T over DP / 16 k16 steps: A this warpgroup's 64 rows
// of a BK-row tile (K or V), B a BQ-row tile (Q or dO), both K-major.
template <int DP>
__device__ __forceinline__ void scores(float (&acc)[32], uint32_t sA,
                                       uint32_t sB) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t a = (kk / 4) * BK * 128 + (kk % 4) * 32;
    const uint32_t b = (kk / 4) * BQ * 128 + (kk % 4) * 32;
    hop::wgmma_ss_m64n64k16<0>(acc, hop::desc_sw128(sA + a, 16, 1024),
                               hop::desc_sw128(sB + b, 16, 1024), kk > 0);
  }
}

// Issue acc += A B over the tile's 64 q rows: A in bf16 from registers
// (four k16 fragments), B a [BQ][DP] tile (dO or Q) read MN-major.
template <int DP>
__device__ __forceinline__ void grads(float (&acc)[DP / 2],
                                      const uint32_t (&a)[4][4],
                                      uint32_t sB) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t b = hop::desc_sw128(sB + kk * 16 * 128, BQ * 128, 1024);
    if constexpr (DP == 128) {
      hop::wgmma_rs_m64n128k16<1>(acc, a[kk], b, 1);
    } else {
      hop::wgmma_rs_m64n64k16<1>(acc, a[kk], b, 1);
    }
  }
}

template <int DP, bool SEG, bool PFX>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tlse,
                              const __grid_constant__ CUtensorMap tdelta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int B, int H, int Hkv, int Sq, int Sk, int D,
                              float scale, float scale_log2, int causal,
                              const int* __restrict__ seg_q,
                              const int* __restrict__ seg_k,
                              const int* __restrict__ prefix_len,
                              const int* __restrict__ seg_tiles) {
  using L = Layout<DP>;
  constexpr int NA = DP / 2;  // dK or dV accumulator registers a thread
  // every head's first key tiles (the most causal work) first
  const int j = blockIdx.x / (B * Hkv), bh = blockIdx.x % (B * Hkv);
  const int b = bh / Hkv, hk = bh % Hkv;
  const int group = H / Hkv;
  const int nqt = (Sq + BQ - 1) / BQ;
  // prefix-LM mode: the prompt's length, read at the block's start
  const int plen = PFX ? prefix_len[b] : 0;
  // q tiles strictly above this key tile's diagonal see none of its keys,
  // unless (prefix-LM mode) it holds prompt keys
  const int i0 = causal && !(PFX && j * BK < min(max(plen, 0), Sk))
                     ? j * BK / BQ
                     : 0;
  int per_head = max(nqt - i0, 0);  // segment-id mode: the list's length
  int steps = group * per_head;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sK = hop::smem_u32(base), sV = sK + L::kKV;
  auto sQ = [&](int s) { return sK + L::kStage0 + s * 2 * L::kQ; };
  auto sdO = [&](int s) { return sQ(s) + L::kQ; };
  auto sLse = [&](int s) {
    return reinterpret_cast<const float*>(base + L::kRows + s * 2 * L::kRow);
  };
  auto sDelta = [&](int s) { return sLse(s) + L::kRow / 4; };
  // segment-id mode: the listed q tiles, q tile * 4 + a bit for each
  // warpgroup whose keys the tile's ids can meet
  int* list = reinterpret_cast<int*>(base + L::kList);
  // the q tile of step t
  auto q_tile = [&](int t) {
    if constexpr (SEG) {
      return list[t % per_head] >> 2;
    } else {
      return i0 + t % per_head;
    }
  };
  // the first row of step t's q tile in the [B H Sq] rows of lse, delta
  auto first_row = [&](int t) {
    return (b * H + hk * group + t / per_head) * Sq + q_tile(t) * BQ;
  };
  Bars& bar = *reinterpret_cast<Bars*>(base + L::kBars);
  // segment-id mode: the k ids and flags, then stage s's q ids and flags
  int* sid = reinterpret_cast<int*>(base + L::kIds);
  auto qids = [&](int s) { return sid + L::kKIds + s * L::kQIds; };
  if (threadIdx.x == 0) {
    hop::mbar_init(&bar.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&bar.full[s], 1);
      hop::mbar_init(&bar.empty[s], kConsumers);
      if constexpr (SEG) hop::mbar_init(&bar.ids_full[s], 32);
    }
    hop::mbar_fence_init();
  }
  if constexpr (SEG) {
    // one warp lists the q tiles i0 .. nqt whose ids can meet this key
    // tile's: by the [min, max] ids of its two 64-key halves (warpgroup
    // w's keys) and of each 64-row q tile
    if (threadIdx.x < 32) {
      const int nk = (Sk + 63) / 64;
      const int* tab_q = seg_tiles + (size_t)b * (nqt + nk) * 2;
      const int* tab_k = tab_q + nqt * 2;
      int lo[2], hi[2];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const int kt = min(2 * j + w, nk - 1);
        lo[w] = __ldg(tab_k + 2 * kt);
        hi[w] = __ldg(tab_k + 2 * kt + 1);
      }
      const int n = hop::seg_compact(list, i0, nqt, threadIdx.x, [&](int i) {
        int m = 0;
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const int kt = 2 * j + w;
          if (kt < nk && !(causal && kt > i) &&
              hop::seg_meets(tab_q + 2 * i, lo[w], hi[w])) {
            m |= 1 << w;
          }
        }
        return m;
      });
      if (threadIdx.x == 0) bar.count = n;
    }
  }
  __syncthreads();
  if constexpr (SEG) {
    per_head = bar.count;
    steps = group * per_head;
  }

  if (threadIdx.x >= kConsumers) {
    // producer: one thread loads K and V once, then keeps the ring full
    // with step t's Q and dO tiles and lse and delta rows; in segment-id
    // mode its warp writes the ids
    hop::regs_dealloc<24>();
    const int pt = threadIdx.x - kConsumers;
    if constexpr (SEG) {  // announced with step 0's q ids; a key past
      // Sk (masked) takes the last key's id
      if (pt < 32) {
        int v[BK / 32];
        hop::seg_load(v, seg_k + (size_t)b * Sk, j * BK, Sk - 1, pt);
        hop::seg_publish(sid, sid + BK, pt, v);
      }
    }
    if (SEG ? pt < 32 : pt == 0) {
      if (pt == 0) {
        hop::mbar_arrive_expect_tx(&bar.kv_full, 2 * L::kKV);
        for (int c = 0; c < DP / 64; ++c) {
          hop::tma_load_3d(sK + c * BK * 128, &tk, &bar.kv_full, c * 64,
                           j * BK, bh);
          hop::tma_load_3d(sV + c * BK * 128, &tv, &bar.kv_full, c * 64,
                           j * BK, bh);
        }
      }
      for (int t = 0; t < steps; ++t) {
        const int s = t % kStages;
        const int h = hk * group + t / per_head, i = q_tile(t);
        int v[BQ / 32];  // segment-id mode: the step's q ids
        if constexpr (SEG) {
          hop::seg_load(v, seg_q + (size_t)b * Sq, i * BQ, Sq - 1, pt);
        }
        // the stage's previous tile, t - kStages, is released
        if (t >= kStages) hop::mbar_wait(&bar.empty[s], (t / kStages - 1) & 1);
        if (pt == 0) {
          hop::mbar_arrive_expect_tx(&bar.full[s], L::kStageTx);
          for (int c = 0; c < DP / 64; ++c) {
            hop::tma_load_3d(sQ(s) + c * BQ * 128, &tq, &bar.full[s], c * 64,
                             i * BQ, b * H + h);
            hop::tma_load_3d(sdO(s) + c * BQ * 128, &tdo, &bar.full[s],
                             c * 64, i * BQ, b * H + h);
          }
          // 1-D rows: a ragged tile reads the next head's values (masked)
          // or, past the end, zeros
          const int row = first_row(t) & ~3;
          hop::tma_load_1d(hop::smem_u32(sLse(s)), &tlse, &bar.full[s], row);
          hop::tma_load_1d(hop::smem_u32(sDelta(s)), &tdelta, &bar.full[s],
                           row);
        }
        if constexpr (SEG) {  // a row past Sq took the last row's id
          hop::seg_publish(qids(s), qids(s) + BQ, pt, v);
          hop::mbar_arrive(&bar.ids_full[s]);
        }
      }
    }
    return;
  }
  hop::regs_alloc<240>();

  // consumers: warpgroup wg owns key rows [64 wg, 64 wg + 64) of the tile
  const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128;
  const int quad = t128 % 4;
  const int k_lo = j * BK + wg * 64;
  const int kr0 = k_lo + (t128 / 32) * 16 + (t128 % 32) / 4;
  const int kr1 = kr0 + 8;
  const uint32_t sKw = sK + wg * 64 * 128, sVw = sV + wg * 64 * 128;

  float dkacc[NA], dvacc[NA];
#pragma unroll
  for (int x = 0; x < NA; ++x) dkacc[x] = dvacc[x] = 0.f;

  hop::mbar_wait(&bar.kv_full, 0);
  for (int t = 0; t < steps; ++t) {
    const int s = t % kStages, phase = (t / kStages) & 1;
    const int q_lo = q_tile(t) * BQ;
    hop::mbar_wait(&bar.full[s], phase);
    // keys all past Sk, or all above this q tile's diagonal (and, in
    // prefix-LM mode, past the prompt): nothing to add
    if constexpr (PFX) {
      if (k_lo >= Sk || (k_lo > q_lo + BQ - 1 && k_lo >= plen)) {
        hop::mbar_arrive(&bar.empty[s]);
        continue;
      }
    } else if (k_lo >= Sk || (causal && k_lo > q_lo + BQ - 1)) {
      hop::mbar_arrive(&bar.empty[s]);
      continue;
    }
    // segment-id mode: the step's ids can meet none of this warpgroup's
    // keys (its tile was listed for the other's)
    if constexpr (SEG) {
      if (!((list[t % per_head] >> wg) & 1)) {
        hop::mbar_arrive(&bar.empty[s]);
        continue;
      }
    }

    // segment-id mode: how this warpgroup's keys and the step's q rows
    // mask (hop::SegMode), read before the products, while their
    // accumulators are not yet live
    int seg = hop::kSegNone;
    if constexpr (SEG) {
      hop::mbar_wait(&bar.ids_full[s], phase);
      seg = hop::seg_mode(qids(s) + BQ, 0, 2, sid + BK, wg, 1);
    }

    // S^T = K Q^T, then dP^T = V dO^T: the tensor cores work on dP^T
    // while P^T's exponentials are computed
    float sacc[32], dpacc[32];
    hop::wgmma_fence();
    scores<DP>(sacc, sKw, sQ(s));
    hop::wgmma_commit();
    scores<DP>(dpacc, sVw, sdO(s));
    hop::wgmma_commit();
    hop::wgmma_wait<1>();
    hop::fence_regs(sacc);

    // segment-id mode: scores where ids differ masked to -inf, in a
    // warp-uniform branch apart from the unsegmented mask below
    if (seg == hop::kSegById) {
      const int* qid = qids(s);
      const int kid0 = sid[kr0 - j * BK], kid1 = sid[kr1 - j * BK];
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int qc = 8 * (x / 4) + 2 * quad + (x & 1);
        if (qid[qc] != ((x & 2) ? kid1 : kid0)) sacc[x] = -INFINITY;
      }
    }

    // P^T, over S^T's registers; a column is the q row
    // q_lo + 8 c + 2 quad + (x & 1), a row the key kr0 or kr1
    // (prefix-LM mode: keys all inside the prompt need no mask)
    const bool mask =
        (causal && k_lo + 63 > q_lo && !(PFX && k_lo + 64 <= plen)) ||
        q_lo + BQ > Sq || k_lo + 64 > Sk;
    const int off = first_row(t) & 3;  // the tile's first row in the box
    const float* lse = sLse(s) + off + 2 * quad;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float l0 = lse[8 * c], l1 = lse[8 * c + 1];
      if constexpr (SEG) {  // a row that saw no key has lse NEG_INF
        if (l0 <= kNegInf * 0.5f) l0 = 0.f;
        if (l1 <= kNegInf * 0.5f) l1 = 0.f;
      }
      l0 *= kLog2e;
      l1 *= kLog2e;
      if (seg == hop::kSegAll) l0 = l1 = INFINITY;  // every p = exp2(-inf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * c + e;
        float p = hop::ex2(fmaf(sacc[x], scale_log2, (e & 1) ? -l1 : -l0));
        if (mask) {
          const int qc = q_lo + 8 * c + 2 * quad + (e & 1);
          const int kr = (e & 2) ? kr1 : kr0;
          if (kr >= Sk || qc >= Sq ||
              (causal && kr > qc && !(PFX && kr < plen))) {
            p = 0.f;
          }
        }
        sacc[x] = p;
      }
    }

    // dV += P^T dO: P^T in bf16 from registers, dO [q][DP] MN-major
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hop::acc_to_a(sacc, kk, pa[kk]);
    hop::wgmma_fence();
    hop::fence_regs(dvacc);
    grads<DP>(dvacc, pa, sdO(s));
    hop::wgmma_commit();
    hop::wgmma_wait<1>();  // dP^T is done; dV may still run
    hop::fence_regs(dpacc);

    // dS^T = P^T (dP^T - delta) scale, over dP^T's registers
    const float* delta = sDelta(s) + off + 2 * quad;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float d0 = delta[8 * c], d1 = delta[8 * c + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * c + e;
        dpacc[x] = sacc[x] * (dpacc[x] - ((e & 1) ? d1 : d0)) * scale;
      }
    }

    // dK += dS^T Q: Q [q][DP] MN-major
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hop::acc_to_a(dpacc, kk, da[kk]);
    hop::wgmma_fence();
    hop::fence_regs(dkacc);
    grads<DP>(dkacc, da, sQ(s));
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(dvacc);
    hop::fence_regs(dkacc);
    fence_frags(pa);
    fence_frags(da);
    hop::mbar_arrive(&bar.empty[s]);  // this thread is done with stage s
  }

  // dK, dV in bf16 straight from the accumulators
  const size_t head_row = (size_t)bh * Sk;
#pragma unroll
  for (int c = 0; c < NA / 4; ++c) {
    const int col = 8 * c + 2 * quad;
    if (col < D) {
      if (kr0 < Sk) {
        const size_t at = (head_row + kr0) * D + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(dkacc[4 * c], dkacc[4 * c + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dvacc[4 * c], dvacc[4 * c + 1]);
      }
      if (kr1 < Sk) {
        const size_t at = (head_row + kr1) * D + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(dkacc[4 * c + 2], dkacc[4 * c + 3]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dvacc[4 * c + 2], dvacc[4 * c + 3]);
      }
    }
  }
}

template <int DP, bool SEG, bool PFX = false>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk,
                int D, float scale, int causal, void* stream,
                const int* seg_q = nullptr, const int* seg_k = nullptr,
                const int* prefix_len = nullptr,
                const int* seg_tiles = nullptr) {
  CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  const size_t rows = (size_t)B * H * Sq;
  if (!hop::tensor_map(&tq, static_cast<const bf16*>(q), B * H, Sq, D, BQ) ||
      !hop::tensor_map(&tk, static_cast<const bf16*>(k), B * Hkv, Sk, D,
                       BK) ||
      !hop::tensor_map(&tv, static_cast<const bf16*>(v), B * Hkv, Sk, D,
                       BK) ||
      !hop::tensor_map(&tdo, static_cast<const bf16*>(dout), B * H, Sq, D,
                       BQ) ||
      !hop::tensor_map_1d(&tlse, lse, rows, kRowBox) ||
      !hop::tensor_map_1d(&tdelta, delta, rows, kRowBox)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((Sk + BK - 1) / BK * B * Hkv);
  // segment-id mode: the ids, then the list (one int a q tile)
  const size_t smem =
      Layout<DP>::kSmem +
      (SEG ? Layout<DP>::kIdBytes + (Sq + BQ - 1) / BQ * sizeof(int) : 0);
  return hop::launch(flash_bwd_dkv_bf16_kernel<DP, SEG, PFX>, grid, kThreads,
                     smem, stream, tq, tk, tv, tdo, tlse, tdelta,
                     static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, H,
                     Hkv, Sq, Sk, D, scale, scale * kLog2e, causal, seg_q,
                     seg_k, prefix_len, seg_tiles);
}

// -- bf16, 64-wide head tile ----------------------------------------------
//
// The unsegmented kernels at head dims up to 64 (header: "64-wide head
// tile"): 128 q rows a step, the masks in a branch of their own, a
// 4-stage ring.
namespace d64 {

constexpr int BQ = 128;  // q rows a step
constexpr int kStages = 4;
constexpr int kRowBox = BQ + 4;  // a row box, from the 16-byte boundary

struct Layout {
  static constexpr uint32_t kKV = BK * 64 * 2;  // K or V
  static constexpr uint32_t kQ = BQ * 64 * 2;   // one Q or dO tile
  static constexpr uint32_t kRow = 640;  // one lse or delta box, aligned
  static constexpr uint32_t kStage0 = 2 * kKV;
  static constexpr uint32_t kRows = kStage0 + kStages * 2 * kQ;
  static constexpr uint32_t kBars = kRows + kStages * 2 * kRow;
  static constexpr uint32_t kStageTx = 2 * kQ + 2 * kRowBox * 4;
  static constexpr size_t kSmem = kBars + 128 + 1024;  // + align slack
};

// K and V arrived; a stage's Q, dO, lse and delta arrived; a stage
// released by both consumer warpgroups.
struct Bars {
  uint64_t kv_full, full[kStages], empty[kStages];
};

// Issue acc = A B^T over 4 k16 steps: A this warpgroup's 64 rows of K or
// V, B the step's 128-row Q or dO tile, both K-major.
__device__ __forceinline__ void scores(float (&acc)[BQ / 2], uint32_t sA,
                                       uint32_t sB) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    hop::wgmma_ss_m64n128k16<0>(acc, hop::desc_sw128(sA + kk * 32, 16, 1024),
                                hop::desc_sw128(sB + kk * 32, 16, 1024),
                                kk > 0);
  }
}

// Issue acc += A B over the step's 128 q rows, 16 at a time in order (the
// order two 64-row steps take): A in bf16 from registers (eight k16
// fragments), B the [BQ][64] dO or Q tile read MN-major.
__device__ __forceinline__ void grads(float (&acc)[32],
                                      const uint32_t (&a)[BQ / 16][4],
                                      uint32_t sB) {
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) {
    hop::wgmma_rs_m64n64k16<1>(
        acc, a[kk], hop::desc_sw128(sB + kk * 16 * 128, BQ * 128, 1024), 1);
  }
}

template <bool PFX>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_d64_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tlse,
                             const __grid_constant__ CUtensorMap tdelta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             int B, int H, int Hkv, int Sq, int Sk, int D,
                             float scale, float scale_log2, int causal,
                             const int* __restrict__ prefix_len) {
  using L = Layout;
  // every head's first key tiles (the most causal work) first
  const int j = blockIdx.x / (B * Hkv), bh = blockIdx.x % (B * Hkv);
  const int b = bh / Hkv, hk = bh % Hkv;
  const int group = H / Hkv;
  const int nqt = (Sq + BQ - 1) / BQ;
  // prefix-LM mode: the prompt's length
  const int plen = PFX ? prefix_len[b] : 0;
  // steps strictly above this key tile's diagonal see none of its keys,
  // unless (prefix-LM mode) it holds prompt keys
  const int i0 = causal && !(PFX && j * BK < min(max(plen, 0), Sk))
                     ? j * BK / BQ
                     : 0;
  const int per_head = max(nqt - i0, 0);
  const int steps = group * per_head;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sK = hop::smem_u32(base), sV = sK + L::kKV;
  auto sQ = [&](int s) { return sK + L::kStage0 + s * 2 * L::kQ; };
  auto sdO = [&](int s) { return sQ(s) + L::kQ; };
  auto sLse = [&](int s) {
    return reinterpret_cast<const float*>(base + L::kRows + s * 2 * L::kRow);
  };
  auto sDelta = [&](int s) { return sLse(s) + L::kRow / 4; };
  // the first row of step t's q rows in the [B H Sq] rows of lse, delta
  auto first_row = [&](int t) {
    return (b * H + hk * group + t / per_head) * Sq +
           (i0 + t % per_head) * BQ;
  };
  Bars& bar = *reinterpret_cast<Bars*>(base + L::kBars);
  if (threadIdx.x == 0) {
    hop::mbar_init(&bar.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&bar.full[s], 1);
      hop::mbar_init(&bar.empty[s], kConsumers);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: one thread loads K and V once, then keeps the ring full
    // with step t's Q and dO tiles and lse and delta rows
    hop::regs_dealloc<24>();
    if (threadIdx.x == kConsumers) {
      hop::mbar_arrive_expect_tx(&bar.kv_full, 2 * L::kKV);
      hop::tma_load_3d(sK, &tk, &bar.kv_full, 0, j * BK, bh);
      hop::tma_load_3d(sV, &tv, &bar.kv_full, 0, j * BK, bh);
      for (int t = 0; t < steps; ++t) {
        const int s = t % kStages;
        const int h = hk * group + t / per_head, i = i0 + t % per_head;
        // the stage's previous tile, t - kStages, is released
        if (t >= kStages) hop::mbar_wait(&bar.empty[s], (t / kStages - 1) & 1);
        hop::mbar_arrive_expect_tx(&bar.full[s], L::kStageTx);
        hop::tma_load_3d(sQ(s), &tq, &bar.full[s], 0, i * BQ, b * H + h);
        hop::tma_load_3d(sdO(s), &tdo, &bar.full[s], 0, i * BQ, b * H + h);
        // 1-D rows: a ragged step reads the next head's values (masked)
        // or, past the end, zeros
        const int row = first_row(t) & ~3;
        hop::tma_load_1d(hop::smem_u32(sLse(s)), &tlse, &bar.full[s], row);
        hop::tma_load_1d(hop::smem_u32(sDelta(s)), &tdelta, &bar.full[s],
                         row);
      }
    }
    return;
  }
  hop::regs_alloc<240>();

  // consumers: warpgroup wg owns key rows [64 wg, 64 wg + 64) of the tile
  const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128;
  const int quad = t128 % 4;
  const int k_lo = j * BK + wg * 64;
  const int kr0 = k_lo + (t128 / 32) * 16 + (t128 % 32) / 4;
  const int kr1 = kr0 + 8;
  const uint32_t sKw = sK + wg * 64 * 128, sVw = sV + wg * 64 * 128;
  // the steps of each head this warpgroup skips, which lead the head's
  // run: its keys all past Sk, or all above the step's rows (q tile i <
  // k_lo / BQ) and, in prefix-LM mode, past the prompt
  const int n_skip = k_lo >= Sk ? per_head
                     : causal && !(PFX && k_lo < plen)
                         ? min(max(k_lo / BQ - i0, 0), per_head)
                         : 0;

  float dkacc[32], dvacc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) dkacc[x] = dvacc[x] = 0.f;

  hop::mbar_wait(&bar.kv_full, 0);
  for (int t = 0; t < steps; ++t) {
    const int s = t % kStages, phase = (t / kStages) & 1;
    const int q_lo = (i0 + t % per_head) * BQ;
    hop::mbar_wait(&bar.full[s], phase);
    if (t % per_head < n_skip) {  // the stage is released unread
      hop::mbar_arrive(&bar.empty[s]);
      continue;
    }

    // S^T = K Q^T, then dP^T = V dO^T: the tensor cores work on dP^T
    // while P^T's exponentials are computed
    float sacc[BQ / 2], dpacc[BQ / 2];
    hop::wgmma_fence();
    scores(sacc, sKw, sQ(s));
    hop::wgmma_commit();
    scores(dpacc, sVw, sdO(s));
    hop::wgmma_commit();
    hop::wgmma_wait<1>();
    hop::fence_regs(sacc);

    // P^T over S^T's registers; a column is the q row
    // q_lo + 8 c + 2 quad + (e & 1), a row the key kr0 or kr1. Only a step
    // that crosses the diagonal (prefix-LM mode: and the prompt's end) or a
    // ragged end masks, in a branch of its own.
    const float* lse = sLse(s) + (first_row(t) & 3) + 2 * quad;
    if ((causal && k_lo + 63 > q_lo && !(PFX && k_lo + 64 <= plen)) ||
        q_lo + BQ > Sq || k_lo + 64 > Sk) {
#pragma unroll
      for (int c = 0; c < BQ / 8; ++c) {
        const float l0 = lse[8 * c] * kLog2e, l1 = lse[8 * c + 1] * kLog2e;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * c + e;
          const int qc = q_lo + 8 * c + 2 * quad + (e & 1);
          const int kr = (e & 2) ? kr1 : kr0;
          const float p =
              hop::ex2(fmaf(sacc[x], scale_log2, (e & 1) ? -l1 : -l0));
          sacc[x] = kr >= Sk || qc >= Sq ||
                            (causal && kr > qc && !(PFX && kr < plen))
                        ? 0.f
                        : p;
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < BQ / 8; ++c) {
        const float l0 = lse[8 * c] * kLog2e, l1 = lse[8 * c + 1] * kLog2e;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * c + e;
          sacc[x] = hop::ex2(fmaf(sacc[x], scale_log2, (e & 1) ? -l1 : -l0));
        }
      }
    }
    hop::wgmma_wait<0>();  // dP^T is done
    hop::fence_regs(dpacc);

    // dS^T = P^T (dP^T - delta) scale over dP^T's registers; P^T and dS^T
    // rounded to bf16 as the A fragments of the step's dV and dK products
    const float* delta = sDelta(s) + (first_row(t) & 3) + 2 * quad;
#pragma unroll
    for (int c = 0; c < BQ / 8; ++c) {
      const float d0 = delta[8 * c], d1 = delta[8 * c + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * c + e;
        dpacc[x] = sacc[x] * (dpacc[x] - ((e & 1) ? d1 : d0)) * scale;
      }
    }
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      hop::acc_to_a(sacc, kk, pa[kk]);
      hop::acc_to_a(dpacc, kk, da[kk]);
    }

    // dV += P^T dO, dK += dS^T Q (dO and Q [q][64] MN-major)
    hop::wgmma_fence();
    hop::fence_regs(dvacc);
    hop::fence_regs(dkacc);
    grads(dvacc, pa, sdO(s));
    grads(dkacc, da, sQ(s));
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(dvacc);
    hop::fence_regs(dkacc);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      hop::fence_regs(pa[kk]);
      hop::fence_regs(da[kk]);
    }
    hop::mbar_arrive(&bar.empty[s]);  // this thread is done with stage s
  }

  // dK, dV in bf16 straight from the accumulators
  const size_t head_row = (size_t)bh * Sk;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int col = 8 * c + 2 * quad;
    if (col < D) {
      if (kr0 < Sk) {
        const size_t at = (head_row + kr0) * D + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(dkacc[4 * c], dkacc[4 * c + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dvacc[4 * c], dvacc[4 * c + 1]);
      }
      if (kr1 < Sk) {
        const size_t at = (head_row + kr1) * D + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(dkacc[4 * c + 2], dkacc[4 * c + 3]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dvacc[4 * c + 2], dvacc[4 * c + 3]);
      }
    }
  }
}

template <bool PFX>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv, int B,
           int H, int Hkv, int Sq, int Sk, int D, float scale, int causal,
           void* stream, const int* prefix_len = nullptr) {
  CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  const size_t rows = (size_t)B * H * Sq;
  if (!hop::tensor_map(&tq, static_cast<const bf16*>(q), B * H, Sq, D, BQ) ||
      !hop::tensor_map(&tk, static_cast<const bf16*>(k), B * Hkv, Sk, D,
                       BK) ||
      !hop::tensor_map(&tv, static_cast<const bf16*>(v), B * Hkv, Sk, D,
                       BK) ||
      !hop::tensor_map(&tdo, static_cast<const bf16*>(dout), B * H, Sq, D,
                       BQ) ||
      !hop::tensor_map_1d(&tlse, lse, rows, kRowBox) ||
      !hop::tensor_map_1d(&tdelta, delta, rows, kRowBox)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((Sk + BK - 1) / BK * B * Hkv);
  return hop::launch(flash_bwd_dkv_d64_kernel<PFX>, grid, kThreads,
                     Layout::kSmem, stream, tq, tk, tv, tdo, tlse, tdelta,
                     static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, H,
                     Hkv, Sq, Sk, D, scale, scale * kLog2e, causal,
                     prefix_len);
}

}  // namespace d64
}  // namespace dkv
}  // namespace dlr

extern "C" int dlr_flash_bwd_dkv_bf16(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dk, void* dv, int B, int H,
                                      int Hkv, int Sq, int Sk, int D,
                                      float scale, int causal, void* stream) {
  return D <= 64
             ? dlr::dkv::d64::launch<false>(q, k, v, dout, lse, delta, dk, dv,
                                            B, H, Hkv, Sq, Sk, D, scale,
                                            causal, stream)
             : dlr::dkv::launch_bf16<128, false>(q, k, v, dout, lse, delta,
                                                 dk, dv, B, H, Hkv, Sq, Sk, D,
                                                 scale, causal, stream);
}

extern "C" int dlr_flash_bwd_dkv_f32(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dk, void* dv, int B, int H,
                                     int Hkv, int Sq, int Sk, int D,
                                     float scale, int causal, void* stream) {
  return dlr::launch_dkv<float, false>(q, k, v, dout, lse, delta, dk, dv, B,
                                       H, Hkv, Sq, Sk, D, scale, causal,
                                       stream);
}

// segment-id mode: seg_q [B, Sq] and seg_k [B, Sk] int32, and their tile
// table seg_tiles [B, ceil(Sq / 64) + ceil(Sk / 64), 2] int32 (the f32
// kernel visits every tile and does not read it)
extern "C" int dlr_flash_bwd_dkv_seg_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    const int* seg_q, const int* seg_k, const int* seg_tiles, int B, int H,
    int Hkv, int Sq, int Sk, int D, float scale, int causal, void* stream) {
  return D <= 64 ? dlr::dkv::launch_bf16<64, true>(
                       q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Sq, Sk,
                       D, scale, causal, stream, seg_q, seg_k, nullptr,
                       seg_tiles)
                 : dlr::dkv::launch_bf16<128, true>(
                       q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Sq, Sk,
                       D, scale, causal, stream, seg_q, seg_k, nullptr,
                       seg_tiles);
}

extern "C" int dlr_flash_bwd_dkv_seg_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    const int* seg_q, const int* seg_k, const int* seg_tiles, int B, int H,
    int Hkv, int Sq, int Sk, int D, float scale, int causal, void* stream) {
  (void)seg_tiles;
  return dlr::launch_dkv<float, true>(q, k, v, dout, lse, delta, dk, dv, B,
                                      H, Hkv, Sq, Sk, D, scale, causal, stream,
                                      seg_q, seg_k);
}

// prefix-LM mode: prefix_len [B] int32; always causal (the flag is
// ignored)
extern "C" int dlr_flash_bwd_dkv_pfx_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    const int* prefix_len, int B, int H, int Hkv, int Sq, int Sk, int D,
    float scale, int causal, void* stream) {
  (void)causal;
  return D <= 64
             ? dlr::dkv::d64::launch<true>(q, k, v, dout, lse, delta, dk, dv,
                                           B, H, Hkv, Sq, Sk, D, scale, 1,
                                           stream, prefix_len)
             : dlr::dkv::launch_bf16<128, false, true>(
                   q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Sq, Sk, D,
                   scale, 1, stream, nullptr, nullptr, prefix_len);
}

extern "C" int dlr_flash_bwd_dkv_pfx_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    const int* prefix_len, int B, int H, int Hkv, int Sq, int Sk, int D,
    float scale, int causal, void* stream) {
  (void)causal;
  return dlr::launch_dkv<float, false, true>(q, k, v, dout, lse, delta, dk,
                                             dv, B, H, Hkv, Sq, Sk, D, scale,
                                             1, stream, nullptr, nullptr,
                                             prefix_len);
}

DLR_DEFINE_ERROR_STRING(dlr_flash_bwd_dkv_error)

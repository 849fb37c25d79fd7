// B3: flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces dlrover_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel
// (launched from _flash_backward): with p recomputed from the saved
// logsumexp as in the dKV kernel,
//   dS = p * (dO V^T - delta) * scale,   dQ += dS K,
// over the k tiles at or left of the diagonal, reading the group's
// shared KV head. delta = rowsum(dO * O) - dlse comes in precomputed.
//
// Bound on the H100: operations. Three products per visible (q, k)
// pair: 206 GFLOP at the main path's shape (H=32, H_kv=8, S=4096,
// D=128, bf16, causal), 0.209 ms at 989 TFLOP/s.
//
// The TPU grid (b, h, i, j) keeps dQ in VMEM scratch while its
// innermost k-tile dimension runs in order; here that dimension is a
// loop inside the block, and each dQ tile has a single writer: no
// atomics and no second pass.
//
// bf16 design (flash_bwd_dq_bf16_kernel, on hopper_common.cuh): one
// block per (128-row q tile, head, batch), 384 threads, one block an
// SM, the q tiles with the most causal work first. Two consumer
// warpgroups own 64 q rows each: Q and dO are loaded once by TMA into
// 128-byte-swizzled shared memory and stay, lse and delta are read once
// into registers (a row is a row here, as in the forward), and dQ
// accumulates in registers for the whole block (setmaxnreg gives the
// consumers 240 registers a thread, the producer 24). A producer warp
// keeps TMA loads of 128-key K and V tiles in flight through a 2-stage
// mbarrier ring (3-D tensor maps, so a ragged tile reads zeros, never
// the next head's rows). Per k tile:
//   S = Q K^T, dP = dO V^T   wgmma SS m64n128k16, K-major operands; dP
//         is issued before P's exponentials and runs beside them;
//   P = exp2(S scale log2e - lse log2e), dS = P (dP - delta) scale, in
//         registers; only tiles crossing the diagonal or the ragged end
//         of the keys mask, and a warpgroup whose rows see none of the
//         tile's keys skips it;
//   dQ += dS K   wgmma RS m64n{DP}k16: dS rounded to bf16 in the
//         accumulator layout is the A fragment as it stands, and K, the
//         tile S read K-major, is read MN-major (transpose bit).
// (At D = 128, 64-key tiles, whose m64n64 SS products read as many
// shared-memory bytes per flop as the tensor cores can take, were
// slower, 0.363 against 0.348 ms at 32/8 heads, and so was leaving one
// tile's dQ product in flight under the next tile's S, 0.396 ms, where
// ptxas serialized every wgmma; H100 80GB HBM3, 700 W.)
// The segment-id kernels run this design on a 64-wide head tile at head
// dims up to 64, every kernel on a 128-wide one above; columns past D
// read as zeros, which change none of the three products' stored parts.
// Rows past Sq read zeros and are never stored.
//
// 64-wide head tile (flash_bwd_dq_d64_kernel: head dims up to 64,
// unsegmented, causal, not causal or prefix-LM; GLM's main path). The
// blocks, tiles and products above, with the same sums in the same
// order, so dQ is bit for bit the above design's at D <= 64 (PERF.md),
// and:
//   - the two consumer warpgroups take turns to issue their products
//     (named barriers 1 and 2: a warpgroup waits for its turn, issues,
//     and hands the turn over), so that one's exponentials and dS run
//     while the other's products do;
//   - a tile's turn issues the last tile's dQ product, then its own S
//     and dP: at D = 64 the dQ accumulator and the dS fragments are 32
//     registers each, so the product stays in flight with no wgmma
//     serialized (64 + 64 + 32 + 32 of 240 registers);
//   - the diagonal, prompt and ragged-end masks are a branch of their
//     own (per element they had cost every tile a predicated test for
//     each score);
//   - 4 ring stages of K and V.
//
// f32 (the parity path, flash_bwd_dq_kernel<float>): 32x32 tiles staged
// in shared memory, scalar FMA products (flash_common.cuh).
//
// Segment-id mode (packed documents; the reference's _recompute_p with
// seg_q and seg_k, flash_attention.py:550-557): a separate instantiation
// of each kernel (SEG = true, entry points dlr_flash_bwd_dq_seg_*) takes
// int32 ids seg_q [B, Sq] and seg_k [B, Sk] and sets p = 0 where a q
// row's id differs from the key's, on top of the causal mask; the SEG =
// false kernels are unchanged. The bf16 kernel also takes the ids' tile
// table seg_tiles [B, ceil(Sq / 64) + ceil(Sk / 64), 2]: the [min, max]
// id of each 64-id tile, q side then k side, built on the device once a
// layer's forward (flash_attention.py's segment_tiles) and shared with B1
// and B2; B1 lists the same tiles (flash_fwd.cu).
// Before the role split one warp lists in shared memory the block's K/V
// tiles (0 .. nkt, after the causal cut; all of them when not causal)
// one of whose 64-key halves has a [min, max] meeting that of one of the
// block's two 64-row halves, each with a bit for each warpgroup whose
// rows it meets; the producer and both consumer warpgroups walk that
// list, so the mbarrier phases stay in step, and a warpgroup whose bit
// is clear skips the tile as the causal skip does. The test never drops
// a tile that holds a same-id pair, for any ids, and on sorted ids lists
// exactly those tiles. A block whose list is empty (pair-form rows whose
// ids no key carries) runs no tile and stores dQ = 0. On a listed tile,
// as in B1 (flash_fwd.cu), one producer warp stages the block's q ids
// and each K/V tile's k ids in shared memory with per-64 "one value"
// flags, and a consumer warpgroup masks the tile not at all by segment,
// whole (every p = exp2(-inf) through the lse it subtracts), or, where
// ids change inside it, by a warp-uniform pass that sets S to -inf apart
// from the unsegmented mask. Ids need not be sorted. The f32 kernel
// visits every causal tile, stages the ids beside its tiles and ignores
// the table. A row that saw no key has lse = NEG_INF from the forward;
// the lse is clamped to 0 first, as the reference does, so every p of
// that row stays exactly 0.
//
// Prefix-LM mode (GLM's mask; the reference's _recompute_p with
// prefix_len, flash_attention.py:662-665): a third instantiation of each
// kernel (PFX = true, entry points dlr_flash_bwd_dq_pfx_*, always causal)
// takes int32 prefix_len [B]; key j is visible to q row i iff j <= i or
// j < p. A block reads p once (thread 0, into shared memory), and its
// producer and consumers visit k tiles 0 .. max(i + 1, ceil(p / BK)) - 1
// (p clamped to [0, Sk] for the schedule only), as B1 does. A tile
// wholly inside the prompt masks nothing; one that crosses a
// warpgroup's diagonal and the end of the prompt masks by element (p = 0
// where key > row and key >= p), inside the unsegmented mask's
// warp-uniform branch, the mode's terms compiled away in the other
// instantiations. Every row sees key 0, so lse is finite and a masked p
// is exactly 0.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace dlr {

template <typename T>
size_t dq_smem_bytes(int D, bool seg) {
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK, PAD = Tile<T>::PAD;
  const int ldt = D + PAD;
  return 2 * round128(sizeof(T) * BQ * ldt)                 // Q, dO
         + 2 * round128(sizeof(T) * BK * ldt)               // K, V
         + 2 * round128(sizeof(float) * BQ * (BK + kFPad))  // S, dP|dS
         + round128(sizeof(float) * BQ * (D + kFPad))       // dQ acc
         + 2 * round128(sizeof(float) * BQ)                 // lse, delta
         + (seg ? round128(sizeof(int) * BQ) + round128(sizeof(int) * BK)
                : 0);  // segment ids of the rows and of the K/V tile
}

template <typename T, bool SEG, bool PFX>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int H, int Hkv, int Sq, int Sk, int D, float scale,
                        int causal, const int* __restrict__ seg_q,
                        const int* __restrict__ seg_k,
                        const int* __restrict__ prefix_len) {
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK, PAD = Tile<T>::PAD;
  constexpr int ELEMS = BQ * BK / kThreads;
  const int ldt = D + PAD, lds = BK + kFPad, ldp = BK + PAD, lda = D + kFPad;

  const int nqt = (Sq + BQ - 1) / BQ;
  const int i = nqt - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);

  extern __shared__ __align__(128) unsigned char smem[];
  SmemCarve carve{smem};
  T* sQ = carve.take<T>(BQ * ldt);
  T* sdO = carve.take<T>(BQ * ldt);
  T* sK = carve.take<T>(BK * ldt);
  T* sV = carve.take<T>(BK * ldt);
  float* sS = carve.take<float>(BQ * lds);
  float* sdP = carve.take<float>(BQ * lds);
  float* sdQ = carve.take<float>(BQ * lda);
  float* sLse = carve.take<float>(BQ);
  float* sDelta = carve.take<float>(BQ);
  int* sSegQ = SEG ? carve.take<int>(BQ) : nullptr;
  int* sSegK = SEG ? carve.take<int>(BK) : nullptr;
  T* sdS = reinterpret_cast<T*>(sdP);

  const size_t q_row0 = ((size_t)b * H + h) * Sq + (size_t)i * BQ;
  const int qvalid = min(BQ, Sq - i * BQ);
  load_tile(sQ, ldt, q + q_row0 * D, qvalid, BQ, D);
  load_tile(sdO, ldt, dout + q_row0 * D, qvalid, BQ, D);
  load_rows(sLse, lse + q_row0, qvalid, BQ);
  load_rows(sDelta, delta + q_row0, qvalid, BQ);
  zero_f32(sdQ, lda, BQ, D);
  if constexpr (SEG) {
    for (int t = threadIdx.x; t < BQ; t += blockDim.x) {
      sSegQ[t] = t < qvalid ? seg_q[(size_t)b * Sq + i * BQ + t] : 0;
    }
  }

  const T* k_head = k + ((size_t)b * Hkv + hk) * Sk * D;
  const T* v_head = v + ((size_t)b * Hkv + hk) * Sk * D;
  int nkt = (Sk + BK - 1) / BK;
  if (causal) nkt = min(nkt, (i * BQ + BQ - 1) / BK + 1);
  // prefix-LM mode: every tile of prompt keys as well
  const int plen = PFX ? prefix_len[b] : 0;
  if (PFX) nkt = max(nkt, (min(max(plen, 0), Sk) + BK - 1) / BK);

  for (int j = 0; j < nkt; ++j) {
    __syncthreads();
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
    tile_mma<false, true>(sdO, ldt, sV, ldt, sdP, lds, BQ, BK, D, false);
    __syncthreads();

    float ds[ELEMS];
#pragma unroll
    for (int e = 0; e < ELEMS; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int r = idx / BK, c = idx % BK;
      const int row = i * BQ + r, col = j * BK + c;
      const bool ok = row < Sq && col < Sk &&
                      (!causal || col <= row || (PFX && col < plen)) &&
                      (!SEG || sSegQ[r] == sSegK[c]);
      // segment-id mode: a row that saw no key has lse NEG_INF
      const float l = SEG && sLse[r] <= kNegInf * 0.5f ? 0.f : sLse[r];
      const float p = ok ? expf(sS[r * lds + c] * scale - l) : 0.f;
      ds[e] = p * (sdP[r * lds + c] - sDelta[r]) * scale;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < ELEMS; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      sdS[(idx / BK) * ldp + idx % BK] = from_f<T>(ds[e]);
    }
    __syncthreads();
    tile_mma<false, false>(sdS, ldp, sK, ldt, sdQ, lda, BQ, D, BK, true);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < qvalid * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D;
    dq[(q_row0 + r) * D + d] = from_f<T>(sdQ[r * lda + d]);
  }
}

template <typename T, bool SEG, bool PFX = false>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int H,
              int Hkv, int Sq, int Sk, int D, float scale, int causal,
              void* stream, const int* seg_q = nullptr,
              const int* seg_k = nullptr, const int* prefix_len = nullptr) {
  const dim3 grid((Sq + Tile<T>::BQ - 1) / Tile<T>::BQ, H, B);
  return launch(flash_bwd_dq_kernel<T, SEG, PFX>, grid,
                dq_smem_bytes<T>(D, SEG), stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq),
                H, Hkv, Sq, Sk, D, scale, causal, seg_q, seg_k, prefix_len);
}

// -- bf16 --------------------------------------------------------------------

namespace dq {

using bf16 = __nv_bfloat16;
constexpr int BQ = 128;  // q rows a block: two consumer warpgroups of 64
constexpr int BK = 128;  // keys a K/V tile
constexpr int kStages = 2;
constexpr int kConsumers = 256;  // threads of the two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory at head-dim tile DP (64 or 128): Q and dO (DP / 64
// SW128 column blocks of BQ rows each), kStages x (K, V) tiles (DP / 64
// column blocks of BK rows), then the mbarriers.
template <int DP>
struct Layout {
  static constexpr uint32_t kQ = BQ * DP * 2;   // Q or dO
  static constexpr uint32_t kKV = BK * DP * 2;  // one K or one V tile
  static constexpr uint32_t kStage0 = 2 * kQ;
  static constexpr uint32_t kBars = kStage0 + kStages * 2 * kKV;
  static constexpr size_t kSmem = kBars + 128 + 1024;  // + align slack
  // segment-id mode, after the mbarriers: the block's q ids and their
  // flags (hop::seg_publish), then a stage's k ids and flags each
  static constexpr uint32_t kIds = kBars + 128;
  static constexpr int kQIds = BQ + 8, kKIds = BK + 8;  // ints
  static constexpr size_t kIdBytes = (kQIds + kStages * kKIds) * 4;
  // then the block's list of K/V tiles, one int a tile
  static constexpr uint32_t kList = kIds + kIdBytes;
};

// The mbarriers: Q and dO arrived; K, V of a stage arrived; a stage
// released by both consumer warpgroups; (segment-id mode) a stage's k
// ids written. Then (prefix-LM mode) the block's prefix length;
// (segment-id mode) the length of the block's list of K/V tiles.
struct Bars {
  uint64_t q_full, k_full[kStages], v_full[kStages], empty[kStages];
  uint64_t ids_full[kStages];
  int prefix, count;
};

// Issue acc = A B^T over DP / 16 k16 steps: A this warpgroup's 64 rows
// of the BQ-row Q or dO tile, B the BK-row K or V tile, both K-major.
template <int DP>
__device__ __forceinline__ void scores(float (&acc)[BK / 2], uint32_t sA,
                                       uint32_t sB) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t a = (kk / 4) * BQ * 128 + (kk % 4) * 32;
    const uint32_t b = (kk / 4) * BK * 128 + (kk % 4) * 32;
    hop::wgmma_ss_m64n128k16<0>(acc, hop::desc_sw128(sA + a, 16, 1024),
                                hop::desc_sw128(sB + b, 16, 1024), kk > 0);
  }
}

// Issue dQ += dS K over the tile's BK keys: dS in bf16 from registers
// (BK / 16 k16 fragments), K [BK][DP] read MN-major.
template <int DP>
__device__ __forceinline__ void dq_update(float (&acc)[DP / 2],
                                          const uint32_t (&a)[BK / 16][4],
                                          uint32_t sK) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t b = hop::desc_sw128(sK + kk * 16 * 128, BK * 128, 1024);
    if constexpr (DP == 128) {
      hop::wgmma_rs_m64n128k16<1>(acc, a[kk], b, 1);
    } else {
      hop::wgmma_rs_m64n64k16<1>(acc, a[kk], b, 1);
    }
  }
}

template <int DP, bool SEG, bool PFX>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dq, int H, int Hkv, int Sq,
                             int Sk, int D, float scale, float scale_log2,
                             int causal, const int* __restrict__ seg_q,
                             const int* __restrict__ seg_k,
                             const int* __restrict__ prefix_len,
                             const int* __restrict__ seg_tiles) {
  using L = Layout<DP>;
  constexpr int NA = DP / 2;  // dQ accumulator registers a thread
  constexpr int NS = BK / 2;  // S or dP accumulator registers a thread
  const int nqt = (Sq + BQ - 1) / BQ;
  // every head's last q tile first: the heaviest causal blocks lead
  const int i = nqt - 1 - blockIdx.x / H;
  const int h = blockIdx.x % H, b = blockIdx.y;
  const int hk = h / (H / Hkv);
  int nkt = (Sk + BK - 1) / BK;
  if (causal) nkt = min(nkt, (i * BQ + BQ - 1) / BK + 1);

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sQ = hop::smem_u32(base), sdO = sQ + L::kQ;
  auto sK = [&](int s) { return sQ + L::kStage0 + s * 2 * L::kKV; };
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
    // producer: one thread loads Q and dO once, then keeps the ring full
    // with the K and V tiles of KV head hk; in segment-id mode its warp
    // writes the ids
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
      if (pt == 0) {
        hop::mbar_arrive_expect_tx(&bar.q_full, 2 * L::kQ);
        for (int c = 0; c < DP / 64; ++c) {
          hop::tma_load_3d(sQ + c * BQ * 128, &tq, &bar.q_full, c * 64,
                           i * BQ, b * H + h);
          hop::tma_load_3d(sdO + c * BQ * 128, &tdo, &bar.q_full, c * 64,
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
  hop::regs_alloc<240>();

  // consumers: warpgroup wg owns q rows [64 wg, 64 wg + 64) of the tile
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int quad = t % 4;
  const int q_lo = i * BQ + wg * 64;
  const int row0 = q_lo + (t / 32) * 16 + (t % 32) / 4;
  const int row1 = row0 + 8;
  const uint32_t sQw = sQ + wg * 64 * 128, sdOw = sdO + wg * 64 * 128;
  // lse (base 2) and delta of this thread's two rows; rows past Sq read
  // zeros there and are never stored
  const size_t head_row = ((size_t)b * H + h) * Sq;
  float lse0 = row0 < Sq ? lse[head_row + row0] : 0.f;
  float lse1 = row1 < Sq ? lse[head_row + row1] : 0.f;
  // segment-id mode: a row that saw no key has lse NEG_INF
  if constexpr (SEG) {
    if (lse0 <= kNegInf * 0.5f) lse0 = 0.f;
    if (lse1 <= kNegInf * 0.5f) lse1 = 0.f;
  }
  lse0 *= kLog2e;
  lse1 *= kLog2e;
  const float delta0 = row0 < Sq ? delta[head_row + row0] : 0.f;
  const float delta1 = row1 < Sq ? delta[head_row + row1] : 0.f;

  float dqacc[NA];
#pragma unroll
  for (int x = 0; x < NA; ++x) dqacc[x] = 0.f;

  hop::mbar_wait(&bar.q_full, 0);
  for (int j = 0; j < nkt; ++j) {
    const int s = j % kStages, phase = (j / kStages) & 1;
    const int k_lo = k_tile(j) * BK;
    hop::mbar_wait(&bar.k_full[s], phase);
    // no rows, or every key of the tile above this warpgroup's rows (and,
    // in prefix-LM mode, past the prompt): nothing to add
    if (q_lo >= Sq ||
        (causal && k_lo > q_lo + 63 && !(PFX && k_lo < plen))) {
      hop::mbar_wait(&bar.v_full[s], phase);
      hop::mbar_arrive(&bar.empty[s]);
      continue;
    }
    // segment-id mode: the tile's ids can meet none of this warpgroup's
    // rows (it was listed for the other's)
    if constexpr (SEG) {
      if (!((list[j] >> wg) & 1)) {
        hop::mbar_wait(&bar.v_full[s], phase);
        hop::mbar_arrive(&bar.empty[s]);
        continue;
      }
    }

    // segment-id mode: how this warpgroup's rows and the tile's keys
    // mask (hop::SegMode), read before the products, while their
    // accumulators are not yet live
    int seg = hop::kSegNone;
    if constexpr (SEG) {
      hop::mbar_wait(&bar.ids_full[s], phase);
      seg = hop::seg_mode(sid + BQ, wg, 1, kids(s) + BK, 0, 2);
    }

    // S = Q K^T, then dP = dO V^T: the tensor cores work on dP while
    // P's exponentials are computed
    float sacc[NS], dpacc[NS];
    hop::wgmma_fence();
    scores<DP>(sacc, sQw, sK(s));
    hop::wgmma_commit();
    hop::mbar_wait(&bar.v_full[s], phase);
    hop::wgmma_fence();
    scores<DP>(dpacc, sdOw, sV(s));
    hop::wgmma_commit();
    hop::wgmma_wait<1>();
    hop::fence_regs(sacc);

    // segment-id mode: scores where ids differ masked to -inf, in a
    // warp-uniform branch apart from the unsegmented mask below
    if (seg == hop::kSegById) {
      const int* kid = kids(s);
      const int qid0 = sid[row0 - i * BQ], qid1 = sid[row1 - i * BQ];
#pragma unroll
      for (int x = 0; x < NS; ++x) {
        const int c = 8 * (x / 4) + 2 * quad + (x & 1);
        if (kid[c] != ((x & 2) ? qid1 : qid0)) sacc[x] = -INFINITY;
      }
    }
    // a tile masked whole: every p = exp2(-inf) = 0
    const float nl0 = seg == hop::kSegAll ? -INFINITY : -lse0;
    const float nl1 = seg == hop::kSegAll ? -INFINITY : -lse1;

    // P over S's registers: x = 4 c + e is row (e & 2 ? row1 : row0),
    // key k_lo + 8 c + 2 quad + (e & 1)
    // (prefix-LM mode: keys all inside the prompt need no mask)
    const bool mask =
        (causal && k_lo + BK - 1 > q_lo && !(PFX && k_lo + BK <= plen)) ||
        k_lo + BK > Sk;
#pragma unroll
    for (int x = 0; x < NS; ++x) {
      float p = hop::ex2(fmaf(sacc[x], scale_log2, (x & 2) ? nl1 : nl0));
      if (mask) {
        const int kr = k_lo + 8 * (x / 4) + 2 * quad + (x & 1);
        const int qr = (x & 2) ? row1 : row0;
        if (kr >= Sk || (causal && kr > qr && !(PFX && kr < plen))) p = 0.f;
      }
      sacc[x] = p;
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(dpacc);

    // dS = P (dP - delta) scale, rounded to bf16 A fragments
#pragma unroll
    for (int x = 0; x < NS; ++x) {
      dpacc[x] = sacc[x] * (dpacc[x] - ((x & 2) ? delta1 : delta0)) * scale;
    }
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) hop::acc_to_a(dpacc, kk, da[kk]);

    // dQ += dS K
    hop::wgmma_fence();
    hop::fence_regs(dqacc);
    dq_update<DP>(dqacc, da, sK(s));
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(dqacc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) hop::fence_regs(da[kk]);
    hop::mbar_arrive(&bar.empty[s]);  // this thread is done with stage s
  }

  // dQ in bf16 straight from the accumulator
#pragma unroll
  for (int c = 0; c < NA / 4; ++c) {
    const int col = 8 * c + 2 * quad;
    if (col < D) {
      if (row0 < Sq) {
        *reinterpret_cast<__nv_bfloat162*>(dq + (head_row + row0) * D + col) =
            __floats2bfloat162_rn(dqacc[4 * c], dqacc[4 * c + 1]);
      }
      if (row1 < Sq) {
        *reinterpret_cast<__nv_bfloat162*>(dq + (head_row + row1) * D + col) =
            __floats2bfloat162_rn(dqacc[4 * c + 2], dqacc[4 * c + 3]);
      }
    }
  }
}

template <int DP, bool SEG, bool PFX = false>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dq, int B, int H, int Hkv, int Sq, int Sk, int D,
                float scale, int causal, void* stream,
                const int* seg_q = nullptr, const int* seg_k = nullptr,
                const int* prefix_len = nullptr,
                const int* seg_tiles = nullptr) {
  CUtensorMap tq, tk, tv, tdo;
  if (!hop::tensor_map(&tq, static_cast<const bf16*>(q), B * H, Sq, D, BQ) ||
      !hop::tensor_map(&tk, static_cast<const bf16*>(k), B * Hkv, Sk, D,
                       BK) ||
      !hop::tensor_map(&tv, static_cast<const bf16*>(v), B * Hkv, Sk, D,
                       BK) ||
      !hop::tensor_map(&tdo, static_cast<const bf16*>(dout), B * H, Sq, D,
                       BQ)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((Sq + BQ - 1) / BQ * H, B);
  // segment-id mode: the ids, then the list (one int a K/V tile)
  const size_t smem =
      Layout<DP>::kSmem +
      (SEG ? Layout<DP>::kIdBytes + (Sk + BK - 1) / BK * sizeof(int) : 0);
  return hop::launch(flash_bwd_dq_bf16_kernel<DP, SEG, PFX>, grid, kThreads,
                     smem, stream, tq, tk, tv, tdo, lse, delta,
                     static_cast<bf16*>(dq), H, Hkv, Sq, Sk, D, scale,
                     scale * kLog2e, causal, seg_q, seg_k, prefix_len,
                     seg_tiles);
}

// -- bf16, 64-wide head tile ----------------------------------------------
//
// The unsegmented kernels at head dims up to 64 (header: "64-wide head
// tile"): the two consumer warpgroups take turns to issue their products,
// each tile's dQ product with the next tile's S and dP, so that one
// warpgroup's exponentials and dS run under the other's products; a
// 4-stage ring.
namespace d64 {

constexpr int kStages = 4;
constexpr int kTurnBar = 1;  // named barriers 1 and 2: warpgroup 0's, 1's turn

struct Layout {
  static constexpr uint32_t kQ = BQ * 64 * 2;   // Q or dO
  static constexpr uint32_t kKV = BK * 64 * 2;  // one K or one V tile
  static constexpr uint32_t kStage0 = 2 * kQ;
  static constexpr uint32_t kBars = kStage0 + kStages * 2 * kKV;
  static constexpr size_t kSmem = kBars + 128 + 1024;  // + align slack
};

// Q and dO arrived; K, V of a stage arrived; a stage released by both
// consumer warpgroups.
struct Bars {
  uint64_t q_full, k_full[kStages], v_full[kStages], empty[kStages];
};

template <bool PFX>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_d64_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dq, int H, int Hkv, int Sq,
                            int Sk, int D, float scale, float scale_log2,
                            int causal, const int* __restrict__ prefix_len) {
  using L = Layout;
  constexpr int NS = BK / 2;  // S or dP accumulator registers a thread
  const int nqt = (Sq + BQ - 1) / BQ;
  // every head's last q tile first: the heaviest causal blocks lead
  const int i = nqt - 1 - blockIdx.x / H;
  const int h = blockIdx.x % H, b = blockIdx.y;
  const int hk = h / (H / Hkv);
  int nkt = (Sk + BK - 1) / BK;
  if (causal) nkt = min(nkt, (i * BQ + BQ - 1) / BK + 1);
  // prefix-LM mode: the prompt's k tiles too (p clamped for the schedule)
  const int plen = PFX ? prefix_len[b] : 0;
  if (PFX) nkt = max(nkt, (min(max(plen, 0), Sk) + BK - 1) / BK);

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sQ = hop::smem_u32(base), sdO = sQ + L::kQ;
  auto sK = [&](int s) { return sQ + L::kStage0 + s * 2 * L::kKV; };
  auto sV = [&](int s) { return sK(s) + L::kKV; };
  Bars& bar = *reinterpret_cast<Bars*>(base + L::kBars);
  if (threadIdx.x == 0) {
    hop::mbar_init(&bar.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&bar.k_full[s], 1);
      hop::mbar_init(&bar.v_full[s], 1);
      hop::mbar_init(&bar.empty[s], kConsumers);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: one thread loads Q and dO once, then keeps the ring full
    // with the K and V tiles of KV head hk
    hop::regs_dealloc<24>();
    if (threadIdx.x == kConsumers) {
      hop::mbar_arrive_expect_tx(&bar.q_full, 2 * L::kQ);
      hop::tma_load_3d(sQ, &tq, &bar.q_full, 0, i * BQ, b * H + h);
      hop::tma_load_3d(sdO, &tdo, &bar.q_full, 0, i * BQ, b * H + h);
      for (int j = 0; j < nkt; ++j) {
        const int s = j % kStages;
        // the stage's previous tile, j - kStages, is released
        if (j >= kStages) hop::mbar_wait(&bar.empty[s], (j / kStages - 1) & 1);
        hop::mbar_arrive_expect_tx(&bar.k_full[s], L::kKV);
        hop::tma_load_3d(sK(s), &tk, &bar.k_full[s], 0, j * BK, b * Hkv + hk);
        hop::mbar_arrive_expect_tx(&bar.v_full[s], L::kKV);
        hop::tma_load_3d(sV(s), &tv, &bar.v_full[s], 0, j * BK, b * Hkv + hk);
      }
    }
    return;
  }
  hop::regs_alloc<240>();

  // consumers: warpgroup wg owns q rows [64 wg, 64 wg + 64) of the tile
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int quad = t % 4;
  const int q_lo = i * BQ + wg * 64;
  const int row0 = q_lo + (t / 32) * 16 + (t % 32) / 4;
  const int row1 = row0 + 8;
  const uint32_t sQw = sQ + wg * 64 * 128, sdOw = sdO + wg * 64 * 128;
  // lse (base 2) and delta of this thread's two rows; rows past Sq read
  // zeros there and are never stored
  const size_t head_row = ((size_t)b * H + h) * Sq;
  const float nl0 = -((row0 < Sq ? lse[head_row + row0] : 0.f) * kLog2e);
  const float nl1 = -((row1 < Sq ? lse[head_row + row1] : 0.f) * kLog2e);
  const float delta0 = row0 < Sq ? delta[head_row + row0] : 0.f;
  const float delta1 = row1 < Sq ? delta[head_row + row1] : 0.f;
  // the tiles this warpgroup visits, which lead the block's: none past
  // Sq; else up to its last row's diagonal (and, in prefix-LM mode, the
  // prompt's last key)
  const int nact = q_lo >= Sq ? 0
                   : !causal  ? nkt
                              : min(nkt, max(q_lo + 63, PFX ? plen - 1 : 0) /
                                                 BK +
                                             1);
  // Turns: a warpgroup issues its products between its turn() and its
  // pass(), which hands the turn to the other. Both take nkt + 1 turns;
  // warpgroup 1 lets warpgroup 0 start, and warpgroup 0 takes one more
  // turn at the end.
  auto turn = [&]() { hop::bar_sync(kTurnBar + wg, 256); };
  auto pass = [&]() { hop::bar_arrive(kTurnBar + 1 - wg, 256); };

  float dqacc[32];
  // dS of the tile before in bf16, the A fragments of its dQ product
  uint32_t da[BK / 16][4];
#pragma unroll
  for (int x = 0; x < 32; ++x) dqacc[x] = 0.f;

  // tile j's S = Q K^T, then dP = dO V^T
  auto issue_scores = [&](float (&sacc)[NS], float (&dpacc)[NS], int s) {
    hop::wgmma_fence();
    scores<64>(sacc, sQw, sK(s));
    hop::wgmma_commit();
    scores<64>(dpacc, sdOw, sV(s));
    hop::wgmma_commit();
  };
  // dQ += dS K over stage s's K
  auto issue_dq = [&](int s) {
    hop::wgmma_fence();
    hop::fence_regs(dqacc);
    dq_update<64>(dqacc, da, sK(s));
    hop::wgmma_commit();
  };
  auto retire_dq = [&]() {
    hop::fence_regs(dqacc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) hop::fence_regs(da[kk]);
  };
  // P over S's registers: x = 4 c + e is row (e & 2 ? row1 : row0), key
  // k_lo + 8 c + 2 quad + (e & 1). Only a tile that crosses the diagonal
  // (prefix-LM mode: and the prompt's end) or the ragged end masks, in a
  // branch of its own.
  auto probs = [&](float (&sacc)[NS], int j) {
    const int k_lo = j * BK;
    if ((causal && k_lo + BK - 1 > q_lo && !(PFX && k_lo + BK <= plen)) ||
        k_lo + BK > Sk) {
#pragma unroll
      for (int x = 0; x < NS; ++x) {
        const int kr = k_lo + 8 * (x / 4) + 2 * quad + (x & 1);
        const int qr = (x & 2) ? row1 : row0;
        const float p =
            hop::ex2(fmaf(sacc[x], scale_log2, (x & 2) ? nl1 : nl0));
        sacc[x] =
            kr >= Sk || (causal && kr > qr && !(PFX && kr < plen)) ? 0.f : p;
      }
    } else {
#pragma unroll
      for (int x = 0; x < NS; ++x) {
        sacc[x] = hop::ex2(fmaf(sacc[x], scale_log2, (x & 2) ? nl1 : nl0));
      }
    }
  };
  // dS = P (dP - delta) scale, rounded to bf16 A fragments
  auto frags = [&](const float (&sacc)[NS], float (&dpacc)[NS]) {
#pragma unroll
    for (int x = 0; x < NS; ++x) {
      dpacc[x] = sacc[x] * (dpacc[x] - ((x & 2) ? delta1 : delta0)) * scale;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) hop::acc_to_a(dpacc, kk, da[kk]);
  };
  auto wait_tile = [&](int j) {
    hop::mbar_wait(&bar.k_full[j % kStages], (j / kStages) & 1);
    hop::mbar_wait(&bar.v_full[j % kStages], (j / kStages) & 1);
  };

  if (wg == 1) pass();  // warpgroup 0 takes the first turn
  hop::mbar_wait(&bar.q_full, 0);
  if (nact > 0) {
    {  // the first tile: no dQ product of a tile before
      float sacc[NS], dpacc[NS];
      wait_tile(0);
      turn();
      issue_scores(sacc, dpacc, 0);
      pass();
      hop::wgmma_wait<1>();
      hop::fence_regs(sacc);
      probs(sacc, 0);
      hop::wgmma_wait<0>();
      hop::fence_regs(dpacc);
      frags(sacc, dpacc);
    }
    for (int j = 1; j < nact; ++j) {
      const int s = j % kStages, prev = (j - 1) % kStages;
      // the last tile's dQ product, then this tile's S and dP: the tensor
      // cores run dP while P's exponentials are computed
      float sacc[NS], dpacc[NS];
      wait_tile(j);
      turn();
      issue_dq(prev);
      issue_scores(sacc, dpacc, s);
      pass();
      hop::wgmma_wait<1>();
      retire_dq();
      hop::mbar_arrive(&bar.empty[prev]);  // done with the last tile's stage
      hop::fence_regs(sacc);
      probs(sacc, j);
      hop::wgmma_wait<0>();
      hop::fence_regs(dpacc);
      frags(sacc, dpacc);
    }
    // the last tile's dQ product
    turn();
    issue_dq((nact - 1) % kStages);
    pass();
    hop::wgmma_wait<0>();
    retire_dq();
    hop::mbar_arrive(&bar.empty[(nact - 1) % kStages]);
  } else {  // the turn a last dQ product takes
    turn();
    pass();
  }
  // tiles whose keys this warpgroup's rows cannot see: released unread
  for (int j = nact; j < nkt; ++j) {
    wait_tile(j);
    turn();
    pass();
    hop::mbar_arrive(&bar.empty[j % kStages]);
  }
  if (wg == 0) turn();  // warpgroup 1's last pass

  // dQ in bf16 straight from the accumulator
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int col = 8 * c + 2 * quad;
    if (col < D) {
      if (row0 < Sq) {
        *reinterpret_cast<__nv_bfloat162*>(dq + (head_row + row0) * D + col) =
            __floats2bfloat162_rn(dqacc[4 * c], dqacc[4 * c + 1]);
      }
      if (row1 < Sq) {
        *reinterpret_cast<__nv_bfloat162*>(dq + (head_row + row1) * D + col) =
            __floats2bfloat162_rn(dqacc[4 * c + 2], dqacc[4 * c + 3]);
      }
    }
  }
}

template <bool PFX>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, int B, int H,
           int Hkv, int Sq, int Sk, int D, float scale, int causal,
           void* stream, const int* prefix_len = nullptr) {
  CUtensorMap tq, tk, tv, tdo;
  if (!hop::tensor_map(&tq, static_cast<const bf16*>(q), B * H, Sq, D, BQ) ||
      !hop::tensor_map(&tk, static_cast<const bf16*>(k), B * Hkv, Sk, D,
                       BK) ||
      !hop::tensor_map(&tv, static_cast<const bf16*>(v), B * Hkv, Sk, D,
                       BK) ||
      !hop::tensor_map(&tdo, static_cast<const bf16*>(dout), B * H, Sq, D,
                       BQ)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((Sq + BQ - 1) / BQ * H, B);
  return hop::launch(flash_bwd_dq_d64_kernel<PFX>, grid, kThreads,
                     Layout::kSmem, stream, tq, tk, tv, tdo, lse, delta,
                     static_cast<bf16*>(dq), H, Hkv, Sq, Sk, D, scale,
                     scale * kLog2e, causal, prefix_len);
}

}  // namespace d64
}  // namespace dq
}  // namespace dlr

extern "C" int dlr_flash_bwd_dq_bf16(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dq, int B, int H, int Hkv, int Sq,
                                     int Sk, int D, float scale, int causal,
                                     void* stream) {
  return D <= 64
             ? dlr::dq::d64::launch<false>(q, k, v, dout, lse, delta, dq, B,
                                           H, Hkv, Sq, Sk, D, scale, causal,
                                           stream)
             : dlr::dq::launch_bf16<128, false>(q, k, v, dout, lse, delta, dq,
                                                B, H, Hkv, Sq, Sk, D, scale,
                                                causal, stream);
}

extern "C" int dlr_flash_bwd_dq_f32(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    void* dq, int B, int H, int Hkv, int Sq,
                                    int Sk, int D, float scale, int causal,
                                    void* stream) {
  return dlr::launch_dq<float, false>(q, k, v, dout, lse, delta, dq, B, H,
                                      Hkv, Sq, Sk, D, scale, causal, stream);
}

// segment-id mode: seg_q [B, Sq] and seg_k [B, Sk] int32, and their tile
// table seg_tiles [B, ceil(Sq / 64) + ceil(Sk / 64), 2] int32 (the f32
// kernel visits every tile and does not read it)
extern "C" int dlr_flash_bwd_dq_seg_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, const int* seg_q,
    const int* seg_k, const int* seg_tiles, int B, int H, int Hkv, int Sq,
    int Sk, int D, float scale, int causal, void* stream) {
  return D <= 64 ? dlr::dq::launch_bf16<64, true>(
                       q, k, v, dout, lse, delta, dq, B, H, Hkv, Sq, Sk, D,
                       scale, causal, stream, seg_q, seg_k, nullptr,
                       seg_tiles)
                 : dlr::dq::launch_bf16<128, true>(
                       q, k, v, dout, lse, delta, dq, B, H, Hkv, Sq, Sk, D,
                       scale, causal, stream, seg_q, seg_k, nullptr,
                       seg_tiles);
}

extern "C" int dlr_flash_bwd_dq_seg_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, const int* seg_q,
    const int* seg_k, const int* seg_tiles, int B, int H, int Hkv, int Sq,
    int Sk, int D, float scale, int causal, void* stream) {
  (void)seg_tiles;
  return dlr::launch_dq<float, true>(q, k, v, dout, lse, delta, dq, B, H, Hkv,
                                     Sq, Sk, D, scale, causal, stream, seg_q,
                                     seg_k);
}

// prefix-LM mode: prefix_len [B] int32; always causal (the flag is
// ignored)
extern "C" int dlr_flash_bwd_dq_pfx_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, const int* prefix_len,
    int B, int H, int Hkv, int Sq, int Sk, int D, float scale, int causal,
    void* stream) {
  (void)causal;
  return D <= 64
             ? dlr::dq::d64::launch<true>(q, k, v, dout, lse, delta, dq, B, H,
                                          Hkv, Sq, Sk, D, scale, 1, stream,
                                          prefix_len)
             : dlr::dq::launch_bf16<128, false, true>(
                   q, k, v, dout, lse, delta, dq, B, H, Hkv, Sq, Sk, D, scale,
                   1, stream, nullptr, nullptr, prefix_len);
}

extern "C" int dlr_flash_bwd_dq_pfx_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, const int* prefix_len,
    int B, int H, int Hkv, int Sq, int Sk, int D, float scale, int causal,
    void* stream) {
  (void)causal;
  return dlr::launch_dq<float, false, true>(q, k, v, dout, lse, delta, dq, B,
                                            H, Hkv, Sq, Sk, D, scale, 1,
                                            stream, nullptr, nullptr,
                                            prefix_len);
}

DLR_DEFINE_ERROR_STRING(dlr_flash_bwd_dq_error)

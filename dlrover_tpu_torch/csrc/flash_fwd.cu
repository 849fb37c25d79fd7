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
// Design: one block per (q tile, head, batch). The Pallas grid walks the
// k tiles in order on one core and carries m/l/acc in VMEM scratch;
// here that sequential dimension is a loop inside the block, with the
// running state in registers (m, l: one row per 4 or 8 threads) and
// shared memory (the f32 accumulator). The products use the tensor
// cores through WMMA; q tiles with the most causal work are scheduled
// first (blockIdx.x runs from the last tile down).

#include "flash_common.cuh"

namespace dlr {

template <typename T>
size_t fwd_smem_bytes(int D) {
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK, PAD = Tile<T>::PAD;
  const int ldt = D + PAD;
  return round128(sizeof(T) * BQ * ldt)        // Q
         + 2 * round128(sizeof(T) * BK * ldt)  // K, V
         + round128(sizeof(float) * BQ * (BK + kFPad))  // S
         + round128(sizeof(T) * BQ * (BK + PAD))        // P
         + round128(sizeof(float) * BQ * (D + kFPad));  // O accumulator
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
                     int D, float scale, int causal) {
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

  const size_t q_row0 = ((size_t)b * H + h) * Sq + (size_t)i * BQ;
  const T* k_head = k + ((size_t)b * Hkv + hk) * Sk * D;
  const T* v_head = v + ((size_t)b * Hkv + hk) * Sk * D;
  load_tile(sQ, ldt, q + q_row0 * D, min(BQ, Sq - i * BQ), BQ, D);
  zero_f32(sO, ldo, BQ, D);

  const int r = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int row = i * BQ + r;
  float m_run = kNegInf, l_run = 0.f;
  int nkt = (Sk + BK - 1) / BK;
  if (causal) nkt = min(nkt, (i * BQ + BQ - 1) / BK + 1);

  for (int j = 0; j < nkt; ++j) {
    __syncthreads();  // the previous tile's readers of sK/sV/sP are done
    const int kvalid = min(BK, Sk - j * BK);
    load_tile(sK, ldt, k_head + (size_t)j * BK * D, kvalid, BK, D);
    load_tile(sV, ldt, v_head + (size_t)j * BK * D, kvalid, BK, D);
    __syncthreads();
    tile_mma<false, true>(sQ, ldt, sK, ldt, sS, lds, BQ, BK, D, false);
    __syncthreads();

    float s[COLS];
    float mx = kNegInf;
#pragma unroll
    for (int t = 0; t < COLS; ++t) {
      const int c = lane + t * LANES, col = j * BK + c;
      const bool ok = col < Sk && (!causal || col <= row);
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

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int Hkv, int Sq, int Sk, int D,
               float scale, int causal, void* stream) {
  const dim3 grid((Sq + Tile<T>::BQ - 1) / Tile<T>::BQ, H, B);
  return launch(flash_fwd_kernel<T>, grid, fwd_smem_bytes<T>(D), stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<T*>(o), lse, H, Hkv,
                Sq, Sk, D, scale, causal);
}

}  // namespace dlr

extern "C" int dlr_flash_fwd_bf16(const void* q, const void* k,
                                  const void* v, void* o, float* lse, int B,
                                  int H, int Hkv, int Sq, int Sk, int D,
                                  float scale, int causal, void* stream) {
  return dlr::launch_fwd<__nv_bfloat16>(q, k, v, o, lse, B, H, Hkv, Sq, Sk,
                                        D, scale, causal, stream);
}

extern "C" int dlr_flash_fwd_f32(const void* q, const void* k, const void* v,
                                 void* o, float* lse, int B, int H, int Hkv,
                                 int Sq, int Sk, int D, float scale,
                                 int causal, void* stream) {
  return dlr::launch_fwd<float>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, D,
                                scale, causal, stream);
}

DLR_DEFINE_ERROR_STRING(dlr_flash_fwd_error)

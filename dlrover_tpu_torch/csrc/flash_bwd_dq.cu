// B3: flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces dlrover_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel
// (launched from _flash_backward): with p recomputed from the saved
// logsumexp as in the dKV kernel,
//   dS = p * (dO V^T - delta) * scale,   dQ += dS K,
// over the k tiles at or left of the diagonal, reading the group's
// shared KV head.
//
// Bound on the H100: operations. Three products per visible (q, k)
// pair: 206 GFLOP at the main path's shape (H=32, H_kv=8, S=4096,
// D=128, bf16, causal), 0.208 ms at 989 TFLOP/s.
//
// Design: one block per (q tile, head, batch), looping over k tiles
// (the TPU grid's sequential innermost dimension) with dQ accumulated
// in f32 shared memory; every dQ tile has a single writer. The heaviest
// causal q tiles are scheduled first.

#include "flash_common.cuh"

namespace dlr {

template <typename T>
size_t dq_smem_bytes(int D) {
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK, PAD = Tile<T>::PAD;
  const int ldt = D + PAD;
  return 2 * round128(sizeof(T) * BQ * ldt)                 // Q, dO
         + 2 * round128(sizeof(T) * BK * ldt)               // K, V
         + 2 * round128(sizeof(float) * BQ * (BK + kFPad))  // S, dP|dS
         + round128(sizeof(float) * BQ * (D + kFPad))       // dQ acc
         + 2 * round128(sizeof(float) * BQ);                // lse, delta
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int H, int Hkv, int Sq, int Sk, int D, float scale,
                        int causal) {
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
  T* sdS = reinterpret_cast<T*>(sdP);

  const size_t q_row0 = ((size_t)b * H + h) * Sq + (size_t)i * BQ;
  const int qvalid = min(BQ, Sq - i * BQ);
  load_tile(sQ, ldt, q + q_row0 * D, qvalid, BQ, D);
  load_tile(sdO, ldt, dout + q_row0 * D, qvalid, BQ, D);
  load_rows(sLse, lse + q_row0, qvalid, BQ);
  load_rows(sDelta, delta + q_row0, qvalid, BQ);
  zero_f32(sdQ, lda, BQ, D);

  const T* k_head = k + ((size_t)b * Hkv + hk) * Sk * D;
  const T* v_head = v + ((size_t)b * Hkv + hk) * Sk * D;
  int nkt = (Sk + BK - 1) / BK;
  if (causal) nkt = min(nkt, (i * BQ + BQ - 1) / BK + 1);

  for (int j = 0; j < nkt; ++j) {
    __syncthreads();
    const int kvalid = min(BK, Sk - j * BK);
    load_tile(sK, ldt, k_head + (size_t)j * BK * D, kvalid, BK, D);
    load_tile(sV, ldt, v_head + (size_t)j * BK * D, kvalid, BK, D);
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
      const bool ok = row < Sq && col < Sk && (!causal || col <= row);
      const float p = ok ? expf(sS[r * lds + c] * scale - sLse[r]) : 0.f;
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

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int H,
              int Hkv, int Sq, int Sk, int D, float scale, int causal,
              void* stream) {
  const dim3 grid((Sq + Tile<T>::BQ - 1) / Tile<T>::BQ, H, B);
  return launch(flash_bwd_dq_kernel<T>, grid, dq_smem_bytes<T>(D), stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                delta, static_cast<T*>(dq), H, Hkv, Sq, Sk, D, scale, causal);
}

}  // namespace dlr

extern "C" int dlr_flash_bwd_dq_bf16(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dq, int B, int H, int Hkv, int Sq,
                                     int Sk, int D, float scale, int causal,
                                     void* stream) {
  return dlr::launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, B, H,
                                       Hkv, Sq, Sk, D, scale, causal, stream);
}

extern "C" int dlr_flash_bwd_dq_f32(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    void* dq, int B, int H, int Hkv, int Sq,
                                    int Sk, int D, float scale, int causal,
                                    void* stream) {
  return dlr::launch_dq<float>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Sq,
                               Sk, D, scale, causal, stream);
}

DLR_DEFINE_ERROR_STRING(dlr_flash_bwd_dq_error)

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
// Design: one block per (k tile, KV head, batch). The TPU grid
// (b, h_kv, j, g, i) keeps dK/dV in VMEM scratch while its two innermost
// dimensions run in order; CUDA blocks run in no order, so both of those
// dimensions become loops inside the block. Each dK/dV tile then has a
// single writer, accumulated in f32 shared memory, with no atomics and
// no second pass. The probability and dS tiles are written in the input
// type over the f32 S/dP tiles they come from (after a barrier), which
// keeps the f32 path inside the shared-memory limit.

#include "flash_common.cuh"

namespace dlr {

template <typename T>
size_t dkv_smem_bytes(int D) {
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK, PAD = Tile<T>::PAD;
  const int ldt = D + PAD;
  return 2 * round128(sizeof(T) * BK * ldt)                 // K, V
         + 2 * round128(sizeof(T) * BQ * ldt)               // Q, dO
         + 2 * round128(sizeof(float) * BQ * (BK + kFPad))  // S|P, dP|dS
         + 2 * round128(sizeof(float) * BK * (D + kFPad))   // dK, dV acc
         + 2 * round128(sizeof(float) * BQ);                // lse, delta
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int Hkv, int Sq, int Sk,
                         int D, float scale, int causal) {
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
  // P and dS in the input type, over the f32 tiles they are made from
  T* sP = reinterpret_cast<T*>(sS);
  T* sdS = reinterpret_cast<T*>(sdP);

  const size_t kv_row0 = ((size_t)b * Hkv + hk) * Sk + (size_t)j * BK;
  const int kvalid = min(BK, Sk - j * BK);
  load_tile(sK, ldt, k + kv_row0 * D, kvalid, BK, D);
  load_tile(sV, ldt, v + kv_row0 * D, kvalid, BK, D);
  zero_f32(sdK, lda, BK, D);
  zero_f32(sdV, lda, BK, D);

  const int nqt = (Sq + BQ - 1) / BQ;
  // q tiles strictly above this k tile's diagonal see none of its keys
  const int i0 = causal ? (j * BK) / BQ : 0;

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
        const bool ok = row < Sq && col < Sk && (!causal || col <= row);
        p[e] = ok ? expf(sS[r * lds + c] * scale - sLse[r]) : 0.f;
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

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int H, int Hkv, int Sq, int Sk, int D, float scale,
               int causal, void* stream) {
  const dim3 grid((Sk + Tile<T>::BK - 1) / Tile<T>::BK, Hkv, B);
  return launch(flash_bwd_dkv_kernel<T>, grid, dkv_smem_bytes<T>(D), stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                delta, static_cast<T*>(dk), static_cast<T*>(dv), H, Hkv, Sq,
                Sk, D, scale, causal);
}

}  // namespace dlr

extern "C" int dlr_flash_bwd_dkv_bf16(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dk, void* dv, int B, int H,
                                      int Hkv, int Sq, int Sk, int D,
                                      float scale, int causal, void* stream) {
  return dlr::launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, B,
                                        H, Hkv, Sq, Sk, D, scale, causal,
                                        stream);
}

extern "C" int dlr_flash_bwd_dkv_f32(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dk, void* dv, int B, int H,
                                     int Hkv, int Sq, int Sk, int D,
                                     float scale, int causal, void* stream) {
  return dlr::launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv,
                                Sq, Sk, D, scale, causal, stream);
}

DLR_DEFINE_ERROR_STRING(dlr_flash_bwd_dkv_error)

// Shared building blocks of the f32 flash-attention kernels, the parity
// paths of the forward (flash_fwd.cu), dK/dV (flash_bwd_dkv.cu) and dQ
// (flash_bwd_dq.cu). The bf16 paths of all three are wgmma kernels built
// on hopper_common.cuh instead. The grouped-matmul kernels
// (grouped_common.cuh) take only its includes and its error-string
// macro.
//
// Layout: q/o/dq [B, H, Sq, D], k/v/dk/dv [B, H_kv, Sk, D], lse/delta
// [B, H, Sq] f32, all contiguous. Query head h reads KV head
// h / (H / H_kv).
//
// Tiles are staged in shared memory, and products run as scalar f32 FMA
// with every accumulator in shared memory. That keeps the parity path
// simple and its arithmetic easy to follow.
//
// Ragged tails: a tile row past the end of the sequence is loaded as
// zeros and masked out of every softmax and gradient, so no sequence
// length has to be a multiple of the tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace dlr {

constexpr int kThreads = 256;  // 8 warps per block
constexpr float kNegInf = -FLT_MAX;  // finfo(float32).min, as the TPU kernels
constexpr int kFPad = 4;  // f32 row padding (elements)

// Tile shape per element type: 32x32 f32 tiles, so the dKV kernel's eight
// f32 buffers fit in the 227 KB a block may use.
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int BQ = 32, BK = 32, PAD = 4;
};

__host__ __device__ constexpr size_t round128(size_t n) {
  return (n + 127) / 128 * 128;
}

// Bump allocator over the dynamic shared memory; the host computes the
// same sizes with the same round128, so the two cannot disagree.
struct SmemCarve {
  unsigned char* p;
  template <typename X>
  __device__ X* take(size_t n) {
    X* r = reinterpret_cast<X*>(p);
    p += round128(n * sizeof(X));
    return r;
  }
};

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype
}

// Copy `rows` rows of D elements from global (row stride D) to shared
// memory (row stride ld), in 16-byte chunks; rows >= valid are zeros.
template <typename T>
__device__ void load_tile(T* dst, int ld, const T* src, int valid, int rows,
                          int D) {
  constexpr int V = 16 / sizeof(T);
  const int chunks = D / V;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
    const int r = idx / chunks, c = (idx % chunks) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

__device__ inline void zero_f32(float* dst, int ld, int rows, int cols) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
    dst[(idx / cols) * ld + idx % cols] = 0.f;
  }
}

// Per-row f32 vector (lse or delta) for one q tile; rows past the end
// read as 0 (those rows are masked anyway).
__device__ inline void load_rows(float* dst, const float* src, int valid,
                                 int rows) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    dst[r] = r < valid ? src[r] : 0.f;
  }
}

// C[M][N] (f32, shared, ldc) = (acc ? C : 0) + op(A) op(B), where
// op(A) is [M][K] (stored [K][M] when TA) and op(B) is [K][N] (stored
// [N][K] when TB): one output element per thread at a time, scalar FMA.
template <bool TA, bool TB>
__device__ void tile_mma(const float* A, int lda, const float* B, int ldb,
                         float* C, int ldc, int M, int N, int K, bool acc) {
  for (int idx = threadIdx.x; idx < M * N; idx += blockDim.x) {
    const int m = idx / N, n = idx % N;
    float s = acc ? C[m * ldc + n] : 0.f;
    for (int k = 0; k < K; ++k) {
      const float a = TA ? A[k * lda + m] : A[m * lda + k];
      const float b = TB ? B[n * ldb + k] : B[k * ldb + n];
      s = fmaf(a, b, s);
    }
    C[m * ldc + n] = s;
  }
}

// Reductions over the `lanes` consecutive threads that share one row.
template <int lanes>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = lanes / 2; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}
template <int lanes>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = lanes / 2; o > 0; o >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, o);
  }
  return x;
}

// Set the dynamic shared-memory limit and launch; returns the first
// CUDA error (0 when the launch was accepted).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, void* stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return (int)cudaGetLastError();
}

}  // namespace dlr

// The error text of a code returned by a launcher.
#define DLR_DEFINE_ERROR_STRING(name)                 \
  extern "C" const char* name(int code) {             \
    return cudaGetErrorString((cudaError_t)code);     \
  }

// Building blocks shared by the flash attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Tiles: a warpgroup or block owns kBlockQ query rows (forward, dq) or kBlockK key rows
// (dk/dv), four warps, each warp a band of kBand = 16 rows. Two families of kernels use them:
//  - bf16: products on the tensor cores by `wgmma` (hopper.cuh) with fp32 accumulation; a
//    band's scores, probabilities, dS and accumulators stay in registers in the m16n8
//    accumulator layout (lane l holds rows l/4 and l/4 + 8, columns 2(l%4) and 2(l%4)+1 of
//    each 8-column tile), and p or dS become the next product's A operand in place
//    (`to_a`), rounded to bf16 there;
//  - fp32: products on the CUDA cores (`WarpAcc`, `warp_mma`: the tensor cores have no
//    full-precision fp32 path), a band's element-wise work through shared memory, lanes 2r
//    and 2r+1 owning row r.
//
// Rounding follows the TPU kernels: bf16 operands, fp32 sums, the scale on the fp32 scores,
// p and dS rounded to the operand type before they enter a product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBand = 16;  // rows per warp
constexpr float kNegInf = -1e30f;
constexpr float kMInit = -5e29f;  // flash_attention.py M_INIT = NEG_INF / 2
constexpr float kPenalty = 1e30f;  // a masked key's score gets (0 - 1) * 1e30 added
static_assert(kBlockQ == kWarps * kBand && kBlockK == kWarps * kBand, "one band per warp");

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as PyTorch and XLA round
}

__host__ __device__ constexpr int align128(long long bytes) {
  return static_cast<int>((bytes + 127) / 128 * 128);
}

// leading dimension, in elements, of a shared-memory fp32 tile of `cols` columns: rows padded
// by 16 bytes, so rows start on distinct banks and every row stays 16-byte aligned
__host__ __device__ constexpr int padded_f32(int cols) { return cols + 4; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// `rows` rows of D elements from global memory (row stride `stride` elements) into a shared
// tile of leading dimension `ld`, 16 bytes per copy, neighbouring threads on neighbouring
// addresses. The whole block calls it.
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* smem, int ld, const T* gmem, long long stride,
                                          int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * kVec;
    cp_async16(smem + r * ld + col, gmem + r * stride + col);
  }
}

// ---- fp32: CUDA-core products ---------------------------------------------------------

// A warp's fp32 accumulator of a 16 x N band, held in registers.
template <int N> struct WarpAcc {
  static_assert(N % 32 == 0, "the fp32 band splits its columns over the 32 lanes");
  float v[kBand][N / 32];  // lane l holds columns l, l + 32, ...
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kBand; ++i)
#pragma unroll
      for (int c = 0; c < N / 32; ++c) v[i][c] = 0.f;
  }
  __device__ __forceinline__ void load(const float* src, int ldc) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < kBand; ++i)
#pragma unroll
      for (int c = 0; c < N / 32; ++c) v[i][c] = src[i * ldc + lane + 32 * c];
  }
  __device__ __forceinline__ void store(float* dst, int ldc) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < kBand; ++i)
#pragma unroll
      for (int c = 0; c < N / 32; ++c) dst[i * ldc + lane + 32 * c] = v[i][c];
  }
};

// acc[16 x N] += A[16 x K] . B[K x N], called by one warp. A is row-major (leading dimension
// lda). B's element (k, n) is at B[k * ldb + n], or at B[n * ldb + k] when kBT (B given as
// the row-major tile of its transpose: the K rows of Q.K^T, say). Operands in shared memory.
template <bool kBT, int N, int K>
__device__ __forceinline__ void warp_mma(WarpAcc<N>& acc, const float* A, int lda,
                                         const float* B, int ldb) {
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float b[N / 32];
#pragma unroll
    for (int c = 0; c < N / 32; ++c)
      b[c] = kBT ? B[(lane + 32 * c) * ldb + k] : B[k * ldb + lane + 32 * c];
#pragma unroll
    for (int i = 0; i < kBand; ++i) {
      const float a = A[i * lda + k];
#pragma unroll
      for (int c = 0; c < N / 32; ++c) acc.v[i][c] = fmaf(a, b[c], acc.v[i][c]);
    }
  }
}

// ---- bf16: register fragments of the tensor-core products --------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulators of 8-column tiles 2kk and 2kk+1 as the A operand of k-step kk, rounded to
// bf16: the accumulator layout of two m16n8 tiles is the A layout of one m16k16 step.
template <int NT>
__device__ __forceinline__ void to_a(uint32_t (&a)[NT / 2][4], const float (&c)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    a[kk][0] = pack_bf16x2(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16x2(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16x2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16x2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

// Stores a band's bf16 rows from the first NT of its NA accumulator tiles (NA > NT where the
// tile is wider than the head dim), each divided by its row's `div` (1 for none): rows `row`
// and `row + 8` of the lane at `dst` (row stride `stride` elements).
template <int NT, int NA>
__device__ __forceinline__ void store_rows(bf16* dst, long long stride, const float (&c)[NA][4],
                                           const float (&div)[2]) {
  static_assert(NT <= NA, "the stored columns lie inside the tile");
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      *reinterpret_cast<uint32_t*>(dst + r * 8 * stride + n * 8 + 2 * t) =
          pack_bf16x2(c[n][2 * r] / div[r], c[n][2 * r + 1] / div[r]);
    }
  }
}

// ---- both -----------------------------------------------------------------------------------

// The score recipe of all three kernels, on one fp32 product: times the scale, plus the
// additive bias (kBias), NEG_INF where the key lies after the query (causal), plus the key's
// mask penalty (0 or -1e30).
template <bool kBias>
__device__ __forceinline__ float score(float qk, float scale, float bias, bool causal, int q_pos,
                                       int k_pos, bool masked, float penalty) {
  float s = qk * scale;
  if (kBias) s += bias;
  if (causal && k_pos > q_pos) s = kNegInf;
  if (masked) s += penalty;
  return s;
}

// The key tiles of `tile` keys that a causal row range sees when its last row may attend key
// index `last` (local, past the row's own index by q_offset - kv_offset in a ring block): zero
// when `last` is negative, a block wholly before its keys (the ring's future blocks).
__device__ __forceinline__ int causal_tiles(int last, int tile) {
  return (max(last + 1, 0) + tile - 1) / tile;
}

__device__ __forceinline__ float mask_penalty(const int* mask, long long index) {
  return (static_cast<float>(mask[index]) - 1.f) * kPenalty;
}

}  // namespace flash

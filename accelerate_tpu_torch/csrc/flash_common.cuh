// Building blocks shared by the flash attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Tiles: a block owns kBlockQ query rows (forward, dq) or kBlockK key rows (dk/dv), four
// warps, each warp a band of kBand = 16 rows. Two families of kernels use them:
//  - bf16: products on the tensor cores by `mma.sync` m16n8k16 with fp32 accumulation,
//    operands from shared memory by `ldmatrix`; a band's scores, probabilities, dS and
//    accumulators stay in registers in the m16n8 accumulator layout (lane l holds rows l/4
//    and l/4 + 8, columns 2(l%4) and 2(l%4)+1 of each 8-column tile), and p or dS become the
//    next product's A operand in place (`to_a`), rounded to bf16 there;
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

// leading dimension, in elements, of a shared-memory tile of `cols` T columns: rows padded
// by 16 bytes, so rows start on distinct banks and every row stays 16-byte aligned
template <typename T> __host__ __device__ constexpr int padded(int cols) {
  return cols + 16 / static_cast<int>(sizeof(T));
}
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

// ---- bf16: tensor-core fragments -------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A operand of rows 0-15, columns c0..c0+15 of a row-major bf16 band.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* band, int ld, int c0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, band + (lane & 15) * ld + c0 + (lane >> 4) * 8);
}

// The B operands of the 8-column tiles n0 and n0 + 8 over k0..k0+15, from a tile stored with
// one row per n (row n, column k: the K of Q.K^T): b[0..1] for n0, b[2..3] for n0 + 8.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* tile, int ld, int n0,
                                          int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// The same from a tile stored with one row per k (row k, column n: the V of P.V).
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* tile, int ld, int k0,
                                          int n0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
}

// acc[16 x 8 NT] += band[16 x K] . tile^T, the band row-major and the tile one row per n
// (Q.K^T, dO.V^T, and their transposes K.Q^T, V.dO^T).
template <int NT, int K>
__device__ __forceinline__ void band_mma_nk(float (&acc)[NT][4], const bf16* band, int lda,
                                            const bf16* tile, int ldb) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    load_a(a, band, lda, kk * 16);
#pragma unroll
    for (int n = 0; n < NT / 2; ++n) {
      uint32_t b[4];
      load_b_nk(b, tile, ldb, n * 16, kk * 16);
      mma16816(acc[2 * n], a, b[0], b[1]);
      mma16816(acc[2 * n + 1], a, b[2], b[3]);
    }
  }
}

// acc[16 x 8 NT] += A[16 x 16 KT] . tile, A already in registers (from `to_a`), the tile one
// row per k (P.V, dS.K, P^T.dO, dS^T.Q).
template <int NT, int KT>
__device__ __forceinline__ void reg_mma_kn(float (&acc)[NT][4], const uint32_t (&a)[KT][4],
                                           const bf16* tile, int ldb) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
    for (int n = 0; n < NT / 2; ++n) {
      uint32_t b[4];
      load_b_kn(b, tile, ldb, kk * 16, n * 16);
      mma16816(acc[2 * n], a[kk], b[0], b[1]);
      mma16816(acc[2 * n + 1], a[kk], b[2], b[3]);
    }
  }
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

// Stores a band's bf16 rows from its accumulators, each divided by its row's `div` (1 for
// none): rows `row` and `row + 8` of the lane at `dst` (row stride `stride` elements).
template <int NT>
__device__ __forceinline__ void store_rows(bf16* dst, long long stride, const float (&c)[NT][4],
                                           const float (&div)[2]) {
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

// The score recipe of all three kernels, on one fp32 product: times the scale, NEG_INF where
// the key lies after the query (causal), plus the key's mask penalty (0 or -1e30).
__device__ __forceinline__ float score(float qk, float scale, bool causal, int q_pos, int k_pos,
                                       bool masked, float penalty) {
  float s = qk * scale;
  if (causal && k_pos > q_pos) s = kNegInf;
  if (masked) s += penalty;
  return s;
}

__device__ __forceinline__ float mask_penalty(const int* mask, long long index) {
  return (static_cast<float>(mask[index]) - 1.f) * kPenalty;
}

}  // namespace flash

// Fused int8/int4 dequant-matmul for Hopper (sm_90a): out = x @ dequantize(w).
//
// Replaces the Pallas TPU kernel `_matmul_kernel` (accelerate_tpu/ops/quant_matmul.py). x is
// [M, K] in fp32 or bf16; w is int8 [K, N], or int4 [K/2, N] with row 2i in the low nibble and
// row 2i + 1 in the high nibble of packed row i; scale is fp32 [N]; out is [M, N] in x's dtype.
// Every weight element is dequantized where it is used: widen the int8 (or the sign-extended
// nibble) to fp32, multiply by the column scale, round to x's dtype (the TPU kernel's rounding,
// `(wq * s).astype(x.dtype)`), and multiply-add in fp32 (bf16 products are exact in fp32). Each
// block owns one output tile and loops over K; its outputs are rounded to x's dtype once at the
// end. No dequantized copy of the weight ever exists outside a block's registers or shared memory.
//
// Bound: at decode batch sizes (M = 8 .. 64) the weight read, K * N bytes (int8) or K * N / 2
// (int4) at 3.35 TB/s; at prefill sizes (M of hundreds) the 2 * M * K * N flops. This first
// kernel multiplies on the CUDA cores, with two tilings picked by M:
//
// - M <= 64 (decode batches, verify windows, prefill chunks): the weight read is what costs, so
//   the block keeps many weight bytes in flight. A block owns 8 rows x 32 columns; its 256
//   threads are 4 column groups of 8 columns x 64 lanes that split K. K goes in chunks of 512
//   packed rows: each thread reads 8 weight bytes per packed row in one load (8 columns; for
//   int4 two K rows of them), 8 rows a chunk, and the next chunk's loads are issued before this
//   chunk's math. The block's 8 x rows for the chunk are staged in shared memory (read from
//   device memory in the loop, they stalled every thread on cache latency). Dequantization
//   avoids the quarter-rate conversion unit: a byte permute puts q + 128 (or the nibble + 8)
//   into a float's mantissa, and bf16 rounding goes two values at a time. Each thread keeps
//   8 x 8 fp32 sums in registers; at the end the 64 lanes' sums are added (warp shuffles, then
//   shared memory). Larger M re-reads the weight once per 8 rows, mostly from L2.
// - M > 64: 64 x 64 tiles looping over K in 32-deep steps. x's tile (transposed, fp32) and the
//   dequantized weight tile are staged in shared memory; each thread accumulates 4 x 4 outputs.
//   The next K step's elements are read into registers while the current step multiplies.
//
// Every M, K and N is taken: loads and stores check their bounds (N = 5504 and K = 5504 are no
// multiple of 64), and the 8-byte weight loads fall back to byte loads where N is no multiple
// of 8 or the weight is not 8-byte aligned. Not yet here: tensor cores (mma.sync / wgmma on the
// dequantized tile), TMA, and split-K for the grids that leave SMs idle (N = 2048 at M = 8 gives
// 64 blocks).
//
// Launch rules: the kernel runs on the caller's stream, allocates nothing and does not
// synchronise. The C entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float<T>(from_float<T>(x));
}

// logical weight row k, column n, as a signed integer
template <int BITS>
__device__ __forceinline__ int weight_at(const int8_t* __restrict__ w, int k, int n, int N);
template <>
__device__ __forceinline__ int weight_at<8>(const int8_t* __restrict__ w, int k, int n, int N) {
  return w[static_cast<size_t>(k) * N + n];
}
template <>
__device__ __forceinline__ int weight_at<4>(const int8_t* __restrict__ w, int k, int n, int N) {
  const int8_t b = w[static_cast<size_t>(k >> 1) * N + n];
  // arithmetic shifts of a signed byte sign-extend each nibble (utils/quantization.unpack_int4)
  return (k & 1) ? (b >> 4) : (static_cast<int8_t>(b << 4) >> 4);
}

template <int BM, int BN, int BK, int TM, int TN>
struct Tiling {
  static constexpr int kThreadsN = BN / TN;
  static constexpr int kThreads = (BM / TM) * kThreadsN;
  static constexpr int kXStride = BM + 1;  // padded: the transposed x stores hit distinct banks
  static constexpr int kXLoads = BM * BK / kThreads;  // x elements each thread stages per step
  static constexpr int kWLoads = BK * BN / kThreads;  // weight elements each thread stages per step
  static_assert(BM * BK % kThreads == 0 && BK * BN % kThreads == 0, "tiles must split evenly");
};

template <typename T, int BITS, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(Tiling<BM, BN, BK, TM, TN>::kThreads) quant_matmul_kernel(
    const T* __restrict__ x,         // [M, K]
    const int8_t* __restrict__ w,    // [K, N] int8 or [K / 2, N] packed int4
    const float* __restrict__ scale, // [N]
    T* __restrict__ out,             // [M, N]
    int M, int K, int N) {
  using G = Tiling<BM, BN, BK, TM, TN>;
  __shared__ float xs[BK * G::kXStride];  // [BK][BM + 1]: x tile, transposed
  __shared__ float ws[BK * BN];           // [BK][BN]: dequantized weight tile
  __shared__ float sc[BN];                // the tile's column scales

  const int tid = threadIdx.x;
  const int tx = tid % G::kThreadsN;  // columns tx, tx + kThreadsN, ...
  const int ty = tid / G::kThreadsN;  // rows ty * TM .. ty * TM + TM - 1
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  for (int c = tid; c < BN; c += G::kThreads) sc[c] = (n0 + c < N) ? scale[n0 + c] : 0.f;

  // the next step's tiles, read from device memory into registers while the
  // current step multiplies out of shared memory (all loads of a step are issued
  // before any is used: the loops have compile-time trip counts)
  float x_next[G::kXLoads];
  int w_next[G::kWLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int it = 0; it < G::kXLoads; ++it) {
      const int i = tid + it * G::kThreads;
      const int r = i / BK;
      const int c = i - r * BK;  // neighbouring threads read neighbouring x elements
      const int m = m0 + r;
      const int k = k0 + c;
      x_next[it] = (m < M && k < K) ? to_float<T>(x[static_cast<size_t>(m) * K + k]) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < G::kWLoads; ++it) {
      const int i = tid + it * G::kThreads;
      const int r = i / BN;
      const int k = k0 + r;
      const int n = n0 + (i - r * BN);
      w_next[it] = (k < K && n < N) ? weight_at<BITS>(w, k, n, N) : 0;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous step's tiles are consumed (and sc is written)
#pragma unroll
    for (int it = 0; it < G::kXLoads; ++it) {
      const int i = tid + it * G::kThreads;
      const int r = i / BK;
      xs[(i - r * BK) * G::kXStride + r] = x_next[it];
    }
#pragma unroll
    for (int it = 0; it < G::kWLoads; ++it) {
      const int i = tid + it * G::kThreads;
      ws[i] = round_to<T>(static_cast<float>(w_next[it]) * sc[i % BN]);
    }
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk * G::kXStride + ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk * BN + tx + j * G::kThreadsN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * G::kThreadsN;
      if (n < N) out[static_cast<size_t>(m) * N + n] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T, int BITS, int BM, int BN, int BK, int TM, int TN>
cudaError_t launch_tiled(const void* x, const void* w, const float* scale, void* out, int M,
                         int K, int N, cudaStream_t stream) {
  using G = Tiling<BM, BN, BK, TM, TN>;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  quant_matmul_kernel<T, BITS, BM, BN, BK, TM, TN><<<grid, G::kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w), scale, static_cast<T*>(out), M,
      K, N);
  return cudaGetLastError();
}

// the M <= 64 tiling
constexpr int kSkinnyRows = 8;    // output rows a block owns
constexpr int kSkinnyGroups = 4;  // column groups of 8: a block owns 32 columns
constexpr int kSkinnyLanes = 64;  // lanes that split K
constexpr int kSkinnyThreads = kSkinnyGroups * kSkinnyLanes;
constexpr int kSkinnyWarps = kSkinnyThreads / 32;
constexpr int kSkinnyAhead = 8;   // packed rows of a chunk that each thread loads
constexpr int kChunkPacked = kSkinnyLanes * kSkinnyAhead;  // packed rows a chunk covers
static_assert(32 % kSkinnyGroups == 0 && kSkinnyRows * kSkinnyGroups * 8 == kSkinnyThreads,
              "a warp holds whole column groups; one output per thread at the end");

// 8 weight bytes of packed row r from column n (n + 8 <= N when vec; bytes past N read as 0)
__device__ __forceinline__ uint2 load8(const int8_t* __restrict__ w, int r, int n, int N,
                                       bool vec) {
  const int8_t* p = w + static_cast<size_t>(r) * N + n;
  if (vec) return *reinterpret_cast<const uint2*>(p);
  uint32_t word[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (n + j < N) word[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(p[j])) << (8 * (j % 4));
  return make_uint2(word[0], word[1]);
}

// byte j of `biased` holds q + bias (0..255) -> q as a float, exactly. 0x4B000000 is 2^23, so
// the byte lands in the mantissa's low bits: one byte permute and one add, where an
// int-to-float conversion would take the quarter-rate conversion unit.
__device__ __forceinline__ float unbias(uint32_t biased, int j, float bias) {
  return __int_as_float(static_cast<int>(__byte_perm(biased, 0x4B000000u, 0x7440u + j))) -
         (8388608.f + bias);
}

// round two dequantized weights to x's dtype, as the TPU kernel's astype does
template <typename T> __device__ __forceinline__ void round_pair(float& a, float& b);
template <> __device__ __forceinline__ void round_pair<float>(float&, float&) {}
template <> __device__ __forceinline__ void round_pair<__nv_bfloat16>(float& a, float& b) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
  a = __low2float(r);
  b = __high2float(r);
}

template <typename T, int BITS>
__global__ void __launch_bounds__(kSkinnyThreads) quant_matmul_skinny_kernel(
    const T* __restrict__ x,         // [M, K]
    const int8_t* __restrict__ w,    // [K, N] int8 or [K / 2, N] packed int4
    const float* __restrict__ scale, // [N]
    T* __restrict__ out,             // [M, N]
    int M, int K, int N) {
  constexpr int kRowsPer = BITS == 4 ? 2 : 1;  // K rows in one packed row
  constexpr int kChunkRows = kChunkPacked * kRowsPer;
  __shared__ float xs[kSkinnyRows][kChunkRows];  // the block's x rows over one chunk of K
  __shared__ float partial[kSkinnyWarps][kSkinnyRows][kSkinnyGroups * 8];

  const int tid = threadIdx.x;
  const int group = tid % kSkinnyGroups;  // == lane % kSkinnyGroups
  const int lane_k = tid / kSkinnyGroups;
  const int m0 = blockIdx.y * kSkinnyRows;
  const int n = blockIdx.x * (kSkinnyGroups * 8) + group * 8;  // this thread's first column
  const int rows = K / kRowsPer;
  const int chunks = (rows + kChunkPacked - 1) / kChunkPacked;
  const bool vec = N % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 8 == 0;

  float sc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) sc[j] = (n + j < N) ? scale[n + j] : 0.f;
  float acc[kSkinnyRows][8];
#pragma unroll
  for (int i = 0; i < kSkinnyRows; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // thread's packed rows of chunk c: c * kChunkPacked + lane_k + u * kSkinnyLanes
  uint2 next[kSkinnyAhead];
  auto load_chunk = [&](int c) {
#pragma unroll
    for (int u = 0; u < kSkinnyAhead; ++u) {
      const int r = c * kChunkPacked + lane_k + u * kSkinnyLanes;
      next[u] = (n < N && r < rows) ? load8(w, r, n, N, vec) : make_uint2(0u, 0u);
    }
  };
  load_chunk(0);
  for (int c = 0; c < chunks; ++c) {
    const int k0 = c * kChunkRows;
    __syncthreads();  // the previous chunk's x is consumed
    for (int idx = tid; idx < kSkinnyRows * kChunkRows; idx += kSkinnyThreads) {
      const int i = idx / kChunkRows;
      const int kk = idx - i * kChunkRows;
      const int m = m0 + i;
      const int k = k0 + kk;
      xs[i][kk] = (m < M && k < K) ? to_float<T>(x[static_cast<size_t>(m) * K + k]) : 0.f;
    }
    __syncthreads();
    uint2 cur[kSkinnyAhead];
#pragma unroll
    for (int u = 0; u < kSkinnyAhead; ++u) cur[u] = next[u];
    if (c + 1 < chunks) load_chunk(c + 1);  // in flight while this chunk multiplies
#pragma unroll
    for (int u = 0; u < kSkinnyAhead; ++u) {
      const int rr = lane_k + u * kSkinnyLanes;  // packed row within the chunk
      if (c * kChunkPacked + rr >= rows) continue;
#pragma unroll
      for (int h = 0; h < kRowsPer; ++h) {
        // biased bytes: int8 q + 128, or the int4 nibble of row 2r + h (low nibble first) + 8
        uint32_t lo, hi;
        if (BITS == 8) {
          lo = cur[u].x ^ 0x80808080u;
          hi = cur[u].y ^ 0x80808080u;
        } else {
          lo = ((cur[u].x ^ 0x88888888u) >> (4 * h)) & 0x0F0F0F0Fu;
          hi = ((cur[u].y ^ 0x88888888u) >> (4 * h)) & 0x0F0F0F0Fu;
        }
        const float bias = BITS == 8 ? 128.f : 8.f;
        float wf[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wf[j] = unbias(lo, j, bias) * sc[j];
          wf[4 + j] = unbias(hi, j, bias) * sc[4 + j];
        }
#pragma unroll
        for (int j = 0; j < 8; j += 2) round_pair<T>(wf[j], wf[j + 1]);
        const int kk = rr * kRowsPer + h;
#pragma unroll
        for (int i = 0; i < kSkinnyRows; ++i) {
          const float xv = xs[i][kk];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv, wf[j], acc[i][j]);
        }
      }
    }
  }

  // add the K lanes: first the 8 lanes of a warp that share a column group, then the warps
#pragma unroll
  for (int i = 0; i < kSkinnyRows; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int off = kSkinnyGroups; off < 32; off <<= 1)
        acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);
  const int warp = tid / 32;
  if (tid % 32 < kSkinnyGroups) {
#pragma unroll
    for (int i = 0; i < kSkinnyRows; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) partial[warp][i][group * 8 + j] = acc[i][j];
  }
  __syncthreads();
  const int i = tid / (kSkinnyGroups * 8);
  const int col_in_block = tid % (kSkinnyGroups * 8);
  float sum = 0.f;
#pragma unroll
  for (int wp = 0; wp < kSkinnyWarps; ++wp) sum += partial[wp][i][col_in_block];
  const int m = m0 + i;
  const int col = blockIdx.x * (kSkinnyGroups * 8) + col_in_block;
  if (m < M && col < N) out[static_cast<size_t>(m) * N + col] = from_float<T>(sum);
}

template <typename T, int BITS>
cudaError_t launch(const void* x, const void* w, const float* scale, void* out, int M, int K,
                   int N, cudaStream_t stream) {
  if (M <= 64) {  // decode batches, verify windows, prefill chunks: bound by the weight read
    const dim3 grid((N + kSkinnyGroups * 8 - 1) / (kSkinnyGroups * 8),
                    (M + kSkinnyRows - 1) / kSkinnyRows);
    quant_matmul_skinny_kernel<T, BITS><<<grid, kSkinnyThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(w), scale, static_cast<T*>(out), M,
        K, N);
    return cudaGetLastError();
  }
  return launch_tiled<T, BITS, 64, 64, 32, 4, 4>(x, w, scale, out, M, K, N, stream);
}

}  // namespace

extern "C" {

// bits: 8 or 4; dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int quant_matmul(const void* x, const void* w, const void* scale, void* out, int M, int K,
                 int N, int bits, int dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || (bits == 4 && K % 2 != 0)) return cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && bits == 8) return launch<__nv_bfloat16, 8>(x, w, s, out, M, K, N, st);
  if (dtype == 1 && bits == 4) return launch<__nv_bfloat16, 4>(x, w, s, out, M, K, N, st);
  if (dtype == 0 && bits == 8) return launch<float, 8>(x, w, s, out, M, K, N, st);
  if (dtype == 0 && bits == 4) return launch<float, 4>(x, w, s, out, M, K, N, st);
  return cudaErrorInvalidValue;
}

const char* quant_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

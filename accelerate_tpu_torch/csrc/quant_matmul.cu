// Fused int8/int4 dequant-matmul for Hopper (sm_90a): out = x @ dequantize(w).
//
// Replaces the Pallas TPU kernel `_matmul_kernel` (accelerate_tpu/ops/quant_matmul.py). x is
// [M, K] in fp32 or bf16; w is int8 [K, N], or int4 [K/2, N] with row 2i in the low nibble and
// row 2i + 1 in the high nibble of packed row i; scale is fp32 [N]; out is [M, N] in x's dtype.
// Every weight element is dequantized where it is used: widen the int8 (or the sign-extended
// nibble) to fp32, multiply by the column scale, round to x's dtype (the TPU kernel's rounding,
// `(wq * s).astype(x.dtype)`), and multiply-add with fp32 sums (bf16 products are exact in
// fp32). No dequantized copy of the weight ever exists outside a block's registers.
//
// Bound: at decode batch sizes (M = 8 .. 64) the weight read, K * N bytes (int8) or K * N / 2
// (int4) at 3.35 TB/s; at prefill sizes (M of hundreds) the 2 * M * K * N flops.
//
// bf16, every M: the tensor cores, by mma.sync m16n8k16 with fp32 accumulation, on the
// transposed product out^T = dequant(w)^T . x^T ("swap AB"): the weight's N columns fill the
// 16-row A operand and the M tokens the 8-wide B operand, so M = 8 wastes nothing. A block
// owns 128 columns and MT x 8 rows (MT = ceil(M / 8) up to 8; larger M takes more row tiles)
// and one split of K. Its 8 warps are 2 column halves of 64 x 4 K quarters of each stage.
// - Weight stream: a ring of 4 stages of 128 K rows, packed bytes and x's rows together, fed
//   by cp.async 16 bytes a thread; the copies run 3 stages ahead of the math. Rows are
//   XOR-swizzled by 16-byte chunk so the fragment loads hit distinct banks.
// - Dequantization in registers: a thread loads 8 columns x 4 K rows of packed weight (two
//   64-bit shared loads for int4, four for int8), turns each byte into a float with one byte
//   permute and one add (q + 128, or the nibble + 8, lands in a float's mantissa), scales,
//   rounds pairs to bf16 and packs them as A fragments. The fragments' rows and K columns are
//   permuted (thread g holds columns 8g..8g+7, thread t K rows 4t..4t+3) so that those loads
//   are whole 8-byte words; x's B fragment follows the same K permutation, so each output is
//   the same sum in another order.
// - Split-K where the output tiles leave half the 132 SMs idle (N = 2048 at M <= 64 gives 16
//   tiles, N = 5504 43): K splits into as many parts as fill one wave of at most 132 blocks,
//   each streaming several K tiles through its ring (two waves, or more splits, measured
//   slower). Each split writes fp32 partial sums to a workspace [splits, M, N] and a second
//   kernel adds them in split order and rounds each output to bf16 once (a last-block
//   fix-up, which leaves the adding of a tile to one block, measured slower). Inside a block
//   the 4 K quarters are added in a fixed order through shared memory. No atomics: the output
//   is the same bit for bit on every launch. The plan (tiles, splits) is computed by the
//   wrapper (`quant_plan`, ops/quant_matmul.py).
// fp32 keeps the CUDA cores (the tensor cores take fp32 only as TF32, which would change the
// numbers): a skinny tiling for M <= 64 (a block owns 8 rows x 32 columns, 64 lanes split K,
// weight loads kept in flight through registers) and 64 x 64 tiles for larger M.
//
// Every M, K and N is taken: loads and stores check their bounds (N = 5504 and K = 5504 are no
// multiple of 64), rows past K or M read as zero. The 16-byte copies need N a multiple of 16
// (x: K a multiple of 8) and aligned pointers; otherwise the same kernel copies byte by byte
// (bf16), and the fp32 kernel loads the weight byte by byte. Not yet here: wgmma and TMA, a persistent grid,
// and reuse of one dequantized tile by several row tiles at large M (M = 512 dequantizes the
// weight once per 64 rows).
//
// Launch rules: the kernels run on the caller's stream, allocate nothing and do not
// synchronise. The C entry point returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

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

// byte j of `biased` holds q + bias (0..255) -> q as a float, exactly. 0x4B000000 is 2^23, so
// the byte lands in the mantissa's low bits: one byte permute and one add, where an
// int-to-float conversion would take the quarter-rate conversion unit.
__device__ __forceinline__ float unbias(uint32_t biased, int j, float bias) {
  return __int_as_float(static_cast<int>(__byte_perm(biased, 0x4B000000u, 0x7440u + j))) -
         (8388608.f + bias);
}

// ---------------------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------------------

namespace tc {

constexpr int kBN = 128;     // output columns a block owns
constexpr int kBK = 128;     // logical K rows a stage holds
constexpr int kWarpsN = 2;   // 64 columns each
constexpr int kWarpsK = 4;   // 32 K rows of every stage each: two k16 steps
constexpr int kThreads = 32 * kWarpsN * kWarpsK;
constexpr int kStages = 4;

template <int BITS, int MT>
struct Layout {
  static constexpr int kRowsPerByte = 8 / BITS;             // K rows in a packed row
  static constexpr int kWRows = kBK / kRowsPerByte;          // packed rows a stage holds
  static constexpr int kW = kWRows * kBN;                    // weight bytes of a stage
  static constexpr int kX = MT * 8 * kBK * 2;                // x bytes of a stage (bf16)
  static constexpr int kStage = kW + kX;
  static constexpr int kBytes = kStages * kStage;
  static constexpr int kReduce = kWarpsK * MT * 8 * kBN * 4;  // the K quarters' fp32 sums
  static constexpr int kSmem = kBytes > kReduce ? kBytes : kReduce;  // the reduction reuses it
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  // bytes < 16 fills the rest with zeros (here: 0 or 16)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint2 lds64(const unsigned char* p) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
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

// 16-byte chunk positions: a weight row (128 bytes, 8 chunks) swaps chunk pairs by the K-row
// group its fragment loads share (4 packed rows for int8, 2 for int4); an x row (256 bytes,
// 16 chunks) by its row.
template <int BITS>
__device__ __forceinline__ int w_chunk(int row, int chunk) {
  return chunk ^ (2 * ((row / (BITS == 8 ? 4 : 2)) & 3));
}
__device__ __forceinline__ int x_chunk(int row, int chunk) { return chunk ^ (2 * (row & 3)); }

template <int BITS, int MT>
__global__ void __launch_bounds__(kThreads, MT <= 4 ? 2 : 1) quant_matmul_tc_kernel(
    const bf16* __restrict__ x,       // [M, K]
    const int8_t* __restrict__ w,     // [K, N] int8 or [K / 2, N] packed int4
    const float* __restrict__ scale,  // [N]
    bf16* __restrict__ out,           // [M, N], when splits == 1
    float* __restrict__ partial,      // [splits, M, N] fp32, when splits > 1
    int M, int K, int N, int tiles_per_split, int splits, int w_vec, int x_vec) {
  using L = Layout<BITS, MT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wn = warp % kWarpsN;
  const int wk = warp / kWarpsN;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * (MT * 8);
  const int split = blockIdx.z;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int kt0 = split * tiles_per_split;
  const int nkt = min(tiles_per_split, k_tiles - kt0);
  const int prows = K / L::kRowsPerByte;  // packed weight rows

  // one stage: the packed rows of K tile kt, columns n0.., and x's rows m0.. over the tile
  auto load_stage = [&](int kt, int slot) {
    unsigned char* ws = smem + slot * L::kStage;
    unsigned char* xs = ws + L::kW;
    const int pr0 = kt * L::kWRows;
    for (int c = tid; c < L::kWRows * 8; c += kThreads) {
      const int r = c >> 3;
      const int ch = c & 7;
      const int gr = pr0 + r;
      const int gn = n0 + ch * 16;
      unsigned char* dst = ws + r * kBN + w_chunk<BITS>(r, ch) * 16;
      if (w_vec) {  // N % 16 == 0: a chunk is whole or wholly past N
        const bool in = gr < prows && gn < N;
        cp_async16(dst, in ? w + static_cast<size_t>(gr) * N + gn : w, in ? 16 : 0);
      } else {
        for (int b = 0; b < 16; ++b)
          dst[b] = (gr < prows && gn + b < N) ? w[static_cast<size_t>(gr) * N + gn + b] : 0;
      }
    }
    const int k0 = kt * kBK;
    for (int c = tid; c < MT * 8 * 16; c += kThreads) {
      const int r = c >> 4;
      const int ch = c & 15;
      const int gm = m0 + r;
      const int gk = k0 + ch * 8;
      unsigned char* dst = xs + r * (kBK * 2) + x_chunk(r, ch) * 16;
      if (x_vec) {  // K % 8 == 0
        const bool in = gm < M && gk < K;
        cp_async16(dst, in ? x + static_cast<size_t>(gm) * K + gk : x, in ? 16 : 0);
      } else {
        bf16* d = reinterpret_cast<bf16*>(dst);
        for (int e = 0; e < 8; ++e)
          d[e] = (gm < M && gk + e < K) ? x[static_cast<size_t>(gm) * K + gk + e]
                                        : __float2bfloat16(0.f);
      }
    }
  };

  // this thread's 8 columns: n0 + wn * 64 + 8g + e
  const int nc = n0 + wn * 64 + 8 * g;
  float sc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sc[e] = (nc + e < N) ? scale[nc + e] : 0.f;

  // acc[i][mt]: A tile i holds columns nc + 2i (rows g) and nc + 2i + 1 (rows g + 8); B tile
  // mt rows m0 + 8 mt + 2t, + 1
  float acc[4][MT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) acc[i][mt][0] = acc[i][mt][1] = acc[i][mt][2] = acc[i][mt][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nkt) load_stage(kt0 + s, s);
    cp_async_commit();
  }
  for (int it = 0; it < nkt; ++it) {
    cp_async_wait<kStages - 2>();  // tile it has landed for this thread
    __syncthreads();               // ... for every thread, and slot it - 1 is free
    if (it + kStages - 1 < nkt) load_stage(kt0 + it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    const unsigned char* ws = smem + (it % kStages) * L::kStage;
    const unsigned char* xs = ws + L::kW;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int kb = wk * 32 + kk * 16;  // the k16 step's first K row in the stage
      // f[j][e]: K row kb + 4t + j, column nc + e, dequantized (not yet rounded)
      float f[4][8];
      const int chunk = wn * 4 + (g >> 1);
      const int off = (g & 1) * 8;
      if (BITS == 8) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = kb + 4 * t + j;
          const uint2 q = lds64(ws + r * kBN + w_chunk<8>(r, chunk) * 16 + off);
          const uint32_t lo = q.x ^ 0x80808080u;
          const uint32_t hi = q.y ^ 0x80808080u;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            f[j][e] = unbias(lo, e, 128.f) * sc[e];
            f[j][4 + e] = unbias(hi, e, 128.f) * sc[4 + e];
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = kb / 2 + 2 * t + j;  // packed row: K rows 2r (low nibble), 2r + 1
          const uint2 q = lds64(ws + r * kBN + w_chunk<4>(r, chunk) * 16 + off);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t lo = ((q.x ^ 0x88888888u) >> (4 * h)) & 0x0F0F0F0Fu;
            const uint32_t hi = ((q.y ^ 0x88888888u) >> (4 * h)) & 0x0F0F0F0Fu;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              f[2 * j + h][e] = unbias(lo, e, 8.f) * sc[e];
              f[2 * j + h][4 + e] = unbias(hi, e, 8.f) * sc[4 + e];
            }
          }
        }
      }
      // A fragments: row g <- column nc + 2i, row g + 8 <- nc + 2i + 1; K columns 2t, 2t + 1
      // <- K rows 4t, 4t + 1 and 2t + 8, 2t + 9 <- 4t + 2, 4t + 3, rounded to bf16 here
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i][0] = pack_bf16x2(f[0][2 * i], f[1][2 * i]);
        a[i][1] = pack_bf16x2(f[0][2 * i + 1], f[1][2 * i + 1]);
        a[i][2] = pack_bf16x2(f[2][2 * i], f[3][2 * i]);
        a[i][3] = pack_bf16x2(f[2][2 * i + 1], f[3][2 * i + 1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // B fragment, column g <- x row 8 mt + g, K rows 4t .. 4t + 3 (one 8-byte word)
        const int r = mt * 8 + g;
        const int kc = kb + 4 * t;
        const uint2 b = lds64(xs + r * (kBK * 2) + x_chunk(r, kc >> 3) * 16 + (kc & 7) * 2);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma16816(acc[i][mt], a[i], b.x, b.y);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it holds the K quarters' sums now

  float* red = reinterpret_cast<float*>(smem);  // [kWarpsK][MT * 8][kBN]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int nl = wn * 64 + 8 * g + 2 * i + (e >> 1);
        const int ml = mt * 8 + 2 * t + (e & 1);
        red[(wk * MT * 8 + ml) * kBN + nl] = acc[i][mt][e];
      }
  __syncthreads();
  const size_t mn = static_cast<size_t>(M) * N;
  for (int idx = tid; idx < MT * 8 * kBN; idx += kThreads) {
    const int ml = idx / kBN;
    const int nl = idx - ml * kBN;
    const int gm = m0 + ml;
    const int gn = n0 + nl;
    if (gm >= M || gn >= N) continue;
    float sum = red[ml * kBN + nl];
#pragma unroll
    for (int q = 1; q < kWarpsK; ++q) sum += red[(q * MT * 8 + ml) * kBN + nl];
    const size_t o = static_cast<size_t>(gm) * N + gn;
    if (splits == 1)
      out[o] = __float2bfloat16(sum);
    else
      partial[split * mn + o] = sum;
  }
}

// out = bf16(the splits' partial sums added in split order), one output per thread
__global__ void __launch_bounds__(256) splitk_reduce_kernel(const float* __restrict__ partial,
                                                            bf16* __restrict__ out, size_t mn,
                                                            int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= mn) return;
  float sum = partial[i];
  for (int q = 1; q < splits; ++q) sum += partial[q * mn + i];
  out[i] = __float2bfloat16(sum);
}

template <int BITS, int MT>
cudaError_t launch(const void* x, const void* w, const float* scale, void* out, float* partial,
                   int M, int K, int N, int splits, int tiles_per_split, cudaStream_t stream) {
  using L = Layout<BITS, MT>;
  auto kernel = quant_matmul_tc_kernel<BITS, MT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return err;
  const int w_vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int x_vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + MT * 8 - 1) / (MT * 8), splits);
  kernel<<<grid, kThreads, L::kSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(w), scale, static_cast<bf16*>(out),
      partial, M, K, N, tiles_per_split, splits, w_vec, x_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = static_cast<size_t>(M) * N;
  splitk_reduce_kernel<<<static_cast<unsigned>((mn + 255) / 256), 256, 0, stream>>>(
      partial, static_cast<bf16*>(out), mn, splits);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_bits(const void* x, const void* w, const float* scale, void* out,
                        float* partial, int M, int K, int N, int m_tile, int splits,
                        int tiles_per_split, cudaStream_t stream) {
  switch (m_tile) {
    case 8: return launch<BITS, 1>(x, w, scale, out, partial, M, K, N, splits, tiles_per_split, stream);
    case 16: return launch<BITS, 2>(x, w, scale, out, partial, M, K, N, splits, tiles_per_split, stream);
    case 24: return launch<BITS, 3>(x, w, scale, out, partial, M, K, N, splits, tiles_per_split, stream);
    case 32: return launch<BITS, 4>(x, w, scale, out, partial, M, K, N, splits, tiles_per_split, stream);
    case 40: return launch<BITS, 5>(x, w, scale, out, partial, M, K, N, splits, tiles_per_split, stream);
    case 48: return launch<BITS, 6>(x, w, scale, out, partial, M, K, N, splits, tiles_per_split, stream);
    case 56: return launch<BITS, 7>(x, w, scale, out, partial, M, K, N, splits, tiles_per_split, stream);
    case 64: return launch<BITS, 8>(x, w, scale, out, partial, M, K, N, splits, tiles_per_split, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------------------

template <int BM, int BN, int BK, int TM, int TN>
struct Tiling {
  static constexpr int kThreadsN = BN / TN;
  static constexpr int kThreads = (BM / TM) * kThreadsN;
  static constexpr int kXStride = BM + 1;  // padded: the transposed x stores hit distinct banks
  static constexpr int kXLoads = BM * BK / kThreads;  // x elements each thread stages per step
  static constexpr int kWLoads = BK * BN / kThreads;  // weight elements each thread stages per step
  static_assert(BM * BK % kThreads == 0 && BK * BN % kThreads == 0, "tiles must split evenly");
};

template <int BITS, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(Tiling<BM, BN, BK, TM, TN>::kThreads) quant_matmul_kernel(
    const float* __restrict__ x,     // [M, K]
    const int8_t* __restrict__ w,    // [K, N] int8 or [K / 2, N] packed int4
    const float* __restrict__ scale, // [N]
    float* __restrict__ out,         // [M, N]
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
      x_next[it] = (m < M && k < K) ? x[static_cast<size_t>(m) * K + k] : 0.f;
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
      ws[i] = static_cast<float>(w_next[it]) * sc[i % BN];
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
      if (n < N) out[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

template <int BITS, int BM, int BN, int BK, int TM, int TN>
cudaError_t launch_tiled(const void* x, const void* w, const float* scale, void* out, int M,
                         int K, int N, cudaStream_t stream) {
  using G = Tiling<BM, BN, BK, TM, TN>;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  quant_matmul_kernel<BITS, BM, BN, BK, TM, TN><<<grid, G::kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w), scale,
      static_cast<float*>(out), M, K, N);
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

template <int BITS>
__global__ void __launch_bounds__(kSkinnyThreads) quant_matmul_skinny_kernel(
    const float* __restrict__ x,     // [M, K]
    const int8_t* __restrict__ w,    // [K, N] int8 or [K / 2, N] packed int4
    const float* __restrict__ scale, // [N]
    float* __restrict__ out,         // [M, N]
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
      xs[i][kk] = (m < M && k < K) ? x[static_cast<size_t>(m) * K + k] : 0.f;
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
  if (m < M && col < N) out[static_cast<size_t>(m) * N + col] = sum;
}

template <int BITS>
cudaError_t launch_f32(const void* x, const void* w, const float* scale, void* out, int M, int K,
                       int N, cudaStream_t stream) {
  if (M <= 64) {  // decode batches, verify windows, prefill chunks: bound by the weight read
    const dim3 grid((N + kSkinnyGroups * 8 - 1) / (kSkinnyGroups * 8),
                    (M + kSkinnyRows - 1) / kSkinnyRows);
    quant_matmul_skinny_kernel<BITS><<<grid, kSkinnyThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w), scale,
        static_cast<float*>(out), M, K, N);
    return cudaGetLastError();
  }
  return launch_tiled<BITS, 64, 64, 32, 4, 4>(x, w, scale, out, M, K, N, stream);
}

}  // namespace

extern "C" {

// bits: 8 or 4; dtype: 0 = float32, 1 = bfloat16. bf16 takes the plan of
// ops/quant_matmul.py `quant_plan`: m_tile rows a block owns (8 .. 64), `splits` splits of K
// of `tiles_per_split` 128-row tiles each, and, when splits > 1, an fp32 workspace of
// splits x M x N. fp32 takes m_tile = 0, splits = 1. Returns a cudaError_t (0 = launched).
int quant_matmul(const void* x, const void* w, const void* scale, void* out, void* workspace,
                 int M, int K, int N, int bits, int dtype, int m_tile, int splits,
                 int tiles_per_split, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || (bits != 8 && bits != 4) || (bits == 4 && K % 2 != 0))
    return cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (splits != 1) return cudaErrorInvalidValue;
    return bits == 8 ? launch_f32<8>(x, w, s, out, M, K, N, st)
                     : launch_f32<4>(x, w, s, out, M, K, N, st);
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  const int k_tiles = (K + tc::kBK - 1) / tc::kBK;
  // every split owns at least one K tile, and together they cover all of them
  if (splits < 1 || tiles_per_split < 1 || (splits - 1) * tiles_per_split >= k_tiles ||
      splits * tiles_per_split < k_tiles || (splits > 1 && workspace == nullptr))
    return cudaErrorInvalidValue;
  float* ws = static_cast<float*>(workspace);
  return bits == 8 ? tc::launch_bits<8>(x, w, s, out, ws, M, K, N, m_tile, splits,
                                        tiles_per_split, st)
                   : tc::launch_bits<4>(x, w, s, out, ws, M, K, N, m_tile, splits,
                                        tiles_per_split, st);
}

const char* quant_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

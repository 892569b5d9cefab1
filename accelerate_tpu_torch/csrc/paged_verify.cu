// Paged speculative-verify attention for Hopper (sm_90a), one launch per layer per verify step.
//
// Replaces the Pallas TPU kernel `_verify_kernel` (accelerate_tpu/ops/paged_attention.py). It is
// the page walk of csrc/paged_decode.cu with a window axis: each block owns one (slot, kv head)
// pair and W * group query rows, row wi * group + gi being window position wi of query head
// g * group + gi (query head h reads kv head h / group). Every row attends the slot's committed
// positions 0 .. length - 1, walked through its int32 page-table row in tiles of kTile positions
// with an online softmax in fp32. The window's own keys (not in the pool yet: the engine scatters
// the accepted ones after the step) are folded in last under an in-window causal mask: row wi sees
// window keys 0 .. wi. At W = 1 this is the decode kernel's function.
//
// Hazards kept from the decode kernel: positions >= length are never read (NaN may lie in stale
// tails); the running max starts at M_INIT = -5e29, so a length-0 lane attends window keys
// 0 .. wi only; q is scaled in q's dtype; p is rounded to the pool's dtype before each PV product.
//
// Bound: memory. A launch must read sum over slots of length * KV * D * 2 pool elements plus the
// window's q / k / v and write the output; it does 4 flops per pool element per query row, W *
// group rows. Each K/V tile is read once for all W * group rows (the TPU kernel's reason for
// stacking the window into the row axis), through the same cp.async ring as decode. Shared memory
// is sized for W * group rows: 40 rows at the 64/8 GQA layout with k = 4.
// Not yet here: TMA, wgmma for the W * group x kTile score block, split page walks.
//
// Launch rules: the kernel runs on the caller's stream, allocates nothing and does not
// synchronise. The C entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;      // positions per tile; one softmax lane per position (and window key)
constexpr int kStages = 4;     // tiles in flight: the walk is latency-bound
constexpr int kRowPad = 64;    // bytes of padding per shared-memory row
constexpr int kDotLanes = 4;   // lanes sharing one q.k dot product
constexpr int kMaxAcc = 24;    // outputs per thread: W * group * D <= kThreads * kMaxAcc
constexpr float kMInit = -5e29f;  // flash_attention.py M_INIT = NEG_INF / 2
constexpr float kNegInf = -1e30f;

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

// the TPU kernel casts p to the pool (and window) dtype before each PV product
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float<T>(from_float<T>(x));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
struct Geometry {
  static constexpr int kVec = 16 / sizeof(T);                 // elements per 16-byte copy
  static constexpr int kChunks = D / kVec;                    // copies per row
  static constexpr int kRowElems = (D * sizeof(T) + kRowPad) / sizeof(T);
  static constexpr int kTileElems = kTile * kRowElems;
  static_assert(kChunks % kDotLanes == 0, "row must split over the dot lanes");
};

template <typename T, int D>
size_t shared_bytes(int rows, int pps) {
  using G = Geometry<T, D>;
  return 2 * kStages * G::kTileElems * sizeof(T)
       + sizeof(float) * (rows * D + rows * kTile + 3 * rows) + sizeof(int) * pps;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_verify_kernel(
    const T* __restrict__ q,          // [S, W, NH, D]
    const T* __restrict__ k_new,      // [S, W, KV, D]
    const T* __restrict__ v_new,      // [S, W, KV, D]
    const T* __restrict__ pool_k,     // [P, ps, KV, D]
    const T* __restrict__ pool_v,     // [P, ps, KV, D]
    const int* __restrict__ tables,   // [S, pps]
    const int* __restrict__ lengths,  // [S]
    T* __restrict__ out,              // [S, W, NH, D]
    float scale,                      // already rounded to T
    int window, int nh, int kv, int ps, int pps) {
  using G = Geometry<T, D>;
  const int slot = blockIdx.x;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = nh / kv;
  const int rows = window * group;
  const int nout = rows * D;
  const int length = lengths[slot];
  const int* table = tables + static_cast<size_t>(slot) * pps;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);              // [kStages][kTile][kRowElems]
  T* vs = ks + kStages * G::kTileElems;            // [kStages][kTile][kRowElems]
  float* qf = reinterpret_cast<float*>(vs + kStages * G::kTileElems);  // [rows][D]
  float* probs = qf + rows * D;                    // [rows][kTile]
  float* m_s = probs + rows * kTile;               // [rows] running max
  float* l_s = m_s + rows;                         // [rows] running sum
  float* c_s = l_s + rows;                         // [rows] this tile's correction
  int* table_s = reinterpret_cast<int*>(c_s + rows);  // [pps] this slot's walked pages

  // global offset of (window position wi, query head g * group + gi) for row r = wi * group + gi
  auto head_row = [&](int r) -> size_t {
    const int wi = r / group;
    return ((static_cast<size_t>(slot) * window + wi) * nh + static_cast<size_t>(g) * group +
            (r - wi * group)) * D;
  };
  // q * scale rounded to T, as the reference scales q in q's dtype before the product
  for (int i = tid; i < nout; i += kThreads) {
    const int r = i / D;
    qf[i] = round_to<T>(to_float<T>(q[head_row(r) + (i - r * D)]) * scale);
  }
  for (int i = tid; i < rows; i += kThreads) {
    m_s[i] = kMInit;
    l_s[i] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.f;

  const int ntiles = (length + kTile - 1) / kTile;
  for (int j = tid; j < (length + ps - 1) / ps; j += kThreads) table_s[j] = table[j];
  __syncthreads();

  // issue the copies of tile t (positions t*kTile .. min(length, (t+1)*kTile) - 1)
  auto load_tile = [&](int t, int stage) {
    const int base = t * kTile;
    const int nvalid = min(kTile, length - base);
    T* kst = ks + stage * G::kTileElems;
    T* vst = vs + stage * G::kTileElems;
    for (int c = tid; c < nvalid * G::kChunks; c += kThreads) {
      const int r = c / G::kChunks;
      const int col = (c % G::kChunks) * G::kVec;
      const int pos = base + r;
      const int page = table_s[pos / ps];
      const size_t off =
          ((static_cast<size_t>(page) * ps + pos % ps) * kv + g) * D + col;
      cp_async16(kst + r * G::kRowElems + col, pool_k + off);
      cp_async16(vst + r * G::kRowElems + col, pool_v + off);
    }
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) load_tile(t, t);
    cp_async_commit();
  }
  __syncthreads();  // qf, m_s, l_s initialised

  for (int t = 0; t < ntiles; ++t) {
    const int stage = t % kStages;
    const int ahead = t + kStages - 1;
    if (ahead < ntiles) load_tile(ahead, ahead % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this thread's copies of tile t have landed
    __syncthreads();               // and everyone else's
    const int nvalid = min(kTile, length - t * kTile);
    const T* kst = ks + stage * G::kTileElems;
    const T* vst = vs + stage * G::kTileElems;

    // scores: kDotLanes threads per (row, position), each over D / kDotLanes elements
    const int items = rows * nvalid * kDotLanes;
    for (int w0 = 0; w0 < items; w0 += kThreads) {
      const int w = w0 + tid;
      const int pair = w / kDotLanes;
      const int part = w % kDotLanes;
      const int h = pair / max(nvalid, 1);
      const int r = pair - h * nvalid;
      float s = 0.f;
      if (w < items) {
        const float* qh = qf + h * D;
        const T* krow = kst + r * G::kRowElems;
#pragma unroll
        for (int j = 0; j < G::kChunks / kDotLanes; ++j) {
          const int col = (j * kDotLanes + part) * G::kVec;
          alignas(16) T vals[G::kVec];
          *reinterpret_cast<uint4*>(vals) = *reinterpret_cast<const uint4*>(krow + col);
#pragma unroll
          for (int e = 0; e < G::kVec; ++e) s += qh[col + e] * to_float<T>(vals[e]);
        }
      }
#pragma unroll
      for (int o = 1; o < kDotLanes; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (w < items && part == 0) probs[h * kTile + r] = s;
    }
    __syncthreads();

    // online softmax of this tile, one warp per row, one lane per position
    for (int h = warp; h < rows; h += kWarps) {
      const bool valid = lane < nvalid;
      const float s = valid ? probs[h * kTile + lane] : kNegInf;
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float l_tile = warp_sum(p);
      probs[h * kTile + lane] = round_to<T>(p);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        l_s[h] = l_s[h] * c + l_tile;
        m_s[h] = m_new;
        c_s[h] = c;
      }
    }
    __syncthreads();

    // acc = acc * correction + p . V, each thread over its (row, dim) outputs
#pragma unroll
    for (int j = 0; j < kMaxAcc; ++j) {
      const int o = tid + j * kThreads;
      if (o < nout) {
        const int h = o / D;
        const int d = o - h * D;
        const float* ph = probs + h * kTile;
        float a = acc[j] * c_s[h];
        for (int r = 0; r < nvalid; ++r) a += ph[r] * to_float<T>(vst[r * G::kRowElems + d]);
        acc[j] = a;
      }
    }
    __syncthreads();  // tile t's buffers and probs are free for reuse
  }

  // the window block: row r (window position wi) sees window keys 0 .. wi, one warp per row,
  // one lane per window key in the softmax
  const size_t win_base = static_cast<size_t>(slot) * window;
  for (int r = warp; r < rows; r += kWarps) {
    const int wi = r / group;
    for (int j = 0; j <= wi; ++j) {
      const T* kn = k_new + ((win_base + j) * kv + g) * D;
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += qf[r * D + d] * to_float<T>(kn[d]);
      s = warp_sum(s);
      if (lane == 0) probs[r * kTile + j] = s;
    }
    __syncwarp();
    const bool valid = lane <= wi;
    const float s = valid ? probs[r * kTile + lane] : kNegInf;
    __syncwarp();  // every lane has read its score before any lane overwrites it
    const float m_old = m_s[r];
    const float m_new = fmaxf(m_old, warp_max(s));
    const float p = valid ? expf(s - m_new) : 0.f;
    const float l_win = warp_sum(p);
    if (lane < window) probs[r * kTile + lane] = round_to<T>(p);
    if (lane == 0) {
      const float c = expf(m_old - m_new);
      l_s[r] = l_s[r] * c + l_win;
      c_s[r] = c;
    }
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    const int o = tid + j * kThreads;
    if (o < nout) {
      const int r = o / D;
      const int d = o - r * D;
      const int wi = r / group;
      const float* pr = probs + r * kTile;
      float a = acc[j] * c_s[r];
      for (int jw = 0; jw <= wi; ++jw)
        a += pr[jw] * to_float<T>(v_new[((win_base + jw) * kv + g) * D + d]);
      out[head_row(r) + d] = from_float<T>(a / l_s[r]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_new, const void* v_new, const void* pool_k,
                   const void* pool_v, const int* tables, const int* lengths, void* out,
                   float scale, int slots, int window, int nh, int kv, int ps, int pps,
                   cudaStream_t stream) {
  const int rows = window * (nh / kv);
  const size_t smem = shared_bytes<T, D>(rows, pps);
  auto kernel = paged_verify_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(slots, kv);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<const T*>(pool_k), static_cast<const T*>(pool_v), tables, lengths,
      static_cast<T*>(out), scale, window, nh, kv, ps, pps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int paged_verify_attention(const void* q, const void* k_new, const void* v_new,
                           const void* pool_k, const void* pool_v, const void* tables,
                           const void* lengths, void* out, float scale, int slots, int window,
                           int nh, int kv, int d, int ps, int pps, int dtype, void* stream) {
  if (slots <= 0 || kv <= 0 || nh % kv != 0 || window < 1 || window > kTile ||
      window * (nh / kv) * d > kThreads * kMaxAcc)
    return cudaErrorInvalidValue;
  const int* tab = static_cast<const int*>(tables);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k_new, v_new, pool_k, pool_v, tab, len, out, scale,
                                      slots, window, nh, kv, ps, pps, s);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k_new, v_new, pool_k, pool_v, tab, len, out, scale,
                                     slots, window, nh, kv, ps, pps, s);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k_new, v_new, pool_k, pool_v, tab, len, out, scale, slots,
                              window, nh, kv, ps, pps, s);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k_new, v_new, pool_k, pool_v, tab, len, out, scale, slots,
                             window, nh, kv, ps, pps, s);
  return cudaErrorInvalidValue;
}

const char* paged_verify_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Paged decode attention for Hopper (sm_90a), one launch per layer per decode step.
//
// Replaces the Pallas TPU kernel `_decode_kernel` (accelerate_tpu/ops/paged_attention.py).
// Each block owns one (slot, kv head) pair and the `group = NH / KV` query heads that
// share it (query head h reads kv head h / group). It walks the slot's int32 page-table
// row up to `length` in tiles of kTile positions, runs an online softmax in fp32, and
// folds the current token's k_new / v_new in as the final key. Positions >= length are
// never read, which is what the TPU kernel's NEG_INF mask gives them: exactly zero weight.
// The running max starts at M_INIT = -5e29, so a lane with length 0 returns v_new exactly.
//
// Bound: memory. Per launch the kernel must read sum over slots of length * KV * D * 2
// (k and v) elements; the arithmetic is 4 flops per element read. Design against it:
//  - cp.async moves each tile's K and V rows (16 bytes per copy, neighbouring threads on
//    neighbouring addresses) into a ring of kStages tiles in shared memory, so the next
//    kStages - 1 tiles' loads are in flight while the current tile is scored;
//  - the walked table entries are staged in shared memory first, so issuing a copy never
//    waits on a table read;
//  - rows are padded by 64 bytes in shared memory so the four threads that share one
//    dot product and their neighbours hit distinct banks;
//  - scores reduce over four lanes with warp shuffles, the softmax of a tile over one
//    warp per query head.
// Not yet here: TMA, wgmma and splitting a long page walk over several blocks.
//
// Launch rules: the kernel runs on the caller's stream, allocates nothing and does not
// synchronise. The C entry point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;      // positions per tile; one softmax lane per position
constexpr int kStages = 4;     // tiles in flight: the walk is latency-bound
constexpr int kRowPad = 64;    // bytes of padding per shared-memory row
constexpr int kDotLanes = 4;   // lanes sharing one q.k dot product
constexpr int kMaxAcc = 16;    // outputs per thread: group * D <= kThreads * kMaxAcc
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

// the TPU kernel casts p to the pool dtype before the PV product
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
size_t shared_bytes(int group, int pps) {
  using G = Geometry<T, D>;
  return 2 * kStages * G::kTileElems * sizeof(T)
       + sizeof(float) * (group * D + group * kTile + 3 * group) + sizeof(int) * pps;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q,          // [S, NH, D]
    const T* __restrict__ k_new,      // [S, KV, D]
    const T* __restrict__ v_new,      // [S, KV, D]
    const T* __restrict__ pool_k,     // [P, ps, KV, D]
    const T* __restrict__ pool_v,     // [P, ps, KV, D]
    const int* __restrict__ tables,   // [S, pps]
    const int* __restrict__ lengths,  // [S]
    T* __restrict__ out,              // [S, NH, D]
    float scale,                      // already rounded to T
    int nh, int kv, int ps, int pps) {
  using G = Geometry<T, D>;
  const int slot = blockIdx.x;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = nh / kv;
  const int nout = group * D;
  const int length = lengths[slot];
  const int* table = tables + static_cast<size_t>(slot) * pps;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);              // [kStages][kTile][kRowElems]
  T* vs = ks + kStages * G::kTileElems;            // [kStages][kTile][kRowElems]
  float* qf = reinterpret_cast<float*>(vs + kStages * G::kTileElems);  // [group][D]
  float* probs = qf + group * D;                   // [group][kTile]
  float* m_s = probs + group * kTile;              // [group] running max
  float* l_s = m_s + group;                        // [group] running sum
  float* c_s = l_s + group;                        // [group] this tile's correction
  int* table_s = reinterpret_cast<int*>(c_s + group);  // [pps] this slot's walked pages

  const T* qg = q + (static_cast<size_t>(slot) * nh + static_cast<size_t>(g) * group) * D;
  // q * scale rounded to T, as the reference scales q in q's dtype before the product
  for (int i = tid; i < nout; i += kThreads) qf[i] = round_to<T>(to_float<T>(qg[i]) * scale);
  for (int i = tid; i < group; i += kThreads) {
    m_s[i] = kMInit;
    l_s[i] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.f;

  const int ntiles = (length + kTile - 1) / kTile;
  // the walked part of the table row, so no copy waits on a table read
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

  // prologue: tiles 0 .. kStages - 2 in flight, one commit group each
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) load_tile(t, t);
    cp_async_commit();
  }
  __syncthreads();  // qf, m_s, l_s initialised

  for (int t = 0; t < ntiles; ++t) {
    const int stage = t % kStages;
    // refill the stage tile t - 1 used (freed by the trailing barrier of iteration t - 1)
    const int ahead = t + kStages - 1;
    if (ahead < ntiles) load_tile(ahead, ahead % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this thread's copies of tile t have landed
    __syncthreads();               // and everyone else's
    const int nvalid = min(kTile, length - t * kTile);
    const T* kst = ks + stage * G::kTileElems;
    const T* vst = vs + stage * G::kTileElems;

    // scores: kDotLanes threads per (head, position), each over D / kDotLanes elements
    const int items = group * nvalid * kDotLanes;
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

    // online softmax of this tile, one warp per head, one lane per position
    for (int h = warp; h < group; h += kWarps) {
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

    // acc = acc * correction + p . V, each thread over its (head, dim) outputs
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

  // the current token is not in the pool yet (the engine scatters it after the step):
  // it joins as the final key, one warp per head
  const size_t kv_off = (static_cast<size_t>(slot) * kv + g) * D;
  for (int h = warp; h < group; h += kWarps) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += qf[h * D + d] * to_float<T>(k_new[kv_off + d]);
    s = warp_sum(s);
    if (lane == 0) {
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, s);
      const float c = expf(m_old - m_new);
      const float p = expf(s - m_new);
      l_s[h] = l_s[h] * c + p;
      c_s[h] = c;
      probs[h * kTile] = round_to<T>(p);
    }
  }
  __syncthreads();

  T* og = out + (static_cast<size_t>(slot) * nh + static_cast<size_t>(g) * group) * D;
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    const int o = tid + j * kThreads;
    if (o < nout) {
      const int h = o / D;
      const int d = o - h * D;
      const float a = acc[j] * c_s[h] + probs[h * kTile] * to_float<T>(v_new[kv_off + d]);
      og[o] = from_float<T>(a / l_s[h]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_new, const void* v_new, const void* pool_k,
                   const void* pool_v, const int* tables, const int* lengths, void* out,
                   float scale, int slots, int nh, int kv, int ps, int pps,
                   cudaStream_t stream) {
  const int group = nh / kv;
  const size_t smem = shared_bytes<T, D>(group, pps);
  auto kernel = paged_decode_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(slots, kv);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<const T*>(pool_k), static_cast<const T*>(pool_v), tables, lengths,
      static_cast<T*>(out), scale, nh, kv, ps, pps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int paged_decode_attention(const void* q, const void* k_new, const void* v_new,
                           const void* pool_k, const void* pool_v, const void* tables,
                           const void* lengths, void* out, float scale, int slots, int nh,
                           int kv, int d, int ps, int pps, int dtype, void* stream) {
  if (slots <= 0 || kv <= 0 || nh % kv != 0 || (nh / kv) * d > kThreads * kMaxAcc)
    return cudaErrorInvalidValue;
  const int* tab = static_cast<const int*>(tables);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k_new, v_new, pool_k, pool_v, tab, len, out, scale,
                                      slots, nh, kv, ps, pps, s);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k_new, v_new, pool_k, pool_v, tab, len, out, scale,
                                     slots, nh, kv, ps, pps, s);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k_new, v_new, pool_k, pool_v, tab, len, out, scale, slots, nh,
                              kv, ps, pps, s);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k_new, v_new, pool_k, pool_v, tab, len, out, scale, slots, nh,
                             kv, ps, pps, s);
  return cudaErrorInvalidValue;
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

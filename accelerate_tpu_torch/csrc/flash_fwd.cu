// Flash attention forward for Hopper (sm_90a): out and the row logsumexp, by online softmax.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (accelerate_tpu/ops/flash_attention.py). One
// block owns one (q tile of 64 rows, query head, batch row) and loops over K/V tiles of 64
// keys up to a dynamic bound: the causal limit of its last query row and the last valid key
// of its batch row ([B, T] mask), so future and fully padded tiles are never read. Query
// head h reads kv head h / (NH / KV) (GQA). Every tensor is read in the model zoo's
// [B, S, N, D] layout in place. Per tile, each warp scores its 16 query rows (fp32 sums),
// applies scale, causal limit and mask penalty in fp32, updates its running max m (starting
// at M_INIT = -5e29) and sum l, rounds p = exp(s - m) to the operand type and adds p.V into
// its fp32 output accumulator, rescaled by exp(m_old - m_new). The end writes out = acc /
// max(l, 1e-30) (exactly 0 for a row that saw no valid key) and lse = m + log(max(l,
// 1e-30)), fp32 [B, N, S].
//
// Bound at llama-125m's shapes (D = 64, causal): operations, 4 * D flops per attended
// (q, k) pair at 989 TFLOP/s in bf16 (0.052 ms at B=32, S=1024, N=12), with the bytes of q,
// k, v and out at 3.35 TB/s close behind (0.061 ms). Design against it, bf16: K/V tiles by
// cp.async into two shared-memory stages (the next tile lands while this one is used),
// products on the tensor cores by mma.sync m16n8k16 from ldmatrix fragments, the scores, p
// and the output accumulator in registers (p becomes the A operand of p.V without leaving
// them). fp32 takes CUDA-core FMAs, the band's scores and output through shared memory. Not
// yet here: wgmma and TMA, a persistent schedule that balances the causal triangle.
//
// Launch rules: the kernels run on the caller's stream, allocate nothing and do not
// synchronise. The C entry point returns cudaGetLastError() after the launch.

#include "flash_common.cuh"

namespace {

using namespace flash;

// --------------------------------------------------------------------------------------
// bf16: tensor cores, register-resident band
// --------------------------------------------------------------------------------------

template <int D>
struct Bf16Layout {
  static constexpr int kStages = 2;
  static constexpr int kLd = padded<bf16>(D);
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + align128(2LL * kBlockQ * kLd);
  static constexpr int kV = kK + align128(2LL * kStages * kBlockK * kLd);
  static constexpr int kPen = kV + align128(2LL * kStages * kBlockK * kLd);
  static constexpr int kBytes = kPen + align128(4LL * kStages * kBlockK);
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16_kernel(
    const bf16* __restrict__ q,      // [B, S, NH, D]
    const bf16* __restrict__ k,      // [B, T, KV, D]
    const bf16* __restrict__ v,      // [B, T, KV, D]
    const int* __restrict__ mask,    // [B, T] or null
    const int* __restrict__ limit,   // [B] last valid key, or null
    bf16* __restrict__ out,          // [B, S, NH, D]
    float* __restrict__ lse,         // [B, NH, S]
    int S, int Tk, int NH, int KV, float scale, int causal) {
  using L = Bf16Layout<D>;
  constexpr int kNt = kBlockK / 8;  // 8-column tiles of a score band
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::kQ);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::kV);
  float* pen = reinterpret_cast<float*>(smem + L::kPen);

  const int iq = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (NH / KV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool masked = mask != nullptr;
  const long long q_row = 1LL * NH * D;
  const long long kv_row = 1LL * KV * D;
  const bf16* kg = k + 1LL * b * Tk * kv_row + 1LL * g * D;
  const bf16* vg = v + 1LL * b * Tk * kv_row + 1LL * g * D;

  int nk = Tk / kBlockK;
  if (causal) nk = min(nk, (iq * kBlockQ + kBlockQ + kBlockK - 1) / kBlockK);
  if (masked) nk = min(nk, (limit[b] + kBlockK) / kBlockK);  // limit -1 -> 0 tiles

  auto load_kv = [&](int j, int stage) {
    load_rows<bf16, D>(ks + stage * kBlockK * L::kLd, L::kLd, kg + 1LL * j * kBlockK * kv_row,
                       kv_row, kBlockK);
    load_rows<bf16, D>(vs + stage * kBlockK * L::kLd, L::kLd, vg + 1LL * j * kBlockK * kv_row,
                       kv_row, kBlockK);
    if (masked)
      for (int i = tid; i < kBlockK; i += kThreads)
        pen[stage * kBlockK + i] = mask_penalty(mask, 1LL * b * Tk + j * kBlockK + i);
  };

  load_rows<bf16, D>(qs, L::kLd, q + (1LL * b * S + 1LL * iq * kBlockQ) * q_row + 1LL * h * D,
                     q_row, kBlockQ);
  if (nk > 0) load_kv(0, 0);
  cp_async_commit();

  // this lane's rows of the band: row0 and row0 + 8; its columns 2t, 2t+1 of each 8-tile
  const int t = lane & 3;
  const int row0 = iq * kBlockQ + warp * kBand + (lane >> 2);
  const bf16* q_band = qs + warp * kBand * L::kLd;
  float o[D / 8][4];
  zero(o);
  float m_run[2] = {kMInit, kMInit};
  float l_run[2] = {0.f, 0.f};

  for (int j = 0; j < nk; ++j) {
    const int stage = j % 2;
    if (j + 1 < nk) {
      load_kv(j + 1, (j + 1) % 2);
      cp_async_commit();
      cp_async_wait<1>();  // tile j (and q) have landed for this thread
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // ... and for every thread
    const bf16* kst = ks + stage * kBlockK * L::kLd;
    const bf16* vst = vs + stage * kBlockK * L::kLd;
    const float* pst = pen + stage * kBlockK;

    float s[kNt][4];
    zero(s);
    band_mma_nk<kNt, D>(s, q_band, L::kLd, kst, L::kLd);

    // online softmax over the lane's two rows; a row's four lanes reduce by shuffles
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        s[n][e] = score(s[n][e], scale, causal, row0 + 8 * (e >> 1), j * kBlockK + c, masked,
                        masked ? pst[c] : 0.f);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - mx[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      corr[r] = expf(m_run[r] - mx[r]);
      l_run[r] = l_run[r] * corr[r] + sum[r];
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
    uint32_t p[kNt / 2][4];
    to_a(p, s);  // p rounded to bf16: the A operand of p.V
    reg_mma_kn<D / 8, kNt / 2>(o, p, vst, L::kLd);
    __syncthreads();  // this stage's K/V are free for tile j + 2
  }
  cp_async_wait<0>();

  // a row that saw no valid key: l = 0, so 0 / eps = 0
  const float l_safe[2] = {fmaxf(l_run[0], 1e-30f), fmaxf(l_run[1], 1e-30f)};
  store_rows<D / 8>(out + (1LL * b * S + row0) * q_row + 1LL * h * D, q_row, o, l_safe);
  if (t == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      lse[(1LL * b * NH + h) * S + row0 + 8 * r] = m_run[r] + logf(l_safe[r]);
}

// --------------------------------------------------------------------------------------
// fp32: CUDA cores, band through shared memory
// --------------------------------------------------------------------------------------

template <int D>
struct F32Layout {
  static constexpr int kLdT = padded_f32(D);
  static constexpr int kLdS = padded_f32(kBlockK);
  static constexpr int kLdO = padded_f32(D);
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + align128(4LL * kBlockQ * kLdT);
  static constexpr int kV = kK + align128(4LL * kBlockK * kLdT);
  static constexpr int kPen = kV + align128(4LL * kBlockK * kLdT);
  static constexpr int kS = kPen + align128(4LL * kBlockK);
  static constexpr int kP = kS + align128(4LL * kBlockQ * kLdS);
  static constexpr int kO = kP + align128(4LL * kBlockQ * kLdS);
  static constexpr int kBytes = kO + align128(4LL * kBlockQ * kLdO);
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ mask, const int* __restrict__ limit, float* __restrict__ out,
    float* __restrict__ lse, int S, int Tk, int NH, int KV, float scale, int causal) {
  using L = F32Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::kQ);
  float* ks = reinterpret_cast<float*>(smem + L::kK);
  float* vs = reinterpret_cast<float*>(smem + L::kV);
  float* pen = reinterpret_cast<float*>(smem + L::kPen);
  float* ss = reinterpret_cast<float*>(smem + L::kS);
  float* ps = reinterpret_cast<float*>(smem + L::kP);
  float* os = reinterpret_cast<float*>(smem + L::kO);

  const int iq = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (NH / KV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool masked = mask != nullptr;
  const long long q_row = 1LL * NH * D;
  const long long kv_row = 1LL * KV * D;
  const float* kg = k + 1LL * b * Tk * kv_row + 1LL * g * D;
  const float* vg = v + 1LL * b * Tk * kv_row + 1LL * g * D;

  int nk = Tk / kBlockK;
  if (causal) nk = min(nk, (iq * kBlockQ + kBlockQ + kBlockK - 1) / kBlockK);
  if (masked) nk = min(nk, (limit[b] + kBlockK) / kBlockK);

  auto load_kv = [&](int j) {
    load_rows<float, D>(ks, L::kLdT, kg + 1LL * j * kBlockK * kv_row, kv_row, kBlockK);
    load_rows<float, D>(vs, L::kLdT, vg + 1LL * j * kBlockK * kv_row, kv_row, kBlockK);
    if (masked)
      for (int i = tid; i < kBlockK; i += kThreads)
        pen[i] = mask_penalty(mask, 1LL * b * Tk + j * kBlockK + i);
  };

  load_rows<float, D>(qs, L::kLdT, q + (1LL * b * S + 1LL * iq * kBlockQ) * q_row + 1LL * h * D,
                      q_row, kBlockQ);
  if (nk > 0) load_kv(0);
  cp_async_commit();

  // lanes 2r and 2r+1 own row r of this warp's band: even and odd columns
  const int r = lane >> 1;
  const int half = lane & 1;
  const int q_pos = iq * kBlockQ + warp * kBand + r;
  float* s_band = ss + warp * kBand * L::kLdS;
  float* p_band = ps + warp * kBand * L::kLdS;
  float* o_band = os + warp * kBand * L::kLdO;
  const float* q_band = qs + warp * kBand * L::kLdT;
  float m_run = kMInit;
  float l_run = 0.f;
  for (int c = half; c < D; c += 2) o_band[r * L::kLdO + c] = 0.f;

  for (int j = 0; j < nk; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    {
      WarpAcc<kBlockK> acc;
      acc.zero();
      warp_mma<true, kBlockK, D>(acc, q_band, L::kLdT, ks, L::kLdT);
      acc.store(s_band, L::kLdS);
    }
    __syncwarp();
    float sv[kBlockK / 2];
    float mx = m_run;
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) {
      const int c = 2 * i + half;
      sv[i] = score(s_band[r * L::kLdS + c], scale, causal, q_pos, j * kBlockK + c, masked,
                    masked ? pen[c] : 0.f);
      mx = fmaxf(mx, sv[i]);
    }
    const float m_new = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) {
      const float p = expf(sv[i] - m_new);
      sum += p;
      p_band[r * L::kLdS + 2 * i + half] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float corr = expf(m_run - m_new);
    l_run = l_run * corr + sum;
    m_run = m_new;
    for (int c = half; c < D; c += 2) o_band[r * L::kLdO + c] *= corr;
    __syncwarp();
    {
      WarpAcc<D> acc;
      acc.load(o_band, L::kLdO);
      warp_mma<false, D, kBlockK>(acc, p_band, L::kLdS, vs, L::kLdT);
      acc.store(o_band, L::kLdO);
    }
    __syncthreads();  // K/V, scores and p are free for the next tile
    if (j + 1 < nk) {
      load_kv(j + 1);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  __syncwarp();

  const float l_safe = fmaxf(l_run, 1e-30f);
  float* og = out + (1LL * b * S + q_pos) * q_row + 1LL * h * D;
  for (int c = half; c < D; c += 2) og[c] = o_band[r * L::kLdO + c] / l_safe;
  if (half == 0) lse[(1LL * b * NH + h) * S + q_pos] = m_run + logf(l_safe);
}

template <typename Layout, typename T>
cudaError_t launch(void (*kernel)(const T*, const T*, const T*, const int*, const int*, T*,
                                  float*, int, int, int, int, float, int),
                   const void* q, const void* k, const void* v, const int* mask,
                   const int* limit, void* out, float* lse, int B, int S, int Tk, int NH, int KV,
                   float scale, int causal, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / kBlockQ, NH, B);
  kernel<<<grid, kThreads, Layout::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask, limit,
      static_cast<T*>(out), lse, S, Tk, NH, KV, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, S, NH, D], k / v [B, T, KV, D], out like q: contiguous, dtype 0 = float32,
// 1 = bfloat16. mask int32 [B, T] and limit int32 [B] (last valid key, -1 for none), both
// null without a mask. lse fp32 [B, NH, S]. S and T multiples of 64, D 64 or 128.
// Returns a cudaError_t (0 = launched).
int flash_forward(const void* q, const void* k, const void* v, const void* mask,
                  const void* limit, void* out, void* lse, int B, int S, int Tk, int NH, int KV,
                  int D, float scale, int causal, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || KV <= 0 || NH % KV != 0 || S % kBlockQ || Tk % kBlockK ||
      (mask == nullptr) != (limit == nullptr))
    return cudaErrorInvalidValue;
  const int* m = static_cast<const int*>(mask);
  const int* lim = static_cast<const int*>(limit);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64)
    return launch<Bf16Layout<64>, bf16>(flash_fwd_bf16_kernel<64>, q, k, v, m, lim, out, l, B,
                                        S, Tk, NH, KV, scale, causal, s);
  if (dtype == 1 && D == 128)
    return launch<Bf16Layout<128>, bf16>(flash_fwd_bf16_kernel<128>, q, k, v, m, lim, out, l, B,
                                         S, Tk, NH, KV, scale, causal, s);
  if (dtype == 0 && D == 64)
    return launch<F32Layout<64>, float>(flash_fwd_f32_kernel<64>, q, k, v, m, lim, out, l, B, S,
                                        Tk, NH, KV, scale, causal, s);
  if (dtype == 0 && D == 128)
    return launch<F32Layout<128>, float>(flash_fwd_f32_kernel<128>, q, k, v, m, lim, out, l, B,
                                         S, Tk, NH, KV, scale, causal, s);
  return cudaErrorInvalidValue;
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

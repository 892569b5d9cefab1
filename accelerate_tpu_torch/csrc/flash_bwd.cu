// Flash attention backward for Hopper (sm_90a): dq, and dk with dv, in two kernels.
//
// Replaces the Pallas TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel`
// (accelerate_tpu/ops/flash_attention.py). Both recompute the probabilities from the
// forward's saved row logsumexp, P = exp(s - lse), with the forward's one score recipe
// (scale on the fp32 product, NEG_INF past the causal limit, the mask penalty), and take
// dS = P * (dP - delta) with dP = dO.V^T and delta = rowsum(dO * O) (fp32, computed by the
// wrapper). dS * scale and P are rounded to the operand type before they enter a product.
//  - dq: one block per (q tile, query head, batch row), looping over K/V tiles up to the
//    forward's bound: dq = sum over tiles of dS.K, in fp32 registers.
//  - dk/dv: one block per (k tile, kv head, batch row), looping over the kv head's query
//    heads and, for each, over the q tiles from the causal lower bound (none when the k tile
//    starts past the batch row's last valid key): dv = sum P^T.dO and dk = sum dS^T.Q, in
//    fp32 registers. Each block owns its dk/dv rows, so nothing needs atomics.
// Every tensor is read and written in the model zoo's [B, S, N, D] layout in place.
//
// Bound at llama-125m's shapes (D = 64, causal): operations. dq does 3 products per attended
// (q, k) pair (q.k, dO.v, dS.K: 6 * D flops), dk/dv 4 (q.k, dO.v, P^T.dO, dS^T.Q: 8 * D
// flops); at 989 TFLOP/s in bf16, 0.078 and 0.104 ms at B=32, S=1024, N=12. Design against
// it, bf16: the streamed operand's tiles by cp.async into two shared-memory stages, products
// on the tensor cores by mma.sync m16n8k16 from ldmatrix fragments, scores, P, dS and the
// dq / dk / dv accumulators in registers for the whole loop (P and dS become the next
// product's A operand without leaving them). fp32 takes CUDA-core FMAs, its bands through
// shared memory. Not yet here: wgmma and TMA, one fused pass (dq by atomics).
//
// Launch rules: the kernels run on the caller's stream, allocate nothing and do not
// synchronise. The C entry points return cudaGetLastError() after the launch.

#include "flash_common.cuh"

namespace {

using namespace flash;

// --------------------------------------------------------------------------------------
// bf16: tensor cores, register-resident bands
// --------------------------------------------------------------------------------------

template <int D>
struct DqBf16Layout {
  static constexpr int kLd = padded<bf16>(D);
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + align128(2LL * kBlockQ * kLd);
  static constexpr int kK = kDo + align128(2LL * kBlockQ * kLd);
  static constexpr int kV = kK + align128(2LL * 2 * kBlockK * kLd);
  static constexpr int kPen = kV + align128(2LL * 2 * kBlockK * kLd);
  static constexpr int kBytes = kPen + align128(4LL * 2 * kBlockK);
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ mask, const int* __restrict__ limit,
    const bf16* __restrict__ dout,     // [B, S, NH, D]
    const float* __restrict__ lse,     // [B, NH, S]
    const float* __restrict__ delta,   // [B, NH, S]
    bf16* __restrict__ dq,             // [B, S, NH, D]
    int S, int Tk, int NH, int KV, float scale, int causal) {
  using L = DqBf16Layout<D>;
  constexpr int kNt = kBlockK / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::kQ);
  bf16* dos = reinterpret_cast<bf16*>(smem + L::kDo);
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
  const long long q_off = (1LL * b * S + 1LL * iq * kBlockQ) * q_row + 1LL * h * D;
  const bf16* kg = k + 1LL * b * Tk * kv_row + 1LL * g * D;
  const bf16* vg = v + 1LL * b * Tk * kv_row + 1LL * g * D;

  int nk = Tk / kBlockK;
  if (causal) nk = min(nk, (iq * kBlockQ + kBlockQ + kBlockK - 1) / kBlockK);
  if (masked) nk = min(nk, (limit[b] + kBlockK) / kBlockK);

  auto load_kv = [&](int j, int stage) {
    load_rows<bf16, D>(ks + stage * kBlockK * L::kLd, L::kLd, kg + 1LL * j * kBlockK * kv_row,
                       kv_row, kBlockK);
    load_rows<bf16, D>(vs + stage * kBlockK * L::kLd, L::kLd, vg + 1LL * j * kBlockK * kv_row,
                       kv_row, kBlockK);
    if (masked)
      for (int i = tid; i < kBlockK; i += kThreads)
        pen[stage * kBlockK + i] = mask_penalty(mask, 1LL * b * Tk + j * kBlockK + i);
  };

  load_rows<bf16, D>(qs, L::kLd, q + q_off, q_row, kBlockQ);
  load_rows<bf16, D>(dos, L::kLd, dout + q_off, q_row, kBlockQ);
  if (nk > 0) load_kv(0, 0);
  cp_async_commit();

  const int t = lane & 3;
  const int row0 = iq * kBlockQ + warp * kBand + (lane >> 2);
  const long long rows_off = (1LL * b * NH + h) * S + row0;
  const float lse_r[2] = {lse[rows_off], lse[rows_off + 8]};
  const float delta_r[2] = {delta[rows_off], delta[rows_off + 8]};
  const bf16* q_band = qs + warp * kBand * L::kLd;
  const bf16* do_band = dos + warp * kBand * L::kLd;
  float acc[D / 8][4];
  zero(acc);

  for (int j = 0; j < nk; ++j) {
    const int stage = j % 2;
    if (j + 1 < nk) {
      load_kv(j + 1, (j + 1) % 2);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kst = ks + stage * kBlockK * L::kLd;
    const bf16* vst = vs + stage * kBlockK * L::kLd;
    const float* pst = pen + stage * kBlockK;
    float s[kNt][4], dp[kNt][4];
    zero(s);
    zero(dp);
    band_mma_nk<kNt, D>(s, q_band, L::kLd, kst, L::kLd);
    band_mma_nk<kNt, D>(dp, do_band, L::kLd, vst, L::kLd);
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int c = n * 8 + 2 * t + (e & 1);
        const float p = expf(score(s[n][e], scale, causal, row0 + 8 * r, j * kBlockK + c, masked,
                                   masked ? pst[c] : 0.f) - lse_r[r]);
        s[n][e] = p * (dp[n][e] - delta_r[r]) * scale;  // dS * scale, rounded by to_a
      }
    uint32_t ds[kNt / 2][4];
    to_a(ds, s);
    reg_mma_kn<D / 8, kNt / 2>(acc, ds, kst, L::kLd);  // dq += dS.K
    __syncthreads();
  }
  cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  store_rows<D / 8>(dq + (1LL * b * S + row0) * q_row + 1LL * h * D, q_row, acc, one);
}

template <int D>
struct DkvBf16Layout {
  static constexpr int kLd = padded<bf16>(D);
  static constexpr int kK = 0;
  static constexpr int kV = kK + align128(2LL * kBlockK * kLd);
  static constexpr int kQ = kV + align128(2LL * kBlockK * kLd);
  static constexpr int kDo = kQ + align128(2LL * 2 * kBlockQ * kLd);
  static constexpr int kRows = kDo + align128(2LL * 2 * kBlockQ * kLd);
  static constexpr int kBytes = kRows + align128(4LL * 2 * 2 * kBlockQ);
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ mask, const int* __restrict__ limit,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta,
    bf16* __restrict__ dk,   // [B, T, KV, D]
    bf16* __restrict__ dv,   // [B, T, KV, D]
    int S, int Tk, int NH, int KV, float scale, int causal) {
  using L = DkvBf16Layout<D>;
  constexpr int kNt = kBlockQ / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::kV);
  bf16* qs = reinterpret_cast<bf16*>(smem + L::kQ);
  bf16* dos = reinterpret_cast<bf16*>(smem + L::kDo);
  float* rows = reinterpret_cast<float*>(smem + L::kRows);  // [stage][lse | delta][kBlockQ]

  const int ik = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int group = NH / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool masked = mask != nullptr;
  const long long q_row = 1LL * NH * D;
  const long long kv_row = 1LL * KV * D;
  const long long kv_off = (1LL * b * Tk + 1LL * ik * kBlockK) * kv_row + 1LL * g * D;

  // q-tile bounds: causal, q tiles wholly before this k tile see none of it; mask, a k tile
  // past the last valid key contributes nothing
  const int lower = causal ? (ik * kBlockK) / kBlockQ : 0;
  int upper = S / kBlockQ;
  if (masked && ik * kBlockK > limit[b]) upper = lower;
  const int nq = upper - lower;
  const int n_iter = group * nq;  // (query head of the group, q tile), head outermost

  auto load_q = [&](int it, int stage) {
    const int h = g * group + it / nq;
    const int jq = lower + it % nq;
    const long long off = (1LL * b * S + 1LL * jq * kBlockQ) * q_row + 1LL * h * D;
    load_rows<bf16, D>(qs + stage * kBlockQ * L::kLd, L::kLd, q + off, q_row, kBlockQ);
    load_rows<bf16, D>(dos + stage * kBlockQ * L::kLd, L::kLd, dout + off, q_row, kBlockQ);
    const long long row_off = (1LL * b * NH + h) * S + 1LL * jq * kBlockQ;
    float* dst = rows + stage * 2 * kBlockQ;
    for (int i = tid; i < kBlockQ; i += kThreads) {
      dst[i] = lse[row_off + i];
      dst[kBlockQ + i] = delta[row_off + i];
    }
  };

  load_rows<bf16, D>(ks, L::kLd, k + kv_off, kv_row, kBlockK);
  load_rows<bf16, D>(vs, L::kLd, v + kv_off, kv_row, kBlockK);
  if (n_iter > 0) load_q(0, 0);
  cp_async_commit();

  const int t = lane & 3;
  const int key0 = ik * kBlockK + warp * kBand + (lane >> 2);  // the lane's keys: key0, key0 + 8
  float penalty[2] = {0.f, 0.f};
  if (masked)
    for (int r = 0; r < 2; ++r) penalty[r] = mask_penalty(mask, 1LL * b * Tk + key0 + 8 * r);
  const bf16* k_band = ks + warp * kBand * L::kLd;
  const bf16* v_band = vs + warp * kBand * L::kLd;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int it = 0; it < n_iter; ++it) {
    const int stage = it % 2;
    if (it + 1 < n_iter) {
      load_q(it + 1, (it + 1) % 2);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int jq = lower + it % nq;
    const bf16* qst = qs + stage * kBlockQ * L::kLd;
    const bf16* dost = dos + stage * kBlockQ * L::kLd;
    const float* lse_s = rows + stage * 2 * kBlockQ;
    const float* delta_s = lse_s + kBlockQ;
    float st[kNt][4], dpt[kNt][4];  // S^T = K.Q^T and dP^T = V.dO^T for the band's keys
    zero(st);
    zero(dpt);
    band_mma_nk<kNt, D>(st, k_band, L::kLd, qst, L::kLd);
    band_mma_nk<kNt, D>(dpt, v_band, L::kLd, dost, L::kLd);
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int c = n * 8 + 2 * t + (e & 1);  // query row of the q tile
        const float p = expf(score(st[n][e], scale, causal, jq * kBlockQ + c, key0 + 8 * r,
                                   masked, penalty[r]) - lse_s[c]);
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - delta_s[c]) * scale;  // dS^T * scale
      }
    uint32_t pa[kNt / 2][4], da[kNt / 2][4];
    to_a(pa, st);  // P^T rounded to bf16
    to_a(da, dpt);
    reg_mma_kn<D / 8, kNt / 2>(dv_acc, pa, dost, L::kLd);  // dv += P^T.dO
    reg_mma_kn<D / 8, kNt / 2>(dk_acc, da, qst, L::kLd);   // dk += dS^T.Q
    __syncthreads();
  }
  cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  const long long out_off = (1LL * b * Tk + key0) * kv_row + 1LL * g * D;
  store_rows<D / 8>(dk + out_off, kv_row, dk_acc, one);
  store_rows<D / 8>(dv + out_off, kv_row, dv_acc, one);
}

// --------------------------------------------------------------------------------------
// fp32: CUDA cores, bands through shared memory
// --------------------------------------------------------------------------------------

template <int D>
struct DqF32Layout {
  static constexpr int kLdT = padded_f32(D);
  static constexpr int kLdS = padded_f32(kBlockK);
  static constexpr int kScratch = 2 * kBand * kLdS;  // floats per warp: score and dP bands
  static_assert(kBand * padded_f32(D) <= kScratch, "dq is staged through the scratch");
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + align128(4LL * kBlockQ * kLdT);
  static constexpr int kK = kDo + align128(4LL * kBlockQ * kLdT);
  static constexpr int kV = kK + align128(4LL * kBlockK * kLdT);
  static constexpr int kPen = kV + align128(4LL * kBlockK * kLdT);
  static constexpr int kScr = kPen + align128(4LL * kBlockK);
  static constexpr int kDs = kScr + align128(4LL * kWarps * kScratch);
  static constexpr int kBytes = kDs + align128(4LL * kBlockQ * kLdS);
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ mask, const int* __restrict__ limit, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq,
    int S, int Tk, int NH, int KV, float scale, int causal) {
  using L = DqF32Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::kQ);
  float* dos = reinterpret_cast<float*>(smem + L::kDo);
  float* ks = reinterpret_cast<float*>(smem + L::kK);
  float* vs = reinterpret_cast<float*>(smem + L::kV);
  float* pen = reinterpret_cast<float*>(smem + L::kPen);
  float* scr = reinterpret_cast<float*>(smem + L::kScr);
  float* dss = reinterpret_cast<float*>(smem + L::kDs);

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
  const long long q_off = (1LL * b * S + 1LL * iq * kBlockQ) * q_row + 1LL * h * D;
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

  load_rows<float, D>(qs, L::kLdT, q + q_off, q_row, kBlockQ);
  load_rows<float, D>(dos, L::kLdT, dout + q_off, q_row, kBlockQ);
  if (nk > 0) load_kv(0);
  cp_async_commit();

  const int r = lane >> 1;
  const int half = lane & 1;
  const int q_pos = iq * kBlockQ + warp * kBand + r;
  const float lse_r = lse[(1LL * b * NH + h) * S + q_pos];
  const float delta_r = delta[(1LL * b * NH + h) * S + q_pos];
  float* s_band = scr + warp * L::kScratch;
  float* dp_band = s_band + kBand * L::kLdS;
  float* ds_band = dss + warp * kBand * L::kLdS;
  const float* q_band = qs + warp * kBand * L::kLdT;
  const float* do_band = dos + warp * kBand * L::kLdT;
  WarpAcc<D> dq_acc;
  dq_acc.zero();

  for (int j = 0; j < nk; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    {
      WarpAcc<kBlockK> acc;
      acc.zero();
      warp_mma<true, kBlockK, D>(acc, q_band, L::kLdT, ks, L::kLdT);
      acc.store(s_band, L::kLdS);
      acc.zero();
      warp_mma<true, kBlockK, D>(acc, do_band, L::kLdT, vs, L::kLdT);
      acc.store(dp_band, L::kLdS);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) {
      const int c = 2 * i + half;
      const float s = score(s_band[r * L::kLdS + c], scale, causal, q_pos, j * kBlockK + c,
                            masked, masked ? pen[c] : 0.f);
      const float p = expf(s - lse_r);
      ds_band[r * L::kLdS + c] = p * (dp_band[r * L::kLdS + c] - delta_r) * scale;
    }
    __syncwarp();
    warp_mma<false, D, kBlockK>(dq_acc, ds_band, L::kLdS, ks, L::kLdT);
    __syncthreads();
    if (j + 1 < nk) {
      load_kv(j + 1);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  // stage the band's dq through its scratch, then write its rows
  constexpr int kLdOut = padded_f32(D);
  dq_acc.store(s_band, kLdOut);
  __syncwarp();
  float* dqg = dq + (1LL * b * S + q_pos) * q_row + 1LL * h * D;
  for (int c = half; c < D; c += 2) dqg[c] = s_band[r * kLdOut + c];
}

template <int D>
struct DkvF32Layout {
  static constexpr int kLdT = padded_f32(D);
  static constexpr int kLdS = padded_f32(kBlockQ);
  static constexpr int kScratch = 2 * kBand * kLdS;
  static_assert(kBand * padded_f32(D) <= kScratch, "dk / dv are staged through the scratch");
  static constexpr int kK = 0;
  static constexpr int kV = kK + align128(4LL * kBlockK * kLdT);
  static constexpr int kQ = kV + align128(4LL * kBlockK * kLdT);
  static constexpr int kDo = kQ + align128(4LL * kBlockQ * kLdT);
  static constexpr int kRows = kDo + align128(4LL * kBlockQ * kLdT);
  static constexpr int kScr = kRows + align128(4LL * 2 * kBlockQ);
  static constexpr int kPt = kScr + align128(4LL * kWarps * kScratch);
  static constexpr int kDst = kPt + align128(4LL * kBlockK * kLdS);
  static constexpr int kBytes = kDst + align128(4LL * kBlockK * kLdS);
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ mask, const int* __restrict__ limit, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int S, int Tk, int NH, int KV, float scale, int causal) {
  using L = DkvF32Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem + L::kK);
  float* vs = reinterpret_cast<float*>(smem + L::kV);
  float* qs = reinterpret_cast<float*>(smem + L::kQ);
  float* dos = reinterpret_cast<float*>(smem + L::kDo);
  float* rows = reinterpret_cast<float*>(smem + L::kRows);  // [lse | delta][kBlockQ]
  float* scr = reinterpret_cast<float*>(smem + L::kScr);
  float* pts = reinterpret_cast<float*>(smem + L::kPt);
  float* dsts = reinterpret_cast<float*>(smem + L::kDst);

  const int ik = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int group = NH / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool masked = mask != nullptr;
  const long long q_row = 1LL * NH * D;
  const long long kv_row = 1LL * KV * D;
  const long long kv_off = (1LL * b * Tk + 1LL * ik * kBlockK) * kv_row + 1LL * g * D;

  const int lower = causal ? (ik * kBlockK) / kBlockQ : 0;
  int upper = S / kBlockQ;
  if (masked && ik * kBlockK > limit[b]) upper = lower;
  const int nq = upper - lower;
  const int n_iter = group * nq;

  auto load_q = [&](int it) {
    const int h = g * group + it / nq;
    const int jq = lower + it % nq;
    const long long off = (1LL * b * S + 1LL * jq * kBlockQ) * q_row + 1LL * h * D;
    load_rows<float, D>(qs, L::kLdT, q + off, q_row, kBlockQ);
    load_rows<float, D>(dos, L::kLdT, dout + off, q_row, kBlockQ);
    const long long row_off = (1LL * b * NH + h) * S + 1LL * jq * kBlockQ;
    for (int i = tid; i < kBlockQ; i += kThreads) {
      rows[i] = lse[row_off + i];
      rows[kBlockQ + i] = delta[row_off + i];
    }
  };

  load_rows<float, D>(ks, L::kLdT, k + kv_off, kv_row, kBlockK);
  load_rows<float, D>(vs, L::kLdT, v + kv_off, kv_row, kBlockK);
  if (n_iter > 0) load_q(0);
  cp_async_commit();

  const int r = lane >> 1;
  const int half = lane & 1;
  const int k_pos = ik * kBlockK + warp * kBand + r;
  const float penalty = masked ? mask_penalty(mask, 1LL * b * Tk + k_pos) : 0.f;
  float* s_band = scr + warp * L::kScratch;
  float* dp_band = s_band + kBand * L::kLdS;
  float* pt_band = pts + warp * kBand * L::kLdS;
  float* dst_band = dsts + warp * kBand * L::kLdS;
  const float* k_band = ks + warp * kBand * L::kLdT;
  const float* v_band = vs + warp * kBand * L::kLdT;
  WarpAcc<D> dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();

  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    const int jq = lower + it % nq;
    {
      WarpAcc<kBlockQ> acc;  // S^T = K.Q^T and dP^T = V.dO^T for the band's keys
      acc.zero();
      warp_mma<true, kBlockQ, D>(acc, k_band, L::kLdT, qs, L::kLdT);
      acc.store(s_band, L::kLdS);
      acc.zero();
      warp_mma<true, kBlockQ, D>(acc, v_band, L::kLdT, dos, L::kLdT);
      acc.store(dp_band, L::kLdS);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kBlockQ / 2; ++i) {
      const int c = 2 * i + half;  // query row of the q tile
      const float s = score(s_band[r * L::kLdS + c], scale, causal, jq * kBlockQ + c, k_pos,
                            masked, penalty);
      const float p = expf(s - rows[c]);
      pt_band[r * L::kLdS + c] = p;
      dst_band[r * L::kLdS + c] = p * (dp_band[r * L::kLdS + c] - rows[kBlockQ + c]) * scale;
    }
    __syncwarp();
    warp_mma<false, D, kBlockQ>(dv_acc, pt_band, L::kLdS, dos, L::kLdT);
    warp_mma<false, D, kBlockQ>(dk_acc, dst_band, L::kLdS, qs, L::kLdT);
    __syncthreads();
    if (it + 1 < n_iter) {
      load_q(it + 1);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  constexpr int kLdOut = padded_f32(D);
  const long long out_off = (1LL * b * Tk + k_pos) * kv_row + 1LL * g * D;
  dk_acc.store(s_band, kLdOut);
  __syncwarp();
  for (int c = half; c < D; c += 2) dk[out_off + c] = s_band[r * kLdOut + c];
  __syncwarp();
  dv_acc.store(s_band, kLdOut);
  __syncwarp();
  for (int c = half; c < D; c += 2) dv[out_off + c] = s_band[r * kLdOut + c];
}

// --------------------------------------------------------------------------------------
// launches
// --------------------------------------------------------------------------------------

template <typename T>
using DqKernel = void (*)(const T*, const T*, const T*, const int*, const int*, const T*,
                          const float*, const float*, T*, int, int, int, int, float, int);
template <typename T>
using DkvKernel = void (*)(const T*, const T*, const T*, const int*, const int*, const T*,
                           const float*, const float*, T*, T*, int, int, int, int, float, int);

template <typename T>
cudaError_t launch_dq(DqKernel<T> kernel, int smem, const void* q, const void* k, const void* v,
                      const int* mask, const int* limit, const void* dout, const float* lse,
                      const float* delta, void* dq, int B, int S, int Tk, int NH, int KV,
                      float scale, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / kBlockQ, NH, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask, limit,
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), S, Tk, NH, KV, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(DkvKernel<T> kernel, int smem, const void* q, const void* k,
                       const void* v, const int* mask, const int* limit, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, int B, int S,
                       int Tk, int NH, int KV, float scale, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Tk / kBlockK, KV, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask, limit,
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, Tk,
      NH, KV, scale, causal);
  return cudaGetLastError();
}

bool valid(int B, int S, int Tk, int NH, int KV, const void* mask, const void* limit) {
  return B > 0 && S > 0 && Tk > 0 && KV > 0 && NH % KV == 0 && S % kBlockQ == 0 &&
         Tk % kBlockK == 0 && (mask == nullptr) == (limit == nullptr);
}

}  // namespace

extern "C" {

// Layouts as flash_forward's; dout like q, lse and delta fp32 [B, NH, S], dq like q.
// Returns a cudaError_t (0 = launched).
int flash_backward_dq(const void* q, const void* k, const void* v, const void* mask,
                      const void* limit, const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int S, int Tk, int NH, int KV, int D, float scale,
                      int causal, int dtype, void* stream) {
  if (!valid(B, S, Tk, NH, KV, mask, limit)) return cudaErrorInvalidValue;
  const int* m = static_cast<const int*>(mask);
  const int* lim = static_cast<const int*>(limit);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64)
    return launch_dq<bf16>(flash_dq_bf16_kernel<64>, DqBf16Layout<64>::kBytes, q, k, v, m, lim,
                           dout, l, dl, dq, B, S, Tk, NH, KV, scale, causal, s);
  if (dtype == 1 && D == 128)
    return launch_dq<bf16>(flash_dq_bf16_kernel<128>, DqBf16Layout<128>::kBytes, q, k, v, m, lim,
                           dout, l, dl, dq, B, S, Tk, NH, KV, scale, causal, s);
  if (dtype == 0 && D == 64)
    return launch_dq<float>(flash_dq_f32_kernel<64>, DqF32Layout<64>::kBytes, q, k, v, m, lim,
                            dout, l, dl, dq, B, S, Tk, NH, KV, scale, causal, s);
  if (dtype == 0 && D == 128)
    return launch_dq<float>(flash_dq_f32_kernel<128>, DqF32Layout<128>::kBytes, q, k, v, m, lim,
                            dout, l, dl, dq, B, S, Tk, NH, KV, scale, causal, s);
  return cudaErrorInvalidValue;
}

// dk and dv like k. Returns a cudaError_t (0 = launched).
int flash_backward_dkv(const void* q, const void* k, const void* v, const void* mask,
                       const void* limit, const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int S, int Tk, int NH, int KV, int D,
                       float scale, int causal, int dtype, void* stream) {
  if (!valid(B, S, Tk, NH, KV, mask, limit)) return cudaErrorInvalidValue;
  const int* m = static_cast<const int*>(mask);
  const int* lim = static_cast<const int*>(limit);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64)
    return launch_dkv<bf16>(flash_dkv_bf16_kernel<64>, DkvBf16Layout<64>::kBytes, q, k, v, m,
                            lim, dout, l, dl, dk, dv, B, S, Tk, NH, KV, scale, causal, s);
  if (dtype == 1 && D == 128)
    return launch_dkv<bf16>(flash_dkv_bf16_kernel<128>, DkvBf16Layout<128>::kBytes, q, k, v, m,
                            lim, dout, l, dl, dk, dv, B, S, Tk, NH, KV, scale, causal, s);
  if (dtype == 0 && D == 64)
    return launch_dkv<float>(flash_dkv_f32_kernel<64>, DkvF32Layout<64>::kBytes, q, k, v, m,
                             lim, dout, l, dl, dk, dv, B, S, Tk, NH, KV, scale, causal, s);
  if (dtype == 0 && D == 128)
    return launch_dkv<float>(flash_dkv_f32_kernel<128>, DkvF32Layout<128>::kBytes, q, k, v, m,
                             lim, dout, l, dl, dk, dv, B, S, Tk, NH, KV, scale, causal, s);
  return cudaErrorInvalidValue;
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

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
// Bound at llama-125m's shapes (D = 64, causal): the bytes of q, k, v and out at 3.35 TB/s
// (0.061 ms at B=32, S=1024, N=12), with the operations close behind (4 * D flops per
// attended (q, k) pair at 989 TFLOP/s in bf16, 0.052 ms). Design against it, bf16
// (FlashAttention-3's building blocks, hopper.cuh, shared with flash_bwd.cu):
// - Warp specialisation: a block is one consumer warpgroup (4 warps, 64 query rows) and one
//   producer warp. The producer's elected lane copies Q once and every K/V tile by TMA
//   (3-D tensor maps over [B * S, N, D], read in place, 128-byte swizzle; D = 128 as two
//   64-column boxes) into a ring of 2 stages, each guarded by a "full" mbarrier (TMA bytes
//   and the producer's arrivals: its lanes also stage the tile's mask penalties) and an
//   "empty" one (one arrival per consumer warp once its products have read the stage).
//   At D = 64 an SM holds four blocks (96 registers a thread), at D = 128 two: the other
//   blocks' products run while one block is in its softmax. D = 32 runs the D = 64 block on
//   one-box tiles whose columns 32 .. 63 TMA fills with zeros (hopper.cuh `tile_dim`): Q.K^T
//   takes the first 32 columns, P.V gives zero columns past 32, and only 32 are stored.
// - Both products by wgmma, fp32 accumulators in registers: S = Q.K^T from shared memory
//   (K-major A and B, m64n64k16), then O += P.V with P rounded to bf16 in registers as the A
//   operand and V read from shared memory as an MN-major B operand (m64nDk16). The
//   softmax, causal limit, mask penalty and M_INIT stay in fp32 registers between them;
//   the accumulator layout of S is the register A layout of P (flash_common.cuh `to_a`).
//   The softmax costs one FFMA and one ex2 per score (the scale folded into the exponent,
//   the causal test only on the diagonal tile): it, not the products, is what bounds the
//   kernel at long S.
// - Causal balance and L2: the q tiles of one (head, batch row) are neighbours in the
//   one-dimensional grid, heaviest first, so they share their K/V tiles through L2 while the
//   light tiles of the triangle fill the tail. (All heads' heaviest tiles first balanced the
//   tail too, but read K/V from device memory again for every q tile.)
// An additive fp32 score bias [1|B, NH, S, T] (T5's relative positions) is a compile-time
// variant (kBias): each lane loads its accumulator-layout elements of the tile's bias from
// global memory while the Q.K^T product runs (no shared memory), and adds them after the
// scale, before the causal limit and the mask penalty, as the TPU kernel's `_block_scores`.
// The batch rows of one (head, q tile) are neighbours in the grid of that variant, so a
// broadcast bias (12.6 MB at t5-base's encoder) is read from device memory about once and
// from L2 by the other rows; it holds three blocks an SM at D = 64 for the bias's registers.
// The variant without a bias compiles as before.
// The ring-block variant (kRing; the TPU kernel's `has_offsets`, reached through
// `flash_attention_block`) compares global positions: query row i sits at q_offset + i, key j
// at kv_offset + j, and only their difference (one runtime int) enters the k-tile bound and
// the diagonal test, so one build serves the ring's diagonal, past and future blocks. A block
// wholly in its keys' past (the future blocks) runs no key tile: its producer copies Q only,
// its consumers wait on nothing else and write out = 0 and lse = M_INIT + log(1e-30), which
// the ring's merge weighs at exactly 0. The shift is read only inside `if constexpr (kRing)`
// branches, so the kernels without the variant compile as before (flash_bwd.cu says why).
// fp32 takes CUDA-core FMAs, the band's scores and output through shared memory (the tensor
// cores take fp32 only as TF32). Tried and measured slower on the H100, so not here: two
// 64-row tiles per warpgroup sharing each K/V tile; a persistent grid; issuing the next
// tile's Q.K^T before this tile's softmax (ptxas serialized the wgmmas). Not yet here: two
// consumer warpgroups in ping-pong, 128-key tiles (m64n128 products), a TMA store of the
// output.
//
// Launch rules: the kernels run on the caller's stream, allocate nothing and do not
// synchronise. The C entry point returns cudaGetLastError() after the launch.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

// --------------------------------------------------------------------------------------
// bf16: wgmma fed by TMA, one consumer warpgroup and one producer warp
// --------------------------------------------------------------------------------------

constexpr int kConsumerWarps = 4;  // one warpgroup: 64 query rows, a band of 16 per warp
constexpr int kFwdThreads = (kConsumerWarps + 1) * 32;
static_assert(kBlockQ == kBlockK && kBlockK == kBoxRows && kConsumerWarps * kBand == kBlockQ,
              "64-row tiles, one TMA box of rows each");

template <int D>
struct FwdLayout {
  static constexpr int kStages = 2;
  static constexpr int kTile = kBlockK * D * 2;  // one 64-row tile: D / 64 boxes
  static constexpr int kQ = 0;                   // tiles stay 1024-byte aligned
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kPen = kV + kStages * kTile;
  static constexpr int kBar = kPen + kStages * kBlockK * 4;
  static constexpr int kBytes = kBar + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // the base is rounded up to 1024 bytes
};

// blocks an SM holds: at D = 64 four (96 registers a thread), at D = 128 two; with a bias a
// lane holds its 32 bias values of the tile too: three at D = 64
__host__ __device__ constexpr int fwd_blocks_per_sm(int D, bool bias) {
  return bias && D == 64 ? 3 : (D == 64 ? 4 : 2);
}

template <int D, bool kBias, bool kRing>
__global__ void __launch_bounds__(kFwdThreads, fwd_blocks_per_sm(tile_dim(D), kBias))
flash_fwd_bf16_kernel(
    const __grid_constant__ CUtensorMap q_map,  // q [B * S, NH, D]
    const __grid_constant__ CUtensorMap k_map,  // k [B * T, KV, D]
    const __grid_constant__ CUtensorMap v_map,  // v [B * T, KV, D]
    const int* __restrict__ mask,    // [B, T] or null
    const int* __restrict__ limit,   // [B] last valid key, or null
    const float* __restrict__ bias,  // [1|B, NH, S, T] fp32 (kBias)
    bf16* __restrict__ out,          // [B, S, NH, D]
    float* __restrict__ lse,         // [B, NH, S]
    int B, int S, int Tk, int NH, int KV, int bias_batched, float scale, int causal,
    int shift) {  // kRing: q_offset - kv_offset, the queries' global lead over the keys
  constexpr int kDt = tile_dim(D);  // columns of a shared-memory tile and of the output band
  using L = FwdLayout<kDt>;
  constexpr int kNt = kBlockK / 8;  // 8-column tiles of a score band
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem + L::kQ;
  unsigned char* ks = smem + L::kK;
  unsigned char* vs = smem + L::kV;
  float* pen = reinterpret_cast<float*>(smem + L::kPen);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + L::kStages;
  uint64_t* q_full = empty + L::kStages;

  // the q tiles of one (head, batch row) are neighbours in the grid, heaviest first under a
  // causal mask: they share their K/V tiles through L2, and the light ones fill the tail
  const int nq = S / kBlockQ;
  const int rest = blockIdx.x / nq;
  const int slot = blockIdx.x - rest * nq;
  const int iq = causal ? nq - 1 - slot : slot;
  // with a bias, the batch rows of one (head, q tile) follow each other: they read one bias tile
  const int h = kBias ? rest / B : rest % NH;
  const int b = kBias ? rest % B : rest / NH;
  const int g = h / (NH / KV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool masked = mask != nullptr;

  int nk = Tk / kBlockK;
  if (causal) {
    if constexpr (kRing)  // a block wholly in the keys' past: zero tiles, out 0
      nk = min(nk, causal_tiles(iq * kBlockQ + kBlockQ - 1 + shift, kBlockK));
    else
      nk = min(nk, (iq * kBlockQ + kBlockQ + kBlockK - 1) / kBlockK);
  }
  if (masked) nk = min(nk, (limit[b] + kBlockK) / kBlockK);  // limit -1 -> 0 tiles

  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 32);                // the producer's lanes (one also expects the bytes)
      mbar_init(&empty[s], kConsumerWarps);  // one arrival per consumer warp
    }
    mbar_init(q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer warp
    if (lane == 0) {
      mbar_arrive_expect(q_full, L::kTile);
      for (int c = 0; c < kDt / kBox; ++c)
        tma_load(qs + c * kBoxBytes, &q_map, q_full, c * kBox, h, b * S + iq * kBlockQ);
    }
    for (int j = 0; j < nk; ++j) {
      const int stage = j % L::kStages;
      const int use = j / L::kStages;
      if (use > 0) mbar_wait(&empty[stage], (use - 1) & 1);  // the consumers released it
      if (masked)  // in units of the unscaled product q.k, as the consumers take the scores
        for (int i = lane; i < kBlockK; i += 32)
          pen[stage * kBlockK + i] = mask_penalty(mask, 1LL * b * Tk + j * kBlockK + i) / scale;
      if (lane == 0) {
        mbar_arrive_expect(&full[stage], 2 * L::kTile);
        const int row = b * Tk + j * kBlockK;
        for (int c = 0; c < kDt / kBox; ++c) {
          tma_load(ks + stage * L::kTile + c * kBoxBytes, &k_map, &full[stage], c * kBox, g, row);
          tma_load(vs + stage * L::kTile + c * kBoxBytes, &v_map, &full[stage], c * kBox, g, row);
        }
      } else {
        mbar_arrive(&full[stage]);
      }
    }
    return;
  }

  // ---- consumer warpgroup: this lane's rows of the band are row0 and row0 + 8; its columns
  // 2t, 2t+1 of each 8-column tile.
  // The scores stay unscaled until the exponent: the max of scale * s is scale * (max s),
  // and p = exp(scale * s - m) = 2^(s * scale * log2 e - m * log2 e), one FFMA and one ex2
  // per score. A future key (causal) or a padded one takes NEG_INF / scale or the penalty
  // / scale, so that scale * s is NEG_INF or carries the penalty as the plain version's.
  const float scale_log2 = scale * kLog2e;
  const float neg_raw = kNegInf / scale;
  const float inv_scale = 1.f / scale;  // the bias in units of the unscaled product
  const int t = lane & 3;
  const int row0 = iq * kBlockQ + warp * kBand + (lane >> 2);
  // this lane's bias row row0 of this (batch row, head); row0 + 8 is 8 * Tk further
  const float* bias_row =
      kBias ? bias + (1LL * (bias_batched ? b : 0) * NH + h) * S * Tk + 1LL * row0 * Tk + 2 * t
            : nullptr;
  // wgmma descriptors of the Q tile and of stage 0's K and V tiles; a stage or a k16 step
  // moves the start address (bits 0-13, in 16-byte units), which never carries
  const uint64_t q_desc = sw128_desc(qs, 16, 1024);
  const uint64_t k_desc = sw128_desc(ks, 16, 1024);
  const uint64_t v_desc = sw128_desc(vs, kBoxBytes, 1024);
  float o[kDt / 8][4];
  zero(o);
  float s[kNt][4];
  zero(s);
  float m_run[2] = {kMInit, kMInit};
  float l_run[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  for (int j = 0; j < nk; ++j) {
    const int stage = j % L::kStages;
    mbar_wait(&full[stage], (j / L::kStages) & 1);
    const uint64_t stage_off = (stage * L::kTile) >> 4;
    const float* pst = pen + stage * kBlockK;

    // S = Q.K^T: K-major operands, k16 steps of 32 bytes inside each 64-column box
    pin(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, q_desc + kmajor_step(kk), k_desc + stage_off + kmajor_step(kk), kk > 0);
    wgmma_commit();
    float bv[kBias ? kNt : 1][4];  // the tile's bias at the lane's scores, loaded while Q.K^T runs
    if constexpr (kBias) {
#pragma unroll
      for (int n = 0; n < kNt; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 x = __ldg(reinterpret_cast<const float2*>(
              bias_row + 8LL * r * Tk + j * kBlockK + n * 8));
          bv[n][2 * r] = x.x;
          bv[n][2 * r + 1] = x.y;
        }
    }
    wgmma_wait_all();
    pin(s);

    // online softmax over the lane's two rows; a row's four lanes reduce by shuffles. The
    // score recipe is flash_common.cuh `score`'s (scale, causal limit, mask penalty, a
    // running max from M_INIT), the causal test kept to the diagonal tile
    bool diagonal;
    if constexpr (kRing)
      diagonal = causal && j * kBlockK + kBlockK - 1 > iq * kBlockQ + shift;
    else
      diagonal = causal && j * kBlockK + kBlockK - 1 > iq * kBlockQ;
    float mx[2] = {neg_raw, neg_raw};
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        float v = s[n][e];
        if constexpr (kBias) v = fmaf(bv[n][e], inv_scale, v);
        if constexpr (kRing) {
          if (diagonal && j * kBlockK + c > row0 + 8 * (e >> 1) + shift) v = neg_raw;
        } else {
          if (diagonal && j * kBlockK + c > row0 + 8 * (e >> 1)) v = neg_raw;
        }
        if (masked) v += pst[c];
        s[n][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float m_new[2], m_log2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m_run[r], mx[r] * scale);
      m_log2[r] = m_new[r] * kLog2e;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2_approx(fmaf(s[n][e], scale_log2, -m_log2[e >> 1]));
        sum[e >> 1] += s[n][e];
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      corr[r] = exp2_approx((m_run[r] - m_new[r]) * kLog2e);
      l_run[r] = l_run[r] * corr[r] + sum[r];
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int n = 0; n < kDt / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
    uint32_t p[kNt / 2][4];
    to_a(p, s);  // p rounded to bf16: the register A operand of P.V

    // O += P.V: V is the MN-major B operand; a k16 step is 16 key rows (2048 bytes)
    pin(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kNt / 2; ++kk)
      wgmma_rs<kDt>(o, p[kk], v_desc + stage_off + mnmajor_step(kk));
    wgmma_commit();
    wgmma_wait_all();
    pin(o);
    if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done with the stage
  }

  // a row that saw no valid key: l = 0, so 0 / eps = 0
  const long long q_row = 1LL * NH * D;
  const float l_safe[2] = {fmaxf(l_run[0], 1e-30f), fmaxf(l_run[1], 1e-30f)};
  store_rows<D / 8>(out + (1LL * b * S + row0) * q_row + 1LL * h * D, q_row, o, l_safe);
  if (t == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      lse[(1LL * b * NH + h) * S + row0 + 8 * r] = m_run[r] + logf(l_safe[r]);
}

template <int D, bool kBias, bool kRing = false>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const int* mask,
                        const int* limit, const float* bias, void* out, float* lse, int B, int S,
                        int Tk, int NH, int KV, int bias_batched, float scale, int causal,
                        cudaStream_t stream, int shift = 0) {
  using L = FwdLayout<tile_dim(D)>;
  // a runtime call first: it makes the device's context current on this thread, which the
  // tensor-map encoder (a driver call) needs (hopper.cuh `encode_map`)
  auto kernel = flash_fwd_bf16_kernel<D, kBias, kRing>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return err;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_map(encode, &q_map, q, 1LL * B * S, NH, D) ||
      !encode_map(encode, &k_map, k, 1LL * B * Tk, KV, D) ||
      !encode_map(encode, &v_map, v, 1LL * B * Tk, KV, D))
    return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(S / kBlockQ) * NH * B;
  kernel<<<grid, kFwdThreads, L::kAlloc, stream>>>(q_map, k_map, v_map, mask, limit, bias,
                                                   static_cast<bf16*>(out), lse, B, S, Tk, NH,
                                                   KV, bias_batched, scale, causal, shift);
  return cudaGetLastError();
}

// the bf16 kernel with or without a bias (the ring variant takes none)
template <int D, bool kRing>
cudaError_t launch_bf16_any(const void* q, const void* k, const void* v, const int* mask,
                            const int* limit, const float* bias, void* out, float* lse, int B,
                            int S, int Tk, int NH, int KV, int bias_batched, float scale,
                            int causal, cudaStream_t stream, int shift) {
  return bias != nullptr
             ? launch_bf16<D, true>(q, k, v, mask, limit, bias, out, lse, B, S, Tk, NH, KV,
                                    bias_batched, scale, causal, stream)
             : launch_bf16<D, false, kRing>(q, k, v, mask, limit, bias, out, lse, B, S, Tk, NH,
                                            KV, bias_batched, scale, causal, stream, shift);
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

template <int D, bool kBias, bool kRing>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ mask, const int* __restrict__ limit, const float* __restrict__ bias,
    float* __restrict__ out, float* __restrict__ lse, int S, int Tk, int NH, int KV,
    int bias_batched, float scale, int causal, int shift) {
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
  if (causal) {
    if constexpr (kRing)
      nk = min(nk, causal_tiles(iq * kBlockQ + kBlockQ - 1 + shift, kBlockK));
    else
      nk = min(nk, (iq * kBlockQ + kBlockQ + kBlockK - 1) / kBlockK);
  }
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
  // this row's bias, [1|B, NH, S, T] fp32
  const float* bias_row =
      kBias ? bias + (1LL * (bias_batched ? b : 0) * NH + h) * S * Tk + 1LL * q_pos * Tk : nullptr;

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
      if constexpr (kRing)
        sv[i] = score<kBias>(s_band[r * L::kLdS + c], scale, 0.f, causal, q_pos + shift,
                             j * kBlockK + c, masked, masked ? pen[c] : 0.f);
      else
        sv[i] = score<kBias>(s_band[r * L::kLdS + c], scale,
                             kBias ? bias_row[j * kBlockK + c] : 0.f, causal, q_pos,
                             j * kBlockK + c, masked, masked ? pen[c] : 0.f);
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

template <int D, bool kRing = false>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const int* mask,
                       const int* limit, const float* bias, void* out, float* lse, int B, int S,
                       int Tk, int NH, int KV, int bias_batched, float scale, int causal,
                       cudaStream_t stream, int shift = 0) {
  auto kernel = kRing ? flash_fwd_f32_kernel<D, false, true>
                      : (bias != nullptr ? flash_fwd_f32_kernel<D, true, false>
                                         : flash_fwd_f32_kernel<D, false, false>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         F32Layout<D>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / kBlockQ, NH, B);
  kernel<<<grid, kThreads, F32Layout<D>::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      mask, limit, bias, static_cast<float*>(out), lse, S, Tk, NH, KV, bias_batched, scale,
      causal, shift);
  return cudaGetLastError();
}

// the kernel for a dtype and head dim; kRing: the ring-block variant at shift = q_offset -
// kv_offset, without a bias
template <bool kRing>
cudaError_t launch_forward(const void* q, const void* k, const void* v, const void* mask,
                           const void* limit, const void* bias, void* out, void* lse, int B,
                           int S, int Tk, int NH, int KV, int D, int bias_batched, float scale,
                           int causal, int dtype, void* stream, int sh) {
  if (B <= 0 || S <= 0 || Tk <= 0 || KV <= 0 || NH % KV != 0 || S % kBlockQ || Tk % kBlockK ||
      (mask == nullptr) != (limit == nullptr))
    return cudaErrorInvalidValue;
  const int* m = static_cast<const int*>(mask);
  const int* lim = static_cast<const int*>(limit);
  const float* bs = static_cast<const float*>(bias);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64)
    return launch_bf16_any<64, kRing>(q, k, v, m, lim, bs, out, l, B, S, Tk, NH, KV, bias_batched,
                                      scale, causal, s, sh);
  if (dtype == 1 && D == 128)
    return launch_bf16_any<128, kRing>(q, k, v, m, lim, bs, out, l, B, S, Tk, NH, KV,
                                       bias_batched, scale, causal, s, sh);
  if (dtype == 1 && D == 32)
    return launch_bf16_any<32, kRing>(q, k, v, m, lim, bs, out, l, B, S, Tk, NH, KV, bias_batched,
                                      scale, causal, s, sh);
  if (dtype == 0 && D == 64)
    return launch_f32<64, kRing>(q, k, v, m, lim, bs, out, l, B, S, Tk, NH, KV, bias_batched,
                                 scale, causal, s, sh);
  if (dtype == 0 && D == 128)
    return launch_f32<128, kRing>(q, k, v, m, lim, bs, out, l, B, S, Tk, NH, KV, bias_batched,
                                  scale, causal, s, sh);
  if (dtype == 0 && D == 32)
    return launch_f32<32, kRing>(q, k, v, m, lim, bs, out, l, B, S, Tk, NH, KV, bias_batched,
                                 scale, causal, s, sh);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q [B, S, NH, D], k / v [B, T, KV, D], out like q: contiguous, dtype 0 = float32,
// 1 = bfloat16. mask int32 [B, T] and limit int32 [B] (last valid key, -1 for none), both
// null without a mask. bias fp32 [B, NH, S, T] (bias_batched 1) or [1, NH, S, T] (0), or null.
// lse fp32 [B, NH, S]. S and T multiples of 64, D 32, 64 or 128. Returns a cudaError_t
// (0 = launched).
int flash_forward(const void* q, const void* k, const void* v, const void* mask,
                  const void* limit, const void* bias, void* out, void* lse, int B, int S, int Tk,
                  int NH, int KV, int D, int bias_batched, float scale, int causal, int dtype,
                  void* stream) {
  return launch_forward<false>(q, k, v, mask, limit, bias, out, lse, B, S, Tk, NH, KV, D,
                               bias_batched, scale, causal, dtype, stream, 0);
}

// The ring-block variant (the TPU kernel's `has_offsets`): as flash_forward without a bias,
// causal over global positions, query row i at q_offset + i and key j at kv_offset + j. A
// block wholly in its keys' past (q_offset + S - 1 < kv_offset) runs no key tile and writes
// out = 0 and lse = M_INIT + log(1e-30). One build serves every offset.
int flash_forward_ring(const void* q, const void* k, const void* v, const void* mask,
                       const void* limit, void* out, void* lse, int B, int S, int Tk, int NH,
                       int KV, int D, int q_offset, int kv_offset, float scale, int causal,
                       int dtype, void* stream) {
  return launch_forward<true>(q, k, v, mask, limit, nullptr, out, lse, B, S, Tk, NH, KV, D, 0,
                              scale, causal, dtype, stream, q_offset - kv_offset);
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Flash attention backward for Hopper (sm_90a): dq with the delta rows, and dk with dv, in
// two kernels.
//
// Replaces the Pallas TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel`
// (accelerate_tpu/ops/flash_attention.py). Both recompute the probabilities from the
// forward's saved row logsumexp, P = exp(s - lse), with the forward's one score recipe
// (scale on the fp32 product, NEG_INF past the causal limit, the mask penalty), and take
// dS = P * (dP - delta) with dP = dO.V^T and delta = rowsum(dO * O) in fp32. The dq kernel
// computes delta for its own rows from dO and O before its loop and writes it to the fp32
// [B, NH, S] row buffer that the dk/dv kernel, launched after it, reads (the JAX package
// computes it outside its kernels). dS * scale and P are rounded to the operand type before
// they enter a product.
//  - dq: one block per (query rows, query head, batch row), looping over K/V tiles of 64 or
//    128 keys up to the forward's bound: dq = sum over tiles of dS.K, in fp32 registers.
//  - dk/dv: one block per (64 keys, kv head, batch row), looping over the kv head's query
//    heads and, for each, over the q tiles of 64 or 128 rows from the causal lower bound
//    (none when the keys start past the batch row's last valid key): dv = sum P^T.dO and dk =
//    sum dS^T.Q, in fp32 registers. Each block owns its dk/dv rows: no atomics, and two
//    launches give the same bits.
// Every tensor is read and written in the model zoo's [B, S, N, D] layout in place.
//
// Bound at llama-125m's shapes (D = 64, causal): operations. dq does 3 products per attended
// (q, k) pair (q.k, dO.v, dS.K: 6 * D flops), dk/dv 4 (q.k, dO.v, P^T.dO, dS^T.Q: 8 * D
// flops); at 989 TFLOP/s in bf16, 0.078 and 0.104 ms at B=32, S=1024, N=12. Design against
// it, bf16 (FlashAttention-3's building blocks, hopper.cuh):
// - Warp specialisation: a block is a producer warpgroup and C consumer warpgroups of 64
//   rows each. The producer's first warp copies the block's fixed operand once (dq: Q and
//   dO; dk/dv: K and V) and streams the other by TMA (3-D tensor maps over [B * S, N, D],
//   128-byte swizzle, D = 128 as two 64-column boxes) into a ring of stages, each guarded by
//   a "full" and an "empty" mbarrier (one arrival per consumer warp once its products have
//   read the stage). dq's producer lanes also stage each K tile's mask penalties; dk/dv's
//   producer streams each q tile's lse and delta rows by bulk copy. `setmaxnreg` leaves the
//   producer 24 registers a thread and hands the rest to the consumers.
// - Block shapes, as measured on the H100 (`DqTeam`, `DkvTeam` below): dq at D = 64 is one
//   consumer, with 128-key tiles and two blocks an SM under a causal mask (T a multiple of
//   128), 64-key tiles and three blocks otherwise; at D = 128 three consumers share each K/V
//   tile in one block; dk/dv is one consumer, two blocks an SM, with 128-row q tiles at D = 64
//   (S a multiple of 128). Blocks side by side on an SM hide each other's prologue (the fixed
//   operand's load, delta) and epilogue, which two consumers of one block cannot. Larger
//   tiles halve the waits per product and read shared memory at a lower rate per flop.
// - Every product by wgmma, fp32 accumulators in registers. dq: S = Q.K^T and dP = dO.V^T
//   from shared memory (K-major), then dq += dS.K with dS rounded to bf16 in registers as
//   the A operand and the same K box read as an MN-major B operand. dk/dv: S^T = K.Q^T and
//   dP^T = V.dO^T from shared memory, then dv += P^T.dO and dk += dS^T.Q from registers,
//   the Q and dO boxes read MN-major. A register A operand lives only within one iteration:
//   ptxas 12.9 gave the registers of loop-invariant K/V (or Q/dO) operands, loaded once
//   before the loop, to other values inside it (wrong dk, dv on the H100). The
//   accumulator layout of S is the register A layout of P (flash_common.cuh `to_a`). S and
//   dP are two commit groups: the exponentials run while dP's product does.
// - The probabilities cost one FFMA and one ex2 per score (scale and log2 e folded into the
//   exponent, the scores kept in units of the unscaled product) and the causal test runs on
//   the diagonal tiles only.
// - Causal balance and L2: a head's blocks are neighbours in the one-dimensional grid,
//   heaviest first (dq: the last q rows; dk/dv: the first keys), so they share their
//   streamed tiles through L2 while the light blocks fill the tail.
// D = 32 runs the D = 64 kernels on one-box tiles whose columns 32 .. 63 TMA fills with zeros
// (hopper.cuh `tile_dim`): the score products take the first 32 columns, the accumulators'
// columns past 32 stay zero, and only 32 are stored; delta reads the real rows.
// A consumer whose 64 rows lie past S (dq with three consumers, S an odd number of 64-row
// tiles) leaves at once and the barriers count one warpgroup fewer. fp32 takes CUDA-core
// FMAs, its bands through shared memory (the tensor cores take fp32 only as TF32); its dq
// kernel computes delta the same way. Measured slower on the H100 and left out: two
// consumers per dk/dv block sharing each Q/dO tile, a persistent grid that takes tiles from
// a counter, issuing dv's product before dS^T is computed. Not
// here: one fused pass (dq by atomics, whose order changes from launch to launch).
//
// An additive fp32 score bias [1|B, NH, S, T] (T5's relative positions) has its own
// variants, compiled beside the kernels without one, which stay as they were. Both kernels
// add it where the forward does (after the scale, before the causal limit and the mask
// penalty), each lane loading its accumulator-layout elements from global memory while the
// score products run. The dq kernel with a bias (`flash_dq_bias_bf16_kernel`, one consumer,
// two blocks an SM, 64-key tiles) also writes the bias's gradient dS = P * (dP - delta),
// in fp32 before the scale, as the TPU kernel does:
//  - a [B, ...] bias: a block per batch row, each writing its rows of dbias;
//  - a [1, ...] bias: summed over the batch in a fixed order. The batch is cut into chunks
//    (the wrapper picks them so that the blocks number about four an SM); a block walks the
//    rows of its chunk one after the other, the producer reloading Q and dO for each, and
//    accumulates dS into its own slab of a [chunks, NH, S, T] buffer (each lane reads back
//    only what it wrote: no race, no atomics), then `dbias_sum_kernel` adds the chunks in
//    order. The TPU kernel walks the batch innermost on its sequential grid instead; a
//    [B, NH, S, T] scratch would be 403 MB a layer at t5-base's B = 32.
// Tiles past a row's causal or mask bound hold exact zeros, and two launches give the same
// bits. The dk/dv kernel with a bias runs 64-row q tiles (the 128-row S^T band and its bias
// values do not fit its registers) and walks its batch rows of one kv head side by side, so
// a broadcast bias is read from L2 by all but the first.
//
// The ring-block variants (kRing; the TPU kernels' `has_offsets` and the lse cotangent,
// reached through `flash_attention_block`), without a bias, compare global positions as the
// forward's: the difference q_offset - kv_offset (one runtime int) moves dq's k-tile bound,
// dk/dv's first q tile and both diagonal tests. dq also reads the cotangent of the forward's
// lse and writes delta = rowsum(dO * O) - dlse, so dS = P * (dP - rowsum(dO * O) + dlse) in
// both kernels, as the TPU kernels fold dlse into delta. A block wholly in its keys' past
// (dq) or its queries' future (dk/dv) makes no trip: the producer streams nothing after the
// fixed operand (dk/dv: not even that), no consumer waits on a stage, and dq, dk and dv are
// written as exact zeros. The shift and dlse are read only inside `if constexpr (kRing)`
// branches, each beside the statement the kernels without the variant keep as it was: those
// must compile as before, and reading the unused shift there (even adding a constant 0)
// changed their machine code (the dq kernel grew by a sixth and ran 6-9% slower on the H100).
//
// Launch rules: the kernels run on the caller's stream, allocate nothing and do not
// synchronise. The C entry points return cudaGetLastError() after the launch.

#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

// --------------------------------------------------------------------------------------
// bf16: wgmma fed by TMA, a producer warpgroup and consumer warpgroups
// --------------------------------------------------------------------------------------

// A block: one producer warpgroup and C consumer warpgroups of 64 rows each, `Blocks` blocks
// an SM. ptxas gives each thread the most registers that allows (65536 / (threads * Blocks),
// in units of 8); the producer keeps 24 and hands the rest to the consumers.
template <int C, int Blocks>
struct Team {
  static constexpr int kConsumers = C;
  static constexpr int kBlocks = Blocks;
  static constexpr int kRows = C * kBoxRows;  // q rows (dq) or keys (dk/dv) of a block
  static constexpr int kThreads = (C + 1) * 128;
  static constexpr int kLaunchRegs = 65536 / (kThreads * Blocks) / 8 * 8;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs =
      (kLaunchRegs * kThreads - kProducerRegs * 128) / (C * 128) / 8 * 8;
};
// The fastest shapes measured on the H100 (PERF.md). dq streams K/V tiles of kN keys: at
// D = 64 under a causal mask 128 keys (m64n128 score products, half the per-tile waits) with
// one consumer and two blocks an SM (232 registers hold the 128-column score and dP bands);
// otherwise 64 keys, at D = 64 with one consumer and three blocks an SM (136 registers), at
// D = 128 with three consumers sharing each K/V tile in one block (160 registers hold the
// 64 x 128 accumulator). dk/dv: one consumer and two blocks an SM (232 registers), streaming
// q tiles of kM rows: 128 at D = 64 (S a multiple of 128; the 128-column S^T and dP^T bands
// fit), else 64. Blocks that run side by side on an SM hide each other's prologue and
// epilogue.
template <int D, int kN>
using DqTeamNoBias =
    std::conditional_t<kN == 128, Team<1, 2>, std::conditional_t<D == 64, Team<1, 3>, Team<3, 1>>>;
// With a bias (kBias), dq is one consumer and two blocks an SM with 64-key tiles at every head
// dim: the tile's bias values and the dbias slab's stores take the registers that a third
// block or 128-key tiles had, and one consumer walks its batch rows alone.
template <int D, int kN, bool kBias>
using DqTeam = std::conditional_t<kBias, Team<1, 2>, DqTeamNoBias<D, kN>>;
using DkvTeam = Team<1, 2>;
static_assert(kBlockQ == kBoxRows && kBlockK == kBoxRows && 4 * kBand == kBoxRows,
              "64-row tiles, one TMA box of rows, a warp band of 16");

template <int D, int kN, bool kBias>
struct DqLayout {
  static constexpr int kConsumers = DqTeam<D, kN, kBias>::kConsumers;
  // two blocks of 128-key stages, or of 64-key stages at D = 128, fit an SM
  static constexpr int kStages = kN == 128 || (kBias && D == 128) ? 2 : 3;
  static constexpr int kTile = kBoxRows * D * 2;  // one 64-row tile: D / 64 boxes
  static constexpr int kKvTile = kN * D * 2;      // one K or V tile: [D / 64][kN rows][128 B]
  static constexpr int kQ = 0;                    // a tile per consumer; tiles 1024-byte aligned
  static constexpr int kDo = kQ + kConsumers * kTile;
  static constexpr int kK = kDo + kConsumers * kTile;
  static constexpr int kV = kK + kStages * kKvTile;
  static constexpr int kPen = kV + kStages * kKvTile;
  static constexpr int kBar = kPen + kStages * kN * 4;
  // full and empty per stage, Q/dO full, and with a bias Q/dO empty (the next batch row's)
  static constexpr int kBytes = kBar + (2 * kStages + (kBias ? 2 : 1)) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // the base is rounded up to 1024 bytes
  // a consumer stops up to kConsumers - 1 tiles before the block's causal bound; the
  // producer never waits for those tiles' release
  static_assert(kStages >= kConsumers - 1, "the producer waits only on released stages");
  // kmajor_step walks D in 64-row boxes: a 128-key tile has one box of columns
  static_assert(kN == 64 || D == 64, "128-key tiles at D = 64 only");
};

template <int D, int kM>
struct DkvLayout {
  static constexpr int kConsumers = DkvTeam::kConsumers;
  static constexpr int kStages = 2;
  static constexpr int kTile = kBoxRows * D * 2;
  static constexpr int kQTile = kM * D * 2;  // a streamed Q or dO tile of kM rows
  static constexpr int kK = 0;  // a tile per consumer
  static constexpr int kV = kK + kConsumers * kTile;
  static constexpr int kQ = kV + kConsumers * kTile;
  static constexpr int kDo = kQ + kStages * kQTile;
  static constexpr int kRows = kDo + kStages * kQTile;  // [stage][lse | delta][kM] fp32
  static constexpr int kBar = kRows + kStages * 2 * kM * 4;
  static constexpr int kBytes = kBar + (2 * kStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;
  static_assert(kM == 64 || D == 64, "128-row q tiles at D = 64 only");
};

// delta = rowsum(dO * O) in fp32 for the lane's rows `row` and `row + 8` (at `off`, row
// stride `stride` elements): each of a row's four lanes (t = lane % 4) sums a quarter of the
// columns, 16 bytes a load, then shuffles reduce
template <int D>
__device__ __forceinline__ void row_delta(float (&dl)[2], const bf16* dout, const bf16* out,
                                          long long off, long long stride, int t) {
  constexpr int kVecs = D / 4 / 8;  // 16-byte vectors in a quarter row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const uint4* dp = reinterpret_cast<const uint4*>(dout + off + r * 8 * stride + t * (D / 4));
    const uint4* op = reinterpret_cast<const uint4*>(out + off + r * 8 * stride + t * (D / 4));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const uint4 a = dp[i];
      const uint4 o = op[i];
      const bf16* av = reinterpret_cast<const bf16*>(&a);
      const bf16* ov = reinterpret_cast<const bf16*>(&o);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum = fmaf(__bfloat162float(av[e]), __bfloat162float(ov[e]), sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dl[r] = sum;
  }
}

// The lane's elements of a dbias slab [S, T] at key tile col0: rows row0 and row0 + 8,
// columns 2t, 2t+1 of each 8-column tile. Each lane reads back only what it wrote.
template <int NT>
__device__ __forceinline__ float2* dbias_at(float* slab, long long Tk, int row0, int col0, int t,
                                            int n, int r) {
  return reinterpret_cast<float2*>(slab + (row0 + 8LL * r) * Tk + col0 + n * 8 + 2 * t);
}

// the slab's partial sums of key tile col0, loaded before the tile's products so that their
// latency hides behind them (zeros for the chunk's first batch row, which stores)
template <int NT>
__device__ __forceinline__ void dbias_load(float2 (&acc)[NT][2], const float* slab, long long Tk,
                                           int row0, int col0, int t, bool first) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      acc[n][r] = first ? make_float2(0.f, 0.f)
                        : *dbias_at<NT>(const_cast<float*>(slab), Tk, row0, col0, t, n, r);
}

// dS (before the scale) added to what dbias_load read, and stored
template <int NT>
__device__ __forceinline__ void dbias_store(float* slab, long long Tk, int row0, int col0, int t,
                                            const float (&ds)[NT][4], const float2 (&acc)[NT][2]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *dbias_at<NT>(slab, Tk, row0, col0, t, n, r) =
          make_float2(acc[n][r].x + ds[n][2 * r], acc[n][r].y + ds[n][2 * r + 1]);
}

template <int D, int kN, bool kRing>
__global__ void __launch_bounds__(DqTeam<tile_dim(D), kN, false>::kThreads,
                                  DqTeam<tile_dim(D), kN, false>::kBlocks)
flash_dq_bf16_kernel(
    const __grid_constant__ CUtensorMap q_map,   // q [B * S, NH, D]
    const __grid_constant__ CUtensorMap do_map,  // dO [B * S, NH, D]
    const __grid_constant__ CUtensorMap k_map,   // k [B * T, KV, D]
    const __grid_constant__ CUtensorMap v_map,   // v [B * T, KV, D]
    const bf16* __restrict__ dout,   // [B, S, NH, D]
    const bf16* __restrict__ out,    // [B, S, NH, D], the forward's output
    const int* __restrict__ mask,    // [B, T] or null
    const int* __restrict__ limit,   // [B] last valid key, or null
    const float* __restrict__ lse,   // [B, NH, S]
    float* __restrict__ delta,       // [B, NH, S], written here
    bf16* __restrict__ dq,           // [B, S, NH, D]
    int S, int Tk, int NH, int KV, float scale, int causal,
    const float* __restrict__ dlse,  // kRing: [B, NH, S], the lse cotangent
    int shift) {                     // kRing: q_offset - kv_offset
  constexpr int kDt = tile_dim(D);  // columns of a shared-memory tile and of the dq band
  using L = DqLayout<kDt, kN, false>;
  using W = DqTeam<kDt, kN, false>;
  constexpr int kNt = kN / 8;  // 8-column tiles of a score band
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem + L::kQ;
  unsigned char* dos = smem + L::kDo;
  unsigned char* ks = smem + L::kK;
  unsigned char* vs = smem + L::kV;
  float* pen = reinterpret_cast<float*>(smem + L::kPen);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + L::kStages;
  uint64_t* q_full = empty + L::kStages;

  // a head's blocks are neighbours in the grid, heaviest (last rows) first under a causal mask
  const int nb = (S + W::kRows - 1) / W::kRows;
  const int rest = blockIdx.x / nb;
  const int slot = blockIdx.x - rest * nb;
  const int iq = causal ? nb - 1 - slot : slot;
  const int h = rest % NH;
  const int b = rest / NH;
  const int g = h / (NH / KV);
  const int q0 = iq * W::kRows;
  const int tiles = min(W::kConsumers, (S - q0) / kBlockQ);  // consumers with rows inside S
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool masked = mask != nullptr;

  int nk = Tk / kN;
  if (causal) {
    if constexpr (kRing)  // a block wholly in the keys' past: zero tiles, dq 0
      nk = min(nk, causal_tiles(q0 + W::kRows - 1 + shift, kN));
    else
      nk = min(nk, (q0 + W::kRows + kN - 1) / kN);
  }
  if (masked) nk = min(nk, (limit[b] + kN) / kN);  // limit -1 -> 0 tiles

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 32);         // the producer's lanes (one also expects the bytes)
      mbar_init(&empty[s], 4 * tiles);  // one arrival per consumer warp
    }
    mbar_init(q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: its first warp streams; all four give registers back
    setmaxnreg_dec<W::kProducerRegs>();
    if (warp == 0) {
      if (lane == 0) {
        mbar_arrive_expect(q_full, 2 * tiles * L::kTile);
        for (int w = 0; w < tiles; ++w)
          for (int c = 0; c < kDt / kBox; ++c) {
            const int row = b * S + q0 + w * kBlockQ;
            tma_load(qs + w * L::kTile + c * kBoxBytes, &q_map, q_full, c * kBox, h, row);
            tma_load(dos + w * L::kTile + c * kBoxBytes, &do_map, q_full, c * kBox, h, row);
          }
      }
      for (int j = 0; j < nk; ++j) {
        const int stage = j % L::kStages;
        const int use = j / L::kStages;
        if (use > 0) mbar_wait(&empty[stage], (use - 1) & 1);  // the consumers released it
        if (masked)  // in units of the unscaled product q.k, as the consumers take the scores
          for (int i = lane; i < kN; i += 32)
            pen[stage * kN + i] = mask_penalty(mask, 1LL * b * Tk + j * kN + i) / scale;
        if (lane == 0) {
          mbar_arrive_expect(&full[stage], 2 * L::kKvTile);
          for (int c = 0; c < kDt / kBox; ++c)
            for (int r = 0; r < kN / kBoxRows; ++r) {
              const int off = stage * L::kKvTile + (c * (kN / kBoxRows) + r) * kBoxBytes;
              const int row = b * Tk + j * kN + r * kBoxRows;
              tma_load(ks + off, &k_map, &full[stage], c * kBox, g, row);
              tma_load(vs + off, &v_map, &full[stage], c * kBox, g, row);
            }
        } else {
          mbar_arrive(&full[stage]);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup cw: query rows wq0 .. wq0 + 63; this lane's rows of its warp's
  // band are row0 and row0 + 8, its columns 2t, 2t+1 of each 8-column tile
  setmaxnreg_inc<W::kConsumerRegs>();
  // with one consumer the index is a constant: a computed one ran slower on the H100
  const int cw = W::kConsumers == 1 ? 0 : warp / 4 - 1;
  if (W::kConsumers > 1 && cw >= tiles) return;
  const int wq0 = q0 + cw * kBlockQ;
  const int t = lane & 3;
  const int row0 = wq0 + (warp & 3) * kBand + (lane >> 2);
  const long long q_row = 1LL * NH * D;
  const long long q_off = (1LL * b * S + row0) * q_row + 1LL * h * D;
  const long long rows_off = (1LL * b * NH + h) * S + row0;
  float dl[2];
  row_delta<D>(dl, dout, out, q_off, q_row, t);
  if constexpr (kRing) {  // delta = rowsum(dO * O) - dlse: the lse cotangent rides in delta
    dl[0] -= dlse[rows_off];
    dl[1] -= dlse[rows_off + 8];
  }
  if (t == 0) {
    delta[rows_off] = dl[0];
    delta[rows_off + 8] = dl[1];
  }
  const float lse_log2[2] = {lse[rows_off] * kLog2e, lse[rows_off + 8] * kLog2e};
  // the causal bound of this warpgroup's rows: the block's last tile lies wholly past them
  int nk_own;
  if constexpr (kRing)
    nk_own = causal ? min(nk, causal_tiles(wq0 + kBlockQ - 1 + shift, kN)) : nk;
  else
    nk_own = causal ? min(nk, (wq0 + kBlockQ + kN - 1) / kN) : nk;

  // p = exp(scale * s - lse) = 2^(s * scale * log2 e - lse * log2 e); a future key (causal)
  // or a padded one takes NEG_INF / scale or the penalty / scale, so that scale * s is
  // NEG_INF or carries the penalty as the plain version's
  const float scale_log2 = scale * kLog2e;
  const float neg_raw = kNegInf / scale;
  const uint64_t q_desc = sw128_desc(qs + cw * L::kTile, 16, 1024);
  const uint64_t do_desc = sw128_desc(dos + cw * L::kTile, 16, 1024);
  const uint64_t k_desc = sw128_desc(ks, 16, 1024);          // K-major B of Q.K^T
  const uint64_t v_desc = sw128_desc(vs, 16, 1024);          // K-major B of dO.V^T
  const uint64_t kt_desc = sw128_desc(ks, kBoxBytes, 1024);  // MN-major B of dS.K
  float acc[kDt / 8][4];
  zero(acc);
  float s[kNt][4], dp[kNt][4];
  zero(s);
  zero(dp);
  mbar_wait(q_full, 0);

  for (int j = 0; j < nk_own; ++j) {
    const int stage = j % L::kStages;
    mbar_wait(&full[stage], (j / L::kStages) & 1);
    const uint64_t stage_off = (stage * L::kKvTile) >> 4;
    const float* pst = pen + stage * kN;

    // S = Q.K^T and dP = dO.V^T, two commit groups: P is computed while dP runs
    pin(s);
    pin(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kN>(s, q_desc + kmajor_step(kk), k_desc + stage_off + kmajor_step(kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kN>(dp, do_desc + kmajor_step(kk), v_desc + stage_off + kmajor_step(kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    pin(s);

    // P, the causal test kept to the diagonal tiles
    bool diagonal;
    if constexpr (kRing)
      diagonal = causal && j * kN + kN - 1 > wq0 + shift;
    else
      diagonal = causal && j * kN + kN - 1 > wq0;
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int c = n * 8 + 2 * t + (e & 1);
        float v = s[n][e];
        if constexpr (kRing) {
          if (diagonal && j * kN + c > row0 + 8 * r + shift) v = neg_raw;
        } else {
          if (diagonal && j * kN + c > row0 + 8 * r) v = neg_raw;
        }
        if (masked) v += pst[c];
        s[n][e] = exp2_approx(fmaf(v, scale_log2, -lse_log2[r]));
      }
    wgmma_wait<0>();
    pin(dp);
    // dS * scale = P * (dP - delta) * scale
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = s[n][e] * (dp[n][e] - dl[e >> 1]) * scale;
    uint32_t ds[kNt / 2][4];
    to_a(ds, s);  // dS * scale rounded to bf16: the register A operand of dS.K

    // dq += dS.K: K is the MN-major B operand; a k16 step is 16 key rows
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kNt / 2; ++kk)
      wgmma_rs<kDt>(acc, ds[kk], kt_desc + stage_off + mnmajor_step(kk));
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done with the stage
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D / 8>(dq + q_off, q_row, acc, one);
}

// The dq kernel with a bias: the same pipeline and products as flash_dq_bf16_kernel, 64-key
// tiles, one consumer; each block walks the batch rows of its chunk, the producer reloading Q
// and dO for each once the consumers have released them, and writes dS into its dbias slab.
template <int D>
__global__ void __launch_bounds__(DqTeam<tile_dim(D), 64, true>::kThreads,
                                  DqTeam<tile_dim(D), 64, true>::kBlocks)
flash_dq_bias_bf16_kernel(
    const __grid_constant__ CUtensorMap q_map,   // q [B * S, NH, D]
    const __grid_constant__ CUtensorMap do_map,  // dO [B * S, NH, D]
    const __grid_constant__ CUtensorMap k_map,   // k [B * T, KV, D]
    const __grid_constant__ CUtensorMap v_map,   // v [B * T, KV, D]
    const bf16* __restrict__ dout,   // [B, S, NH, D]
    const bf16* __restrict__ out,    // [B, S, NH, D], the forward's output
    const int* __restrict__ mask,    // [B, T] or null
    const int* __restrict__ limit,   // [B] last valid key, or null
    const float* __restrict__ bias,  // [1|B, NH, S, T] fp32
    const float* __restrict__ lse,   // [B, NH, S]
    float* __restrict__ delta,       // [B, NH, S], written here
    bf16* __restrict__ dq,           // [B, S, NH, D]
    float* dbias,                    // [chunks, NH, S, T] fp32
    int B, int S, int Tk, int NH, int KV, int bias_batched, int chunk, float scale, int causal) {
  constexpr int kDt = tile_dim(D);  // columns of a shared-memory tile and of the dq band
  constexpr int kN = 64;            // keys of a K/V tile
  using L = DqLayout<kDt, kN, true>;
  using W = DqTeam<kDt, kN, true>;
  constexpr int kNt = kN / 8;  // 8-column tiles of a score band
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem + L::kQ;
  unsigned char* dos = smem + L::kDo;
  unsigned char* ks = smem + L::kK;
  unsigned char* vs = smem + L::kV;
  float* pen = reinterpret_cast<float*>(smem + L::kPen);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + L::kStages;
  uint64_t* q_full = empty + L::kStages;
  uint64_t* q_empty = q_full + 1;

  // a block walks the batch rows [b_begin, b_end) of its chunk (one row for a [B, ...] bias);
  // the chunks of one (head, q rows) are neighbours in the grid, heaviest (last rows) first
  // under a causal mask
  const int nb = (S + W::kRows - 1) / W::kRows;
  const int rest = blockIdx.x / nb;
  const int slot = blockIdx.x - rest * nb;
  const int iq = causal ? nb - 1 - slot : slot;
  const int chunks = (B + chunk - 1) / chunk;
  const int part = rest % chunks;
  const int h = rest / chunks;
  const int b_begin = part * chunk;
  const int b_end = min(B, b_begin + chunk);
  const int g = h / (NH / KV);
  const int q0 = iq * W::kRows;
  static_assert(W::kConsumers == 1 && W::kRows == kBlockQ, "one consumer walks the batch rows");
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool masked = mask != nullptr;

  // k tiles of batch row b: up to the causal bound of the block's rows and the last valid key
  auto k_tiles = [&](int b) {
    int nk = Tk / kN;
    if (causal) nk = min(nk, (q0 + W::kRows + kN - 1) / kN);
    if (masked) nk = min(nk, (limit[b] + kN) / kN);  // limit -1 -> 0 tiles
    return nk;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 32);         // the producer's lanes (one also expects the bytes)
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: its first warp streams; all four give registers back
    setmaxnreg_dec<W::kProducerRegs>();
    if (warp == 0) {
      int it = 0;  // the ring's tile count over the block's batch rows
      for (int b = b_begin; b < b_end; ++b) {
        const int bi = b - b_begin;
        const int nk = k_tiles(b);
        if (lane == 0) {
          if (bi > 0) mbar_wait(q_empty, (bi - 1) & 1);  // the last row's Q, dO are read
          mbar_arrive_expect(q_full, 2 * L::kTile);
          for (int c = 0; c < kDt / kBox; ++c) {
            tma_load(qs + c * kBoxBytes, &q_map, q_full, c * kBox, h, b * S + q0);
            tma_load(dos + c * kBoxBytes, &do_map, q_full, c * kBox, h, b * S + q0);
          }
        }
        for (int j = 0; j < nk; ++j, ++it) {
          const int stage = it % L::kStages;
          const int use = it / L::kStages;
          if (use > 0) mbar_wait(&empty[stage], (use - 1) & 1);  // the consumers released it
          if (masked)  // in units of the unscaled product q.k, as the consumers take the scores
            for (int i = lane; i < kN; i += 32)
              pen[stage * kN + i] = mask_penalty(mask, 1LL * b * Tk + j * kN + i) / scale;
          if (lane == 0) {
            mbar_arrive_expect(&full[stage], 2 * L::kKvTile);
            for (int c = 0; c < kDt / kBox; ++c)
              for (int r = 0; r < kN / kBoxRows; ++r) {
                const int off = stage * L::kKvTile + (c * (kN / kBoxRows) + r) * kBoxBytes;
                const int row = b * Tk + j * kN + r * kBoxRows;
                tma_load(ks + off, &k_map, &full[stage], c * kBox, g, row);
                tma_load(vs + off, &v_map, &full[stage], c * kBox, g, row);
              }
          } else {
            mbar_arrive(&full[stage]);
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup: query rows q0 .. q0 + 63; this lane's rows of its warp's
  // band are row0 and row0 + 8, its columns 2t, 2t+1 of each 8-column tile
  setmaxnreg_inc<W::kConsumerRegs>();
  const int t = lane & 3;
  const int row0 = q0 + (warp & 3) * kBand + (lane >> 2);
  const long long q_row = 1LL * NH * D;
  // p = exp(scale * s - lse) = 2^(s * scale * log2 e - lse * log2 e); a future key (causal)
  // or a padded one takes NEG_INF / scale or the penalty / scale, so that scale * s is
  // NEG_INF or carries the penalty as the plain version's; a bias enters as bias / scale
  const float scale_log2 = scale * kLog2e;
  const float neg_raw = kNegInf / scale;
  const float inv_scale = 1.f / scale;
  const uint64_t q_desc = sw128_desc(qs, 16, 1024);
  const uint64_t do_desc = sw128_desc(dos, 16, 1024);
  const uint64_t k_desc = sw128_desc(ks, 16, 1024);          // K-major B of Q.K^T
  const uint64_t v_desc = sw128_desc(vs, 16, 1024);          // K-major B of dO.V^T
  const uint64_t kt_desc = sw128_desc(ks, kBoxBytes, 1024);  // MN-major B of dS.K
  // this block's dbias slab [S, T]: its chunk's partial sum (a [B, ...] bias: its batch row's)
  float* slab = dbias + (1LL * part * NH + h) * S * Tk;
  float acc[kDt / 8][4];
  float s[kNt][4], dp[kNt][4];
  zero(s);
  zero(dp);

  int it = 0;  // the ring's tile count over the block's batch rows, as the producer's
  for (int b = b_begin; b < b_end; ++b) {
    const int bi = b - b_begin;
    const long long q_off = (1LL * b * S + row0) * q_row + 1LL * h * D;
    const long long rows_off = (1LL * b * NH + h) * S + row0;
    float dl[2];
    row_delta<D>(dl, dout, out, q_off, q_row, t);
    if (t == 0) {
      delta[rows_off] = dl[0];
      delta[rows_off + 8] = dl[1];
    }
    const float lse_log2[2] = {lse[rows_off] * kLog2e, lse[rows_off + 8] * kLog2e};
    const int nk = k_tiles(b);
    // this lane's bias row row0 of (batch row, head); row0 + 8 is 8 * Tk further
    const float* bias_row =
        bias + (1LL * (bias_batched ? b : 0) * NH + h) * S * Tk + 1LL * row0 * Tk + 2 * t;
    zero(acc);
    mbar_wait(q_full, bi & 1);

    for (int j = 0; j < nk; ++j, ++it) {
      const int stage = it % L::kStages;
      mbar_wait(&full[stage], (it / L::kStages) & 1);
      const uint64_t stage_off = (stage * L::kKvTile) >> 4;
      const float* pst = pen + stage * kN;
      float2 part[kNt][2];  // the slab's sums so far at this tile, read while the products run
      dbias_load(part, slab, Tk, row0, j * kN, t, bi == 0);

      // S = Q.K^T and dP = dO.V^T, two commit groups: P is computed while dP runs
      pin(s);
      pin(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kN>(s, q_desc + kmajor_step(kk), k_desc + stage_off + kmajor_step(kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kN>(dp, do_desc + kmajor_step(kk), v_desc + stage_off + kmajor_step(kk), kk > 0);
      wgmma_commit();
      float bv[kNt][4];  // the tile's bias at the lane's scores, loaded meanwhile
#pragma unroll
      for (int n = 0; n < kNt; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 x =
              __ldg(reinterpret_cast<const float2*>(bias_row + 8LL * r * Tk + j * kN + n * 8));
          bv[n][2 * r] = x.x;
          bv[n][2 * r + 1] = x.y;
        }
      wgmma_wait<1>();
      pin(s);

      // P, the causal test kept to the diagonal tiles
      const bool diagonal = causal && j * kN + kN - 1 > q0;
#pragma unroll
      for (int n = 0; n < kNt; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int c = n * 8 + 2 * t + (e & 1);
          float v = fmaf(bv[n][e], inv_scale, s[n][e]);
          if (diagonal && j * kN + c > row0 + 8 * r) v = neg_raw;
          if (masked) v += pst[c];
          s[n][e] = exp2_approx(fmaf(v, scale_log2, -lse_log2[r]));
        }
      wgmma_wait<0>();
      pin(dp);
      // dS = P * (dP - delta), the bias's gradient, then dS * scale
#pragma unroll
      for (int n = 0; n < kNt; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = s[n][e] * (dp[n][e] - dl[e >> 1]);
      dbias_store(slab, Tk, row0, j * kN, t, s, part);
#pragma unroll
      for (int n = 0; n < kNt; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale;
      uint32_t ds[kNt / 2][4];
      to_a(ds, s);  // dS * scale rounded to bf16: the register A operand of dS.K

      // dq += dS.K: K is the MN-major B operand; a k16 step is 16 key rows
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kNt / 2; ++kk)
        wgmma_rs<kDt>(acc, ds[kk], kt_desc + stage_off + mnmajor_step(kk));
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
      if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done with the stage
    }
    const float one[2] = {1.f, 1.f};
    store_rows<D / 8>(dq + q_off, q_row, acc, one);
    if (lane == 0) mbar_arrive(q_empty);  // this warp is done with the row's Q and dO
    if (bi == 0) {
      // the first row's tiles past its bound hold exact zeros; later rows add to them
      float zeros[kNt][4];
      float2 none[kNt][2];
      zero(zeros);
      dbias_load(none, slab, Tk, row0, 0, t, true);
      for (int j = nk; j < Tk / kN; ++j) dbias_store(slab, Tk, row0, j * kN, t, zeros, none);
    }
  }
}

template <int D, int kM, bool kBias, bool kRing>
__global__ void __launch_bounds__(DkvTeam::kThreads, DkvTeam::kBlocks) flash_dkv_bf16_kernel(
    const __grid_constant__ CUtensorMap q_map,   // q [B * S, NH, D]
    const __grid_constant__ CUtensorMap do_map,  // dO [B * S, NH, D]
    const __grid_constant__ CUtensorMap k_map,   // k [B * T, KV, D]
    const __grid_constant__ CUtensorMap v_map,   // v [B * T, KV, D]
    const int* __restrict__ mask, const int* __restrict__ limit,
    const float* __restrict__ bias,   // [1|B, NH, S, T] fp32 (kBias)
    const float* __restrict__ lse,    // [B, NH, S]
    const float* __restrict__ delta,  // [B, NH, S]
    bf16* __restrict__ dk,            // [B, T, KV, D]
    bf16* __restrict__ dv,            // [B, T, KV, D]
    int B, int S, int Tk, int NH, int KV, int bias_batched, float scale, int causal,
    int shift) {  // kRing: q_offset - kv_offset
  constexpr int kDt = tile_dim(D);  // columns of a shared-memory tile and of the dk, dv bands
  using L = DkvLayout<kDt, kM>;
  using W = DkvTeam;
  constexpr int kNt = kM / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ks = smem + L::kK;
  unsigned char* vs = smem + L::kV;
  unsigned char* qs = smem + L::kQ;
  unsigned char* dos = smem + L::kDo;
  float* rows = reinterpret_cast<float*>(smem + L::kRows);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + L::kStages;
  uint64_t* kv_full = empty + L::kStages;

  // a kv head's blocks are neighbours in the grid, heaviest (first keys) first under a
  // causal mask; with a bias, its batch rows follow each other too (they read one bias slab)
  const int nb = (Tk + W::kRows - 1) / W::kRows;
  const int rest = blockIdx.x / nb;
  const int ik = blockIdx.x - rest * nb;
  const int g = kBias ? rest / B : rest % KV;
  const int b = kBias ? rest % B : rest / KV;
  const int group = NH / KV;
  const int k0 = ik * W::kRows;
  const int tiles = min(W::kConsumers, (Tk - k0) / kBlockK);  // consumers with keys inside T
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool masked = mask != nullptr;

  // q-tile bounds: causal, q tiles wholly before the block's first key see none of it (in a
  // ring block, every q tile may: a block wholly in the queries' future makes no trip); mask,
  // a block past the last valid key contributes nothing (its rows get exact zeros)
  int lower;
  if constexpr (kRing)
    lower = causal ? max(k0 - shift, 0) / kM : 0;
  else
    lower = causal ? k0 / kM : 0;
  int upper = S / kM;
  if (masked && k0 > limit[b]) upper = lower;
  const int nq = max(upper - lower, 0);
  const int n_iter = group * nq;  // (query head of the group, q tile), head outermost

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);           // the producer's elected lane, with the bytes
      mbar_init(&empty[s], 4 * tiles);  // one arrival per consumer warp
    }
    mbar_init(kv_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: one lane streams; all four warps give registers back
    setmaxnreg_dec<W::kProducerRegs>();
    if (warp == 0 && lane == 0 && n_iter > 0) {
      mbar_arrive_expect(kv_full, 2 * tiles * L::kTile);
      for (int w = 0; w < tiles; ++w)
        for (int c = 0; c < kDt / kBox; ++c) {
          const int row = b * Tk + k0 + w * kBlockK;
          tma_load(ks + w * L::kTile + c * kBoxBytes, &k_map, kv_full, c * kBox, g, row);
          tma_load(vs + w * L::kTile + c * kBoxBytes, &v_map, kv_full, c * kBox, g, row);
        }
      for (int it = 0; it < n_iter; ++it) {
        const int stage = it % L::kStages;
        const int use = it / L::kStages;
        if (use > 0) mbar_wait(&empty[stage], (use - 1) & 1);
        const int h = g * group + it / nq;
        const int jq = lower + it % nq;
        mbar_arrive_expect(&full[stage], 2 * L::kQTile + 2 * kM * 4);
        for (int c = 0; c < kDt / kBox; ++c)
          for (int r = 0; r < kM / kBoxRows; ++r) {
            const int off = stage * L::kQTile + (c * (kM / kBoxRows) + r) * kBoxBytes;
            const int row = b * S + jq * kM + r * kBoxRows;
            tma_load(qs + off, &q_map, &full[stage], c * kBox, h, row);
            tma_load(dos + off, &do_map, &full[stage], c * kBox, h, row);
          }
        const long long row_off = (1LL * b * NH + h) * S + 1LL * jq * kM;
        float* dst = rows + stage * 2 * kM;
        bulk_load(dst, lse + row_off, kM * 4, &full[stage]);
        bulk_load(dst + kM, delta + row_off, kM * 4, &full[stage]);
      }
    }
    return;
  }

  // ---- consumer warpgroup cw: keys wk0 .. wk0 + 63; this lane's keys are key0 and key0 + 8,
  // its query columns 2t, 2t+1 of each 8-column tile
  setmaxnreg_inc<W::kConsumerRegs>();
  const int cw = warp / 4 - 1;  // computed even with one consumer: a constant ran slower
  if (cw >= tiles) return;
  const int wk0 = k0 + cw * kBlockK;
  const int t = lane & 3;
  const int key0 = wk0 + (warp & 3) * kBand + (lane >> 2);
  const float scale_log2 = scale * kLog2e;
  const float neg_raw = kNegInf / scale;
  const float inv_scale = 1.f / scale;  // the bias in units of the unscaled product
  float pen_raw[2] = {0.f, 0.f};  // in units of the unscaled product
  if (masked)
    for (int r = 0; r < 2; ++r)
      pen_raw[r] = mask_penalty(mask, 1LL * b * Tk + key0 + 8 * r) / scale;
  const uint64_t k_desc = sw128_desc(ks + cw * L::kTile, 16, 1024);  // K-major A of K.Q^T
  const uint64_t v_desc = sw128_desc(vs + cw * L::kTile, 16, 1024);  // K-major A of V.dO^T
  const uint64_t q_desc = sw128_desc(qs, 16, 1024);                  // K-major B of K.Q^T
  const uint64_t do_desc = sw128_desc(dos, 16, 1024);                // K-major B of V.dO^T
  const uint64_t qt_desc = sw128_desc(qs, kBoxBytes, 1024);          // MN-major B of dS^T.Q
  const uint64_t dot_desc = sw128_desc(dos, kBoxBytes, 1024);        // MN-major B of P^T.dO
  float dk_acc[kDt / 8][4], dv_acc[kDt / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  float st[kNt][4], dpt[kNt][4];  // S^T and dP^T for the band's keys
  zero(st);
  zero(dpt);
  if (n_iter > 0) mbar_wait(kv_full, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int stage = it % L::kStages;
    mbar_wait(&full[stage], (it / L::kStages) & 1);
    const int jq = lower + it % nq;
    const uint64_t stage_off = (stage * L::kQTile) >> 4;
    const float* lse_s = rows + stage * 2 * kM;
    // the bias of query head h at this q tile's rows and the lane's keys key0, key0 + 8
    const float* bias_tile =
        kBias ? bias + (1LL * (bias_batched ? b : 0) * NH + g * group + it / nq) * S * Tk +
                    1LL * jq * kM * Tk + key0
              : nullptr;
    const float* delta_s = lse_s + kM;

    // S^T = K.Q^T and dP^T = V.dO^T, two commit groups: P^T is computed while dP^T runs
    pin(st);
    pin(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kM>(st, k_desc + kmajor_step(kk), q_desc + stage_off + kmajor_step(kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kM>(dpt, v_desc + kmajor_step(kk), do_desc + stage_off + kmajor_step(kk), kk > 0);
    wgmma_commit();
    float bv[kBias ? kNt : 1][4];  // the bias at the lane's S^T entries, loaded meanwhile
    if constexpr (kBias) {
#pragma unroll
      for (int n = 0; n < kNt; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          bv[n][e] = __ldg(bias_tile + 1LL * (n * 8 + 2 * t + (e & 1)) * Tk + 8 * (e >> 1));
    }
    wgmma_wait<1>();  // S^T is in; dP^T may still run
    pin(st);

    // P^T; the causal test on the tiles where some key follows some query
    bool diagonal;
    if constexpr (kRing)
      diagonal = causal && wk0 + kBlockK - 1 > jq * kM + shift;
    else
      diagonal = causal && wk0 + kBlockK - 1 > jq * kM;
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int c = n * 8 + 2 * t + (e & 1);  // query row of the q tile
        float v = st[n][e];
        if constexpr (kBias) v = fmaf(bv[n][e], inv_scale, v);
        if constexpr (kRing) {
          if (diagonal && key0 + 8 * r > jq * kM + c + shift) v = neg_raw;
        } else {
          if (diagonal && key0 + 8 * r > jq * kM + c) v = neg_raw;
        }
        v += pen_raw[r];
        st[n][e] = exp2_approx(fmaf(v, scale_log2, -((e & 1) ? l2.y : l2.x) * kLog2e));
      }
    }
    uint32_t pa[kNt / 2][4], da[kNt / 2][4];
    to_a(pa, st);  // P^T rounded to bf16

    wgmma_wait<0>();
    pin(dpt);

    // dS^T * scale = P^T * (dP^T - delta) * scale
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      const float2 d2 = *reinterpret_cast<const float2*>(delta_s + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[n][e] = st[n][e] * (dpt[n][e] - ((e & 1) ? d2.y : d2.x)) * scale;
    }
    to_a(da, dpt);  // dS^T * scale rounded to bf16

    // dv += P^T.dO and dk += dS^T.Q: dO and Q are MN-major B operands
    pin(dk_acc);
    pin(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kNt / 2; ++kk)
      wgmma_rs<kDt>(dv_acc, pa[kk], dot_desc + stage_off + mnmajor_step(kk));
#pragma unroll
    for (int kk = 0; kk < kNt / 2; ++kk)
      wgmma_rs<kDt>(dk_acc, da[kk], qt_desc + stage_off + mnmajor_step(kk));
    wgmma_commit();
    wgmma_wait<0>();
    pin(dv_acc);
    pin(dk_acc);
    if (lane == 0) mbar_arrive(&empty[stage]);
  }
  const float one[2] = {1.f, 1.f};
  const long long kv_row = 1LL * KV * D;
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

template <int D, bool kRing>
__global__ void __launch_bounds__(kThreads) flash_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ mask, const int* __restrict__ limit, const float* __restrict__ dout,
    const float* __restrict__ out, const float* __restrict__ lse, float* __restrict__ delta,
    float* __restrict__ dq, int S, int Tk, int NH, int KV, float scale, int causal,
    const float* __restrict__ dlse, int shift) {  // kRing: the lse cotangent, q_off - kv_off
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

  load_rows<float, D>(qs, L::kLdT, q + q_off, q_row, kBlockQ);
  load_rows<float, D>(dos, L::kLdT, dout + q_off, q_row, kBlockQ);
  if (nk > 0) load_kv(0);
  cp_async_commit();

  const int r = lane >> 1;
  const int half = lane & 1;
  const int q_pos = iq * kBlockQ + warp * kBand + r;
  const float lse_r = lse[(1LL * b * NH + h) * S + q_pos];
  // delta = rowsum(dO * O) for the warp's 16 rows, each summed by the whole warp over
  // columns lane, lane + 32, ... (coalesced); lanes 2r and 2r+1 keep row r's
  float delta_r = 0.f;
  {
    const long long band = (1LL * b * S + 1LL * iq * kBlockQ + warp * kBand) * q_row + 1LL * h * D;
    for (int i = 0; i < kBand; ++i) {
      float part = 0.f;
#pragma unroll
      for (int c = lane; c < D; c += 32)
        part = fmaf(dout[band + i * q_row + c], out[band + i * q_row + c], part);
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) part += __shfl_xor_sync(0xffffffffu, part, m);
      part = __shfl_sync(0xffffffffu, part, 0);  // one order for every lane
      if (i == r) delta_r = part;
    }
    if constexpr (kRing) delta_r -= dlse[(1LL * b * NH + h) * S + q_pos];
    if (half == 0) delta[(1LL * b * NH + h) * S + q_pos] = delta_r;
  }
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
      float s;
      if constexpr (kRing)
        s = score<false>(s_band[r * L::kLdS + c], scale, 0.f, causal, q_pos + shift,
                         j * kBlockK + c, masked, masked ? pen[c] : 0.f);
      else
        s = score<false>(s_band[r * L::kLdS + c], scale, 0.f, causal, q_pos, j * kBlockK + c,
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

// flash_dq_f32_kernel with a bias: each block walks the batch rows of its chunk (grid z) and
// writes dS into its dbias slab, as the bf16 kernel
template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_bias_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ mask, const int* __restrict__ limit, const float* __restrict__ bias,
    const float* __restrict__ dout, const float* __restrict__ out, const float* __restrict__ lse,
    float* __restrict__ delta, float* __restrict__ dq, float* dbias, int B, int S, int Tk,
    int NH, int KV, int bias_batched, int chunk, float scale, int causal) {
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
  const int b_begin = blockIdx.z * chunk;
  const int b_end = min(B, b_begin + chunk);
  const int g = h / (NH / KV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool masked = mask != nullptr;
  const long long q_row = 1LL * NH * D;
  const long long kv_row = 1LL * KV * D;
  const int r = lane >> 1;
  const int half = lane & 1;
  const int q_pos = iq * kBlockQ + warp * kBand + r;
  float* s_band = scr + warp * L::kScratch;
  float* dp_band = s_band + kBand * L::kLdS;
  float* ds_band = dss + warp * kBand * L::kLdS;
  const float* q_band = qs + warp * kBand * L::kLdT;
  const float* do_band = dos + warp * kBand * L::kLdT;
  // this row of the block's dbias slab [S, T]: its chunk's partial sum (or its batch row's)
  float* slab_row = dbias + (1LL * blockIdx.z * NH + h) * S * Tk + 1LL * q_pos * Tk;

  for (int b = b_begin; b < b_end; ++b) {
    const bool first = b == b_begin;
    const long long q_off = (1LL * b * S + 1LL * iq * kBlockQ) * q_row + 1LL * h * D;
    const float* kg = k + 1LL * b * Tk * kv_row + 1LL * g * D;
    const float* vg = v + 1LL * b * Tk * kv_row + 1LL * g * D;
    const float* bias_row =
        bias + (1LL * (bias_batched ? b : 0) * NH + h) * S * Tk + 1LL * q_pos * Tk;

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

    __syncthreads();  // the last batch row's tiles are read
    load_rows<float, D>(qs, L::kLdT, q + q_off, q_row, kBlockQ);
    load_rows<float, D>(dos, L::kLdT, dout + q_off, q_row, kBlockQ);
    if (nk > 0) load_kv(0);
    cp_async_commit();

    const float lse_r = lse[(1LL * b * NH + h) * S + q_pos];
    // delta = rowsum(dO * O) for the warp's 16 rows, each summed by the whole warp over
    // columns lane, lane + 32, ... (coalesced); lanes 2r and 2r+1 keep row r's
    float delta_r = 0.f;
    {
      const long long band =
          (1LL * b * S + 1LL * iq * kBlockQ + warp * kBand) * q_row + 1LL * h * D;
      for (int i = 0; i < kBand; ++i) {
        float part = 0.f;
#pragma unroll
        for (int c = lane; c < D; c += 32)
          part = fmaf(dout[band + i * q_row + c], out[band + i * q_row + c], part);
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) part += __shfl_xor_sync(0xffffffffu, part, m);
        part = __shfl_sync(0xffffffffu, part, 0);  // one order for every lane
        if (i == r) delta_r = part;
      }
      if (half == 0) delta[(1LL * b * NH + h) * S + q_pos] = delta_r;
    }
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
        const float s = score<true>(s_band[r * L::kLdS + c], scale, bias_row[j * kBlockK + c],
                                    causal, q_pos, j * kBlockK + c, masked,
                                    masked ? pen[c] : 0.f);
        const float p = expf(s - lse_r);
        const float dsb = p * (dp_band[r * L::kLdS + c] - delta_r);  // the bias's gradient
        float* d = slab_row + j * kBlockK + c;
        *d = first ? dsb : *d + dsb;
        ds_band[r * L::kLdS + c] = dsb * scale;
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
    __syncwarp();
    if (first)  // tiles past the first row's bound: exact zeros
      for (int c = nk * kBlockK + half; c < Tk; c += 2) slab_row[c] = 0.f;
  }
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

template <int D, bool kBias, bool kRing>
__global__ void __launch_bounds__(kThreads) flash_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ mask, const int* __restrict__ limit, const float* __restrict__ bias,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int S,
    int Tk, int NH, int KV, int bias_batched, float scale, int causal, int shift) {
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

  int lower;
  if constexpr (kRing)
    lower = causal ? max(ik * kBlockK - shift, 0) / kBlockQ : 0;
  else
    lower = causal ? (ik * kBlockK) / kBlockQ : 0;
  int upper = S / kBlockQ;
  if (masked && ik * kBlockK > limit[b]) upper = lower;
  const int nq = kRing ? max(upper - lower, 0) : upper - lower;
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
    // the bias of query head h at this q tile's rows and the row's key
    const float* bias_col =
        kBias ? bias + (1LL * (bias_batched ? b : 0) * NH + g * group + it / nq) * S * Tk +
                    1LL * jq * kBlockQ * Tk + k_pos
              : nullptr;
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
      float s;
      if constexpr (kRing)
        s = score<false>(s_band[r * L::kLdS + c], scale, 0.f, causal, jq * kBlockQ + c + shift,
                         k_pos, masked, penalty);
      else
        s = score<kBias>(s_band[r * L::kLdS + c], scale, kBias ? bias_col[1LL * c * Tk] : 0.f,
                         causal, jq * kBlockQ + c, k_pos, masked, penalty);
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

// setmaxnreg moves registers inside the block's own allocation: a build that gave the bf16
// kernels fewer than kLaunchRegs a thread would leave the consumers waiting for ever, so the
// launch refuses it
template <typename Team, typename Kernel>
cudaError_t check_registers(Kernel kernel) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  return attr.numRegs >= Team::kLaunchRegs ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// q, dO, k and v as tensor maps, in that order
cudaError_t encode_maps(CUtensorMap (&maps)[4], const void* q, const void* dout, const void* k,
                        const void* v, int B, int S, int Tk, int NH, int KV, int D) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (!encode_map(encode, &maps[0], q, 1LL * B * S, NH, D) ||
      !encode_map(encode, &maps[1], dout, 1LL * B * S, NH, D) ||
      !encode_map(encode, &maps[2], k, 1LL * B * Tk, KV, D) ||
      !encode_map(encode, &maps[3], v, 1LL * B * Tk, KV, D))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The kernel's register check and shared-memory limit. These runtime calls come before the
// tensor maps are encoded: they make the device's context current on the calling thread, which
// the encoder (a driver call) needs; on a thread that had made no runtime call, as autograd's
// backward thread after a serving pass in the same process, it refused the maps.
template <typename Team, typename Kernel>
cudaError_t prepare_bf16(Kernel kernel, int smem) {
  const cudaError_t err = check_registers<Team>(kernel);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int D, int kN, bool kBias, bool kRing = false>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v, const int* mask,
                           const int* limit, const float* bias, const void* dout, const void* out,
                           const float* lse, float* delta, void* dq, float* dbias, int B, int S,
                           int Tk, int NH, int KV, int bias_batched, int chunk, float scale,
                           int causal, cudaStream_t stream, const float* dlse = nullptr,
                           int shift = 0) {
  using L = DqLayout<tile_dim(D), kN, kBias>;
  using W = DqTeam<tile_dim(D), kN, kBias>;
  CUtensorMap maps[4];
  if constexpr (kBias) {
    auto kernel = flash_dq_bias_bf16_kernel<D>;
    cudaError_t err = prepare_bf16<W>(kernel, L::kAlloc);  // first: see prepare_bf16
    if (err != cudaSuccess) return err;
    if ((err = encode_maps(maps, q, dout, k, v, B, S, Tk, NH, KV, D)) != cudaSuccess) return err;
    const int chunks = (B + chunk - 1) / chunk;  // a block per chunk of batch rows
    const unsigned grid = static_cast<unsigned>((S + W::kRows - 1) / W::kRows) * NH * chunks;
    kernel<<<grid, W::kThreads, L::kAlloc, stream>>>(
        maps[0], maps[1], maps[2], maps[3], static_cast<const bf16*>(dout),
        static_cast<const bf16*>(out), mask, limit, bias, lse, delta, static_cast<bf16*>(dq),
        dbias, B, S, Tk, NH, KV, bias_batched, chunk, scale, causal);
  } else {
    auto kernel = flash_dq_bf16_kernel<D, kN, kRing>;
    cudaError_t err = prepare_bf16<W>(kernel, L::kAlloc);  // first: see prepare_bf16
    if (err != cudaSuccess) return err;
    if ((err = encode_maps(maps, q, dout, k, v, B, S, Tk, NH, KV, D)) != cudaSuccess) return err;
    const unsigned grid = static_cast<unsigned>((S + W::kRows - 1) / W::kRows) * NH * B;
    kernel<<<grid, W::kThreads, L::kAlloc, stream>>>(
        maps[0], maps[1], maps[2], maps[3], static_cast<const bf16*>(dout),
        static_cast<const bf16*>(out), mask, limit, lse, delta, static_cast<bf16*>(dq), S, Tk, NH,
        KV, scale, causal, dlse, shift);
  }
  return cudaGetLastError();
}

template <int D, int kM, bool kBias, bool kRing = false>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v, const int* mask,
                            const int* limit, const float* bias, const void* dout,
                            const float* lse, const float* delta, void* dk, void* dv, int B,
                            int S, int Tk, int NH, int KV, int bias_batched, float scale,
                            int causal, cudaStream_t stream, int shift = 0) {
  using L = DkvLayout<tile_dim(D), kM>;
  auto kernel = flash_dkv_bf16_kernel<D, kM, kBias, kRing>;
  cudaError_t err = prepare_bf16<DkvTeam>(kernel, L::kAlloc);  // first: see prepare_bf16
  if (err != cudaSuccess) return err;
  CUtensorMap maps[4];
  if ((err = encode_maps(maps, q, dout, k, v, B, S, Tk, NH, KV, D)) != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((Tk + DkvTeam::kRows - 1) / DkvTeam::kRows) * KV * B;
  kernel<<<grid, DkvTeam::kThreads, L::kAlloc, stream>>>(
      maps[0], maps[1], maps[2], maps[3], mask, limit, bias, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), B, S, Tk, NH, KV, bias_batched, scale, causal, shift);
  return cudaGetLastError();
}

template <int D, bool kRing = false>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v, const int* mask,
                          const int* limit, const float* bias, const void* dout, const void* out,
                          const float* lse, float* delta, void* dq, float* dbias, int B, int S,
                          int Tk, int NH, int KV, int bias_batched, int chunk, float scale,
                          int causal, cudaStream_t stream, const float* dlse = nullptr,
                          int shift = 0) {
  const int smem = DqF32Layout<D>::kBytes;
  if (bias != nullptr) {
    auto kernel = flash_dq_bias_f32_kernel<D>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(S / kBlockQ, NH, (B + chunk - 1) / chunk);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        mask, limit, bias, static_cast<const float*>(dout), static_cast<const float*>(out), lse,
        delta, static_cast<float*>(dq), dbias, B, S, Tk, NH, KV, bias_batched, chunk, scale,
        causal);
    return cudaGetLastError();
  }
  auto kernel = flash_dq_f32_kernel<D, kRing>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / kBlockQ, NH, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      mask, limit, static_cast<const float*>(dout), static_cast<const float*>(out), lse, delta,
      static_cast<float*>(dq), S, Tk, NH, KV, scale, causal, dlse, shift);
  return cudaGetLastError();
}

template <int D, bool kRing = false>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v, const int* mask,
                           const int* limit, const float* bias, const void* dout,
                           const float* lse, const float* delta, void* dk, void* dv, int B,
                           int S, int Tk, int NH, int KV, int bias_batched, float scale,
                           int causal, cudaStream_t stream, int shift = 0) {
  auto kernel = kRing ? flash_dkv_f32_kernel<D, false, true>
                      : (bias != nullptr ? flash_dkv_f32_kernel<D, true, false>
                                         : flash_dkv_f32_kernel<D, false, false>);
  const int smem = DkvF32Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Tk / kBlockK, KV, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      mask, limit, bias, static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), S, Tk, NH, KV, bias_batched, scale, causal, shift);
  return cudaGetLastError();
}

// dbias = the sum of the chunks' partial dbias slabs [chunks, n], in chunk order: the
// broadcast bias's batch-summed gradient, the same bits at every launch. n = NH * S * T, a
// multiple of 4.
__global__ void __launch_bounds__(256) dbias_sum_kernel(const float4* __restrict__ part,
                                                        float4* __restrict__ dbias, long long n4,
                                                        int chunks) {
  const long long i = 1LL * blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 acc = part[i];
  for (int c = 1; c < chunks; ++c) {
    const float4 x = part[c * n4 + i];
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  dbias[i] = acc;
}

bool valid(int B, int S, int Tk, int NH, int KV, const void* mask, const void* limit) {
  return B > 0 && S > 0 && Tk > 0 && KV > 0 && NH % KV == 0 && S % kBlockQ == 0 &&
         Tk % kBlockK == 0 && (mask == nullptr) == (limit == nullptr);
}

// the dq kernel for a dtype and head dim; with a bias, 64-key tiles (see DqTeam). kRing: the
// ring-block variant at sh = q_offset - kv_offset with the lse cotangent dlse, without a bias
template <bool kRing>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const int* m, const int* lim,
                      const float* bs, const void* dout, const void* out, const float* l,
                      float* dl, void* dq, float* db, int B, int S, int Tk, int NH, int KV, int D,
                      int batched, int chunk, float scale, int causal, int dtype, cudaStream_t s,
                      const float* dlse, int sh) {
  const bool bias = bs != nullptr;
  if (dtype == 1 && bias && D == 64)
    return launch_dq_bf16<64, 64, true>(q, k, v, m, lim, bs, dout, out, l, dl, dq, db, B, S, Tk, NH,
                                        KV, batched, chunk, scale, causal, s);
  if (dtype == 1 && bias && D == 32)
    return launch_dq_bf16<32, 64, true>(q, k, v, m, lim, bs, dout, out, l, dl, dq, db, B, S, Tk, NH,
                                        KV, batched, chunk, scale, causal, s);
  if (dtype == 1 && bias && D == 128)
    return launch_dq_bf16<128, 64, true>(q, k, v, m, lim, bs, dout, out, l, dl, dq, db, B, S, Tk,
                                         NH, KV, batched, chunk, scale, causal, s);
  if (dtype == 1 && D == 64 && causal && Tk % 128 == 0)  // see DqTeam
    return launch_dq_bf16<64, 128, false, kRing>(q, k, v, m, lim, bs, dout, out, l, dl, dq, db, B,
                                                 S, Tk, NH, KV, batched, chunk, scale, causal, s,
                                                 dlse, sh);
  if (dtype == 1 && D == 32 && causal && Tk % 128 == 0)
    return launch_dq_bf16<32, 128, false, kRing>(q, k, v, m, lim, bs, dout, out, l, dl, dq, db, B,
                                                 S, Tk, NH, KV, batched, chunk, scale, causal, s,
                                                 dlse, sh);
  if (dtype == 1 && D == 32)
    return launch_dq_bf16<32, 64, false, kRing>(q, k, v, m, lim, bs, dout, out, l, dl, dq, db, B, S,
                                                Tk, NH, KV, batched, chunk, scale, causal, s, dlse,
                                                sh);
  if (dtype == 1 && D == 64)
    return launch_dq_bf16<64, 64, false, kRing>(q, k, v, m, lim, bs, dout, out, l, dl, dq, db, B, S,
                                                Tk, NH, KV, batched, chunk, scale, causal, s, dlse,
                                                sh);
  if (dtype == 1 && D == 128)
    return launch_dq_bf16<128, 64, false, kRing>(q, k, v, m, lim, bs, dout, out, l, dl, dq, db, B,
                                                 S, Tk, NH, KV, batched, chunk, scale, causal, s,
                                                 dlse, sh);
  if (dtype == 0 && D == 64)
    return launch_dq_f32<64, kRing>(q, k, v, m, lim, bs, dout, out, l, dl, dq, db, B, S, Tk, NH, KV,
                                    batched, chunk, scale, causal, s, dlse, sh);
  if (dtype == 0 && D == 128)
    return launch_dq_f32<128, kRing>(q, k, v, m, lim, bs, dout, out, l, dl, dq, db, B, S, Tk, NH,
                                     KV, batched, chunk, scale, causal, s, dlse, sh);
  if (dtype == 0 && D == 32)
    return launch_dq_f32<32, kRing>(q, k, v, m, lim, bs, dout, out, l, dl, dq, db, B, S, Tk, NH, KV,
                                    batched, chunk, scale, causal, s, dlse, sh);
  return cudaErrorInvalidValue;
}

// the dk/dv kernel for a dtype and head dim; kRing: the ring-block variant at sh = q_offset -
// kv_offset, without a bias
template <bool kRing>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* mask,
                       const void* limit, const void* bias, const void* dout, const void* lse,
                       const void* delta, void* dk, void* dv, int B, int S, int Tk, int NH, int KV,
                       int D, int bias_batched, float scale, int causal, int dtype, void* stream,
                       int sh) {
  if (!valid(B, S, Tk, NH, KV, mask, limit)) return cudaErrorInvalidValue;
  const int* m = static_cast<const int*>(mask);
  const int* lim = static_cast<const int*>(limit);
  const float* bs = static_cast<const float*>(bias);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int bb = bias_batched;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // with a bias, 64-row q tiles: the 128-row S^T band and its bias values would not fit
  if (dtype == 1 && bs != nullptr && D == 64)
    return launch_dkv_bf16<64, 64, true>(q, k, v, m, lim, bs, dout, l, dl, dk, dv, B, S, Tk, NH, KV,
                                         bb, scale, causal, s);
  if (dtype == 1 && bs != nullptr && D == 32)
    return launch_dkv_bf16<32, 64, true>(q, k, v, m, lim, bs, dout, l, dl, dk, dv, B, S, Tk, NH, KV,
                                         bb, scale, causal, s);
  if (dtype == 1 && bs != nullptr && D == 128)
    return launch_dkv_bf16<128, 64, true>(q, k, v, m, lim, bs, dout, l, dl, dk, dv, B, S, Tk, NH,
                                          KV, bb, scale, causal, s);
  if (dtype == 1 && D == 64 && S % 128 == 0)  // see DkvTeam
    return launch_dkv_bf16<64, 128, false, kRing>(q, k, v, m, lim, bs, dout, l, dl, dk, dv, B, S,
                                                  Tk, NH, KV, bb, scale, causal, s, sh);
  if (dtype == 1 && D == 32 && S % 128 == 0)
    return launch_dkv_bf16<32, 128, false, kRing>(q, k, v, m, lim, bs, dout, l, dl, dk, dv, B, S,
                                                  Tk, NH, KV, bb, scale, causal, s, sh);
  if (dtype == 1 && D == 32)
    return launch_dkv_bf16<32, 64, false, kRing>(q, k, v, m, lim, bs, dout, l, dl, dk, dv, B, S, Tk,
                                                 NH, KV, bb, scale, causal, s, sh);
  if (dtype == 1 && D == 64)
    return launch_dkv_bf16<64, 64, false, kRing>(q, k, v, m, lim, bs, dout, l, dl, dk, dv, B, S, Tk,
                                                 NH, KV, bb, scale, causal, s, sh);
  if (dtype == 1 && D == 128)
    return launch_dkv_bf16<128, 64, false, kRing>(q, k, v, m, lim, bs, dout, l, dl, dk, dv, B, S,
                                                  Tk, NH, KV, bb, scale, causal, s, sh);
  if (dtype == 0 && D == 64)
    return launch_dkv_f32<64, kRing>(q, k, v, m, lim, bs, dout, l, dl, dk, dv, B, S, Tk, NH, KV, bb,
                                     scale, causal, s, sh);
  if (dtype == 0 && D == 128)
    return launch_dkv_f32<128, kRing>(q, k, v, m, lim, bs, dout, l, dl, dk, dv, B, S, Tk, NH, KV,
                                      bb, scale, causal, s, sh);
  if (dtype == 0 && D == 32)
    return launch_dkv_f32<32, kRing>(q, k, v, m, lim, bs, dout, l, dl, dk, dv, B, S, Tk, NH, KV, bb,
                                     scale, causal, s, sh);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Layouts as flash_forward's; dout and out (the forward's output) like q, lse fp32
// [B, NH, S]. Writes delta = rowsum(dout * out), fp32 [B, NH, S], and dq like q. With a bias
// (fp32 [B, NH, S, T], bias_batched 1, or [1, NH, S, T], 0) it writes the bias's gradient
// dbias too (fp32, shaped like the bias; null without a bias): per batch row, or summed over
// the batch,
// where each block walks bias_chunk batch rows into its chunk's slab of dbias_part (fp32
// [ceil(B / bias_chunk), NH, S, T]; dbias itself when that is one chunk) and a second kernel
// sums the chunks in order. Returns a cudaError_t (0 = launched).
int flash_backward_dq(const void* q, const void* k, const void* v, const void* mask,
                      const void* limit, const void* bias, const void* dout, const void* out,
                      const void* lse, void* delta, void* dq, void* dbias, void* dbias_part,
                      int B, int S, int Tk, int NH, int KV, int D, int bias_batched,
                      int bias_chunk, float scale, int causal, int dtype, void* stream) {
  if (!valid(B, S, Tk, NH, KV, mask, limit)) return cudaErrorInvalidValue;
  const float* bs = static_cast<const float*>(bias);
  float* db = static_cast<float*>(dbias);
  const int chunk = bs == nullptr || bias_batched ? 1 : bias_chunk;  // [B, ...]: a block a row
  if (chunk < 1 || (bs == nullptr) != (db == nullptr)) return cudaErrorInvalidValue;
  const int chunks = (B + chunk - 1) / chunk;
  const bool summed = bs != nullptr && !bias_batched && chunks > 1;
  if (summed && dbias_part == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_dq<false>(q, k, v, static_cast<const int*>(mask),
                                     static_cast<const int*>(limit), bs, dout, out,
                                     static_cast<const float*>(lse), static_cast<float*>(delta),
                                     dq, summed ? static_cast<float*>(dbias_part) : db, B, S, Tk,
                                     NH, KV, D, bias_batched, chunk, scale, causal, dtype, s,
                                     nullptr, 0);
  if (err != cudaSuccess || !summed) return err;
  const long long n4 = 1LL * NH * S * Tk / 4;
  const unsigned blocks = static_cast<unsigned>((n4 + 255) / 256);
  dbias_sum_kernel<<<blocks, 256, 0, s>>>(static_cast<const float4*>(dbias_part),
                                          reinterpret_cast<float4*>(db), n4, chunks);
  return cudaGetLastError();
}

// delta as flash_backward_dq writes it; bias as there; dk and dv like k. Returns a
// cudaError_t (0 = launched).
int flash_backward_dkv(const void* q, const void* k, const void* v, const void* mask,
                       const void* limit, const void* bias, const void* dout, const void* lse,
                       const void* delta, void* dk, void* dv, int B, int S, int Tk, int NH,
                       int KV, int D, int bias_batched, float scale, int causal, int dtype,
                       void* stream) {
  return launch_dkv<false>(q, k, v, mask, limit, bias, dout, lse, delta, dk, dv, B, S, Tk, NH,
                           KV, D, bias_batched, scale, causal, dtype, stream, 0);
}

// The ring-block variant of flash_backward_dq (the TPU kernels' `has_offsets` and the lse
// cotangent), without a bias: causal over global positions (query row i at q_offset + i, key
// j at kv_offset + j), and delta = rowsum(dout * out) - dlse (dlse fp32 [B, NH, S], the
// cotangent of the forward's lse), which flash_backward_dkv_ring then reads. A block wholly
// in its keys' past writes dq = 0. Returns a cudaError_t (0 = launched).
int flash_backward_dq_ring(const void* q, const void* k, const void* v, const void* mask,
                           const void* limit, const void* dout, const void* out, const void* lse,
                           const void* dlse, void* delta, void* dq, int B, int S, int Tk, int NH,
                           int KV, int D, int q_offset, int kv_offset, float scale, int causal,
                           int dtype, void* stream) {
  if (!valid(B, S, Tk, NH, KV, mask, limit) || dlse == nullptr) return cudaErrorInvalidValue;
  return launch_dq<true>(q, k, v, static_cast<const int*>(mask), static_cast<const int*>(limit),
                         nullptr, dout, out, static_cast<const float*>(lse),
                         static_cast<float*>(delta), dq, nullptr, B, S, Tk, NH, KV, D, 0, 1, scale,
                         causal, dtype, static_cast<cudaStream_t>(stream),
                         static_cast<const float*>(dlse), q_offset - kv_offset);
}

// The ring-block variant of flash_backward_dkv, without a bias: causal over global positions
// as flash_backward_dq_ring; a block of keys wholly in the queries' future makes no trip and
// writes dk = dv = 0. Returns a cudaError_t (0 = launched).
int flash_backward_dkv_ring(const void* q, const void* k, const void* v, const void* mask,
                            const void* limit, const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int B, int S, int Tk, int NH,
                            int KV, int D, int q_offset, int kv_offset, float scale, int causal,
                            int dtype, void* stream) {
  return launch_dkv<true>(q, k, v, mask, limit, nullptr, dout, lse, delta, dk, dv, B, S, Tk, NH,
                          KV, D, 0, scale, causal, dtype, stream, q_offset - kv_offset);
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

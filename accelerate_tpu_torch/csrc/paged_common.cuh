// The split page walk shared by the paged decode and verify kernels (paged_decode.cu,
// paged_verify.cu) for Hopper (sm_90a).
//
// The function: every slot's `rows = W * group` query rows of kv head g (row r = wi * group + gi
// is window position wi of query head g * group + gi; decode is W = 1) attend the slot's
// committed positions 0 .. length - 1, walked through its int32 page-table row, then the
// window's own keys (not in the pool yet) under an in-window causal mask: row wi sees window
// keys 0 .. wi. q is scaled in q's dtype, p is rounded to the pool's dtype before each P.V
// product, sums are fp32, and positions >= length are never read (NaN may lie there).
//
// Bound: memory. A launch must read sum(lengths) * KV * D * 2 pool elements once; the
// arithmetic is 4 flops per element per query row. Two kernels do the work:
//  1. The walk (`paged_walk_bf16_kernel`, `paged_walk_f32_kernel`): grid (row tiles of 16
//     rows, chunks + 1, slots * KV). Block (t, c, s * KV + g) walks chunk c, `chunk` positions
//     from c * chunk (a multiple of 64, planned on the host by ops/paged_attention.py
//     `paged_plan` from the pool's capacity, never from the lengths, which live on the device),
//     and writes an fp32 partial (o unnormalised, running max m, sum l) for each of its rows.
//     A block whose chunk starts at or past its slot's length writes the empty partial (m =
//     M_INIT, l = 0) and leaves. The last column, c = chunks, walks the window's own keys from
//     k_new / v_new the same way, under the in-window causal mask. So a long slot's walk is
//     spread over as many blocks as it has chunks, the window's keys are scored on the same
//     path as the pool's, and the slowest block walks one chunk, not the longest slot.
//  2. The combine (`paged_combine_kernel`): one warp per (slot, row) takes the largest max M
//     of the chunks + 1 partials, then sums o * exp(m - M) and l * exp(m - M) in chunk order
//     (an l = 0 partial contributes exactly nothing; four chunks' loads in flight at once)
//     and writes the output in q's dtype. No atomics: two launches give the same bits. It is
//     launched as a programmatic dependent of the walk (its blocks are scheduled while the
//     walk's last blocks run and wait for the walk's memory before they read), which hides
//     its launch.
// bf16 walk: four warps, each with a private cp.async ring of 16-position steps (K and V rows
// gathered through the page table, 16 bytes a copy, zero-filled past the chunk's end), so no
// block-wide barrier runs inside the walk; the rows land XOR-swizzled (16-byte chunk c of row r
// at c ^ (r % 8), or c ^ (r / 2 % 4) for 64-byte rows) so that ldmatrix reads them without bank
// conflicts. The warps take interleaved steps of the chunk. The score block Q.K^T (16 rows x 16
// positions) and P.V run on the tensor cores (mma.sync m16n8k16, bf16, fp32 accumulators;
// rows past W * group are zero), the online softmax in the accumulator registers (a row's four
// lanes reduce by shuffles, exponentials by ex2). At the end the four warps' partials merge in
// warp order through shared memory. Any page size works: each row's page is looked up in the
// chunk's table entries, staged in shared memory once.
// fp32 walk: the CUDA cores (the tensor cores take fp32 only as TF32): a block-wide cp.async
// ring of 32-position tiles, four lanes per q.k dot product, a warp per row for the softmax.
//
// Launch rules: the kernels run on the caller's stream, allocate nothing (the wrapper passes
// the partials' scratch) and do not synchronise; `run` returns cudaGetLastError().

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 16;          // query rows of a walk block: one m16 tile
constexpr int kCombineRows = kWarps;  // rows of a combine block: one a warp
constexpr int kChunkQuantum = 64;     // a chunk is a multiple of this many positions
constexpr int kMaxChunk = 2048;       // bounds the table entries staged in shared memory
constexpr float kMInit = -5e29f;      // flash_attention.py M_INIT = NEG_INF / 2
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// What one launch computes. q / out [S, W, NH, D], k_new / v_new [S, W, KV, D], pools [P, ps,
// KV, D], tables [S, pps], lengths [S]; part_o [S * KV, chunks + 1, rows, D] and part_ml
// [S * KV, chunks + 1, rows, 2] fp32 are the walk's partials.
struct Args {
  const void* q;
  const void* k_new;
  const void* v_new;
  const void* pool_k;
  const void* pool_v;
  const int* tables;
  const int* lengths;
  void* out;
  float* part_o;
  float* part_ml;
  float scale;  // already rounded to q's dtype
  int window, nh, kv, ps, pps, chunk, chunks;
};

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

// the TPU kernels cast p (and q * scale) to the operand dtype
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float<T>(from_float<T>(x));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}
// 16 bytes, or 16 zero bytes and no read when !valid
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// butterfly reductions: every lane ends with the same bits (each step adds the same two values)
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

// element offset of query row r (window position r / group, head g * group + r % group) of a
// [S, W, NH, D] tensor
__device__ __forceinline__ size_t row_offset(const Args& a, int slot, int g, int r, int D) {
  const int group = a.nh / a.kv;
  const int wi = r / group;
  return ((static_cast<size_t>(slot) * a.window + wi) * a.nh + static_cast<size_t>(g) * group +
          (r - wi * group)) * D;
}

// What one walk block covers: positions start .. end - 1 of its slot's pool, or, in the last
// chunk column, the window's keys 0 .. W - 1 (`window`).
struct Span {
  int slot, g, r0, nr, start, end;
  bool window;
  size_t pr0;  // the partial index of the block's first row
};

__device__ __forceinline__ Span block_span(const Args& a) {
  Span b;
  const int rows = a.window * (a.nh / a.kv);
  const int c = blockIdx.y;
  b.slot = blockIdx.z / a.kv;
  b.g = blockIdx.z - b.slot * a.kv;
  b.r0 = blockIdx.x * kRowTile;
  b.nr = min(kRowTile, rows - b.r0);
  b.window = c == a.chunks;
  b.start = b.window ? 0 : c * a.chunk;
  b.end = b.window ? a.window : min(a.lengths[b.slot], b.start + a.chunk);
  b.pr0 = (static_cast<size_t>(blockIdx.z) * (a.chunks + 1) + c) * rows + b.r0;
  return b;
}

// element offset of key `pos` of kv head g (a 16-byte column chunk's first element added by the
// caller): the page table's row in the pool, or window key `pos` of [S, W, KV, D]
__device__ __forceinline__ size_t key_offset(const Args& a, const Span& b, const int* table_s,
                                             int first, int pos, int D) {
  if (b.window) return ((static_cast<size_t>(b.slot) * a.window + pos) * a.kv + b.g) * D;
  const int page = table_s[pos / a.ps - first];
  return ((static_cast<size_t>(page) * a.ps + pos % a.ps) * a.kv + b.g) * D;
}

// the table entries of the chunk's whole span into shared memory, read while the slot's length
// is (the entries past the length are read, never followed); returns the first page's index
__device__ __forceinline__ int stage_table(const Args& a, const Span& b, int* table_s) {
  if (b.window) return 0;
  const int first = b.start / a.ps;
  const int stop = min(b.start + a.chunk, a.pps * a.ps);  // past the positions the chunk may hold
  const int* table = a.tables + static_cast<size_t>(b.slot) * a.pps;
  for (int j = threadIdx.x; j < (stop + a.ps - 1) / a.ps - first; j += kThreads)
    table_s[j] = table[first + j];
  return first;
}

// the empty partial of the block's rows
__device__ __forceinline__ void write_empty(const Args& a, const Span& b) {
  for (int i = threadIdx.x; i < b.nr; i += kThreads) {
    a.part_ml[2 * (b.pr0 + i)] = kMInit;
    a.part_ml[2 * (b.pr0 + i) + 1] = 0.f;
  }
}

// ---- the combine: the partials in chunk order --------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_combine_kernel(const Args a) {
  constexpr int kPer = D / 32;  // columns a lane owns: lane, lane + 32, ...
  const int lane = threadIdx.x & 31;
  const int rows = a.window * (a.nh / a.kv);
  const int r = blockIdx.x * kCombineRows + (threadIdx.x >> 5);
  const int slot = blockIdx.z;
  const int g = blockIdx.y;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the walk's partials are written
  if (r >= rows) return;
  const int parts = a.chunks + 1;
  const size_t base = (static_cast<size_t>(slot) * a.kv + g) * parts * rows + r;
  // the largest max of the parts that saw a key: each lane takes parts lane, lane + 32, ...
  float m = kMInit;
  for (int c = lane; c < parts; c += 32) {
    const size_t pr = base + static_cast<size_t>(c) * rows;
    if (a.part_ml[2 * pr + 1] != 0.f) m = fmaxf(m, a.part_ml[2 * pr]);
  }
  m = warp_max(m);
  float l = 0.f;
  float acc[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) acc[e] = 0.f;
#pragma unroll 4
  for (int c = 0; c < parts; ++c) {  // in chunk order
    const size_t pr = base + static_cast<size_t>(c) * rows;
    const float lc = a.part_ml[2 * pr + 1];
    if (lc != 0.f) {  // an empty chunk: exactly nothing (its o was never written)
      const float f = expf(a.part_ml[2 * pr] - m);
      l += lc * f;
      const float* po = a.part_o + pr * D;
#pragma unroll
      for (int e = 0; e < kPer; ++e) acc[e] += po[lane + 32 * e] * f;
    }
  }
  T* out = static_cast<T*>(a.out) + row_offset(a, slot, g, r, D);
#pragma unroll
  for (int e = 0; e < kPer; ++e) out[lane + 32 * e] = from_float<T>(acc[e] / l);
}

// ---- bf16: mma.sync on the tensor cores, a private cp.async ring per warp --------------------

// 16-byte chunk `c` of row `r` in a tile of rows of kC chunks (64 x 8 * kC bytes)
template <int kC>
__device__ __forceinline__ int swizzle(int r, int c) {
  static_assert(kC == 4 || kC == 8 || kC == 16, "rows of 64, 128 or 256 bytes");
  return r * kC + (kC >= 8 ? (c ^ (r & 7)) : (c ^ ((r >> 1) & 3)));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&d)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem_u32(p)));
}
// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
struct Bf16Layout {
  static constexpr int kC = D / 8;             // 16-byte chunks of a row
  static constexpr int kStep = 16;             // positions of a warp step
  static constexpr int kStages = 3;            // a warp's steps in flight
  static constexpr int kTileBytes = kStep * D * 2;
  static constexpr int kWarpBytes = kStages * 2 * kTileBytes;  // K and V of each stage
  static constexpr int kRing = kWarps * kWarpBytes;
  static constexpr int kLdO = D + 4;           // the merge buffer's row stride, in floats
  static constexpr int kMerge = kWarps * kRowTile * (kLdO + 2) * 4;
  static constexpr int kBytes = (kRing > kMerge ? kRing : kMerge);
};

template <int D>
__global__ void __launch_bounds__(kThreads) paged_walk_bf16_kernel(const Args a) {
  using L = Bf16Layout<D>;
  constexpr int kC = L::kC;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // the combine may queue
  const Span b = block_span(a);
  const int group = a.nh / a.kv;
  const int rows = a.window * group;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  extern __shared__ __align__(128) unsigned char smem[];
  int* table_s = reinterpret_cast<int*>(smem + L::kBytes);
  const int first = stage_table(a, b, table_s);  // in flight with the length's read
  const bf16* keys = static_cast<const bf16*>(b.window ? a.k_new : a.pool_k);
  const bf16* values = static_cast<const bf16*>(b.window ? a.v_new : a.pool_v);
  // q * scale rounded to bf16, as the m16n8k16 A operand of each k16 step: lane (gid, tig)
  // holds rows gid and gid + 8, columns 2 tig, 2 tig + 1 and 8 more; rows past `rows` are 0.
  // In the window's chunk row r sees keys up to its window position r / group.
  const int gid = lane >> 2;
  const int tig = lane & 3;
  uint32_t qa[D / 16][4];
  int last_key[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = b.r0 + gid + 8 * rr;
    last_key[rr] = b.window ? r / group : b.end;
    const bf16* qrow = static_cast<const bf16*>(a.q) + (r < rows ? row_offset(a, b.slot, b.g, r, D) : 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t v = 0;
        if (r < rows) {
          const __nv_bfloat162 x =
              *reinterpret_cast<const __nv_bfloat162*>(qrow + ks * 16 + half * 8 + 2 * tig);
          v = pack_bf16x2(round_to<bf16>(__low2float(x) * a.scale),
                          round_to<bf16>(__high2float(x) * a.scale));
        }
        qa[ks][rr + 2 * half] = v;
      }
  }
  if (b.start >= b.end) {
    write_empty(a, b);
    return;
  }
  __syncthreads();  // the table entries are staged

  // this warp's steps: positions start + 16 (warp + 4 i) .. + 15
  const int span = b.end - b.start;
  const int nsteps =
      span > L::kStep * warp ? (span - L::kStep * warp + kWarps * L::kStep - 1) / (kWarps * L::kStep) : 0;
  unsigned char* ring = smem + warp * L::kWarpBytes;
  // a step's copies: lane r < 16 looks up row r's offset once (-1 past the end), and each copy
  // takes its row's by shuffle; neighbouring lanes copy neighbouring 16 bytes of a row
  auto issue = [&](int i) {
    const int base = b.start + L::kStep * (warp + kWarps * i);
    bf16* kst = reinterpret_cast<bf16*>(ring + (i % L::kStages) * 2 * L::kTileBytes);
    bf16* vst = kst + L::kStep * D;
    const int own = base + (lane & (L::kStep - 1));
    const long long own_off =
        own < b.end ? static_cast<long long>(key_offset(a, b, table_s, first, own, D)) : -1;
#pragma unroll
    for (int x = lane; x < L::kStep * kC; x += 32) {
      const int row = x / kC;
      const int ch = x - row * kC;
      const long long off = __shfl_sync(0xffffffffu, own_off, row);
      const bool valid = off >= 0;
      const int at = swizzle<kC>(row, ch) * 8;
      cp_async16_zfill(kst + at, keys + (valid ? off + ch * 8 : 0), valid);
      cp_async16_zfill(vst + at, values + (valid ? off + ch * 8 : 0), valid);
    }
  };
#pragma unroll
  for (int i = 0; i < L::kStages - 1; ++i) {
    if (i < nsteps) issue(i);
    cp_async_commit();
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {kMInit, kMInit};
  float l_run[2] = {0.f, 0.f};  // this lane's share; a row's four lanes add at the end
  const int mi = lane >> 3;     // the 8 x 8 matrix whose row address this lane gives ldmatrix
  const int mr = lane & 7;

  for (int i = 0; i < nsteps; ++i) {
    if (i + L::kStages - 1 < nsteps) issue(i + L::kStages - 1);
    cp_async_commit();
    cp_async_wait<L::kStages - 1>();  // step i's copies have landed
    __syncwarp();
    const unsigned char* kst = ring + (i % L::kStages) * 2 * L::kTileBytes;
    const unsigned char* vst = kst + L::kTileBytes;
    const int base = b.start + L::kStep * (warp + kWarps * i);

    // S = Q.K^T: 16 rows x 16 positions; K rows are the B operand's columns
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t kb[4];
      ldsm_x4(kb, kst + swizzle<kC>((mi >> 1) * 8 + mr, 2 * ks + (mi & 1)) * 16);
      mma_bf16(s[0], qa[ks], kb[0], kb[1]);
      mma_bf16(s[1], qa[ks], kb[2], kb[3]);
    }

    // online softmax of the lane's rows gid (e < 2) and gid + 8 (e >= 2): a position past the
    // chunk's end, or a window key past the row's window position, scores NEG_INF
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = base + n * 8 + 2 * tig + (e & 1);
        if (pos >= b.end || pos > last_key[e >> 1]) s[n][e] = kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float m_log2[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      corr[r] = exp2_approx((m_run[r] - m_new) * kLog2e);
      m_log2[r] = m_new * kLog2e;
      m_run[r] = m_new;
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2_approx(fmaf(s[n][e], kLog2e, -m_log2[e >> 1]));
        l_run[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
    // p rounded to bf16 in the A layout: the accumulators of the two 8-position tiles
    const uint32_t pa[4] = {pack_bf16x2(s[0][0], s[0][1]), pack_bf16x2(s[0][2], s[0][3]),
                            pack_bf16x2(s[1][0], s[1][1]), pack_bf16x2(s[1][2], s[1][3])};

    // O += P.V: V rows are the k of the product, read transposed by ldmatrix
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      uint32_t vb[4];
      ldsm_x4_t(vb, vst + swizzle<kC>((mi & 1) * 8 + mr, 2 * j + (mi >> 1)) * 16);
      mma_bf16(o[2 * j], pa, vb[0], vb[1]);
      mma_bf16(o[2 * j + 1], pa, vb[2], vb[3]);
    }
    __syncwarp();  // every lane has read the stage before it is refilled
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }

  // the warps' partials merge in warp order through shared memory (the ring's space)
  __syncthreads();
  float* mo = reinterpret_cast<float*>(smem);    // [warp][16][kLdO]
  float* mm = mo + kWarps * kRowTile * L::kLdO;  // [warp][16] max
  float* ml = mm + kWarps * kRowTile;            // [warp][16] sum
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mo[(warp * kRowTile + gid + 8 * (e >> 1)) * L::kLdO + n * 8 + 2 * tig + (e & 1)] = o[n][e];
  if (tig == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mm[warp * kRowTile + gid + 8 * r] = m_run[r];
      ml[warp * kRowTile + gid + 8 * r] = l_run[r];
    }
  __syncthreads();
  for (int x = tid; x < b.nr * D; x += kThreads) {
    const int row = x / D;
    const int d = x - row * D;
    float m = mm[row];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, mm[w * kRowTile + row]);
    float acc = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(mm[w * kRowTile + row] - m);  // 0 for a warp that saw nothing
      acc += mo[(w * kRowTile + row) * L::kLdO + d] * f;
      l += ml[w * kRowTile + row] * f;
    }
    a.part_o[b.pr0 * D + x] = acc;
    if (d == 0) {
      a.part_ml[2 * (b.pr0 + row)] = m;
      a.part_ml[2 * (b.pr0 + row) + 1] = l;
    }
  }
}

// ---- fp32: CUDA cores, a block-wide cp.async ring -------------------------------------------

template <int D>
struct F32Layout {
  static constexpr int kTile = 32;      // positions a tile; one softmax lane each
  static constexpr int kStages = 3;     // tiles in flight
  static constexpr int kVec = 4;        // floats a 16-byte copy
  static constexpr int kChunks = D / kVec;
  static constexpr int kRowElems = D + 16;  // rows padded by 64 bytes
  static constexpr int kTileElems = kTile * kRowElems;
  static constexpr int kDotLanes = 4;   // lanes sharing one q.k dot product
  static constexpr int kMaxAcc = kRowTile * D / kThreads;  // outputs a thread
  static constexpr int kBytes =
      4 * (2 * kStages * kTileElems + kRowTile * D + kRowTile * kTile + 3 * kRowTile);
  static_assert(kChunks % kDotLanes == 0, "a row splits over the dot lanes");
};

template <int D>
__global__ void __launch_bounds__(kThreads) paged_walk_f32_kernel(const Args a) {
  using L = F32Layout<D>;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // the combine may queue
  const Span b = block_span(a);
  const int group = a.nh / a.kv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);      // [kStages][kTile][kRowElems]
  float* vs = ks + L::kStages * L::kTileElems;     // [kStages][kTile][kRowElems]
  float* qf = vs + L::kStages * L::kTileElems;     // [16][D]
  float* probs = qf + kRowTile * D;                // [16][kTile]
  float* m_s = probs + kRowTile * L::kTile;        // [16] running max
  float* l_s = m_s + kRowTile;                     // [16] running sum
  float* c_s = l_s + kRowTile;                     // [16] this tile's correction
  int* table_s = reinterpret_cast<int*>(smem + L::kBytes);
  const int first = stage_table(a, b, table_s);  // in flight with the length's read
  if (b.start >= b.end) {
    write_empty(a, b);
    return;
  }
  const float* keys = static_cast<const float*>(b.window ? a.k_new : a.pool_k);
  const float* values = static_cast<const float*>(b.window ? a.v_new : a.pool_v);
  const float* q = static_cast<const float*>(a.q);
  for (int i = tid; i < b.nr * D; i += kThreads) {
    const int r = i / D;
    qf[i] = q[row_offset(a, b.slot, b.g, b.r0 + r, D) + (i - r * D)] * a.scale;
  }
  for (int i = tid; i < b.nr; i += kThreads) {
    m_s[i] = kMInit;
    l_s[i] = 0.f;
  }
  float acc[L::kMaxAcc];
#pragma unroll
  for (int j = 0; j < L::kMaxAcc; ++j) acc[j] = 0.f;
  const int ntiles = (b.end - b.start + L::kTile - 1) / L::kTile;
  __syncthreads();  // the table entries are staged

  auto load_tile = [&](int t, int stage) {
    const int base = b.start + t * L::kTile;
    const int nvalid = min(L::kTile, b.end - base);
    float* kst = ks + stage * L::kTileElems;
    float* vst = vs + stage * L::kTileElems;
    for (int x = tid; x < nvalid * L::kChunks; x += kThreads) {
      const int r = x / L::kChunks;
      const int col = (x - r * L::kChunks) * L::kVec;
      const size_t off = key_offset(a, b, table_s, first, base + r, D) + col;
      cp_async16(kst + r * L::kRowElems + col, keys + off);
      cp_async16(vst + r * L::kRowElems + col, values + off);
    }
  };
#pragma unroll
  for (int t = 0; t < L::kStages - 1; ++t) {
    if (t < ntiles) load_tile(t, t);
    cp_async_commit();
  }

  for (int t = 0; t < ntiles; ++t) {
    const int stage = t % L::kStages;
    // refill the stage tile t - 1 used (freed by the trailing barrier of iteration t - 1)
    const int ahead = t + L::kStages - 1;
    if (ahead < ntiles) load_tile(ahead, ahead % L::kStages);
    cp_async_commit();
    cp_async_wait<L::kStages - 1>();
    __syncthreads();
    const int base = b.start + t * L::kTile;
    const int nvalid = min(L::kTile, b.end - base);
    const float* kst = ks + stage * L::kTileElems;
    const float* vst = vs + stage * L::kTileElems;

    // scores: kDotLanes lanes per (row, position), each over D / kDotLanes elements
    const int items = b.nr * nvalid * L::kDotLanes;
    for (int w0 = 0; w0 < items; w0 += kThreads) {
      const int w = w0 + tid;
      const int pair = w / L::kDotLanes;
      const int part = w % L::kDotLanes;
      const int h = pair / nvalid;
      const int r = pair - h * nvalid;
      float s = 0.f;
      if (w < items) {
        const float* qh = qf + h * D;
        const float* krow = kst + r * L::kRowElems;
#pragma unroll
        for (int j = 0; j < L::kChunks / L::kDotLanes; ++j) {
          const int col = (j * L::kDotLanes + part) * L::kVec;
          const float4 k4 = *reinterpret_cast<const float4*>(krow + col);
          s += qh[col] * k4.x + qh[col + 1] * k4.y + qh[col + 2] * k4.z + qh[col + 3] * k4.w;
        }
      }
#pragma unroll
      for (int o = 1; o < L::kDotLanes; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (w < items && part == 0) probs[h * L::kTile + r] = s;
    }
    __syncthreads();

    // online softmax of this tile, a warp a row, a lane a position; in the window's chunk row
    // h sees keys up to its window position
    for (int h = warp; h < b.nr; h += kWarps) {
      const bool valid = lane < nvalid && (!b.window || base + lane <= (b.r0 + h) / group);
      const float s = valid ? probs[h * L::kTile + lane] : kNegInf;
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float l_tile = warp_sum(p);
      probs[h * L::kTile + lane] = p;
      if (lane == 0) {
        const float cr = expf(m_old - m_new);
        l_s[h] = l_s[h] * cr + l_tile;
        m_s[h] = m_new;
        c_s[h] = cr;
      }
    }
    __syncthreads();

    // acc = acc * correction + p . V, a thread over its (row, column) outputs
#pragma unroll
    for (int j = 0; j < L::kMaxAcc; ++j) {
      const int o = tid + j * kThreads;
      if (o < b.nr * D) {
        const int h = o / D;
        const int d = o - h * D;
        const float* ph = probs + h * L::kTile;
        float v = acc[j] * c_s[h];
        for (int r = 0; r < nvalid; ++r) v += ph[r] * vst[r * L::kRowElems + d];
        acc[j] = v;
      }
    }
    __syncthreads();  // tile t's buffers and probs are free for reuse
  }
  cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < L::kMaxAcc; ++j) {
    const int o = tid + j * kThreads;
    if (o < b.nr * D) a.part_o[b.pr0 * D + o] = acc[j];
  }
  for (int i = tid; i < b.nr; i += kThreads) {
    a.part_ml[2 * (b.pr0 + i)] = m_s[i];
    a.part_ml[2 * (b.pr0 + i) + 1] = l_s[i];
  }
}

// ---- host ---------------------------------------------------------------------------------------

template <typename T, int D, typename Walk>
cudaError_t launch(Walk walk, int walk_bytes, const Args& a, int slots, cudaStream_t stream) {
  const int rows = a.window * (a.nh / a.kv);
  const int smem = walk_bytes + 4 * (a.chunk / a.ps + 2);  // + the chunk's table entries
  cudaError_t err = cudaFuncSetAttribute(walk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + kRowTile - 1) / kRowTile, a.chunks + 1, slots * a.kv);
  walk<<<grid, kThreads, smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // the combine as a programmatic dependent: scheduled while the walk's last blocks run
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((rows + kCombineRows - 1) / kCombineRows, a.kv, slots);
  config.blockDim = dim3(kThreads);
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&config, paged_combine_kernel<T, D>, a)) != cudaSuccess) return err;
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16; d in {32, 64, 128}. Returns a cudaError_t (0 = launched).
inline cudaError_t run(const Args& a, int slots, int d, int dtype, cudaStream_t stream) {
  if (slots <= 0 || a.kv <= 0 || a.nh <= 0 || a.nh % a.kv != 0 || a.window < 1 || a.ps < 1 ||
      a.pps < 0 || a.chunk < kChunkQuantum || a.chunk % kChunkQuantum != 0 ||
      a.chunk > kMaxChunk || a.chunks < 1 || a.chunks >= 65535 ||
      static_cast<long long>(a.chunks) * a.chunk < static_cast<long long>(a.pps) * a.ps ||
      static_cast<long long>(slots) * a.kv > 65535 || slots > 65535)
    return cudaErrorInvalidValue;
  if (dtype == 1 && d == 128)
    return launch<bf16, 128>(paged_walk_bf16_kernel<128>, Bf16Layout<128>::kBytes, a, slots, stream);
  if (dtype == 1 && d == 64)
    return launch<bf16, 64>(paged_walk_bf16_kernel<64>, Bf16Layout<64>::kBytes, a, slots, stream);
  if (dtype == 1 && d == 32)
    return launch<bf16, 32>(paged_walk_bf16_kernel<32>, Bf16Layout<32>::kBytes, a, slots, stream);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(paged_walk_f32_kernel<128>, F32Layout<128>::kBytes, a, slots, stream);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(paged_walk_f32_kernel<64>, F32Layout<64>::kBytes, a, slots, stream);
  if (dtype == 0 && d == 32)
    return launch<float, 32>(paged_walk_f32_kernel<32>, F32Layout<32>::kBytes, a, slots, stream);
  return cudaErrorInvalidValue;
}

}  // namespace paged

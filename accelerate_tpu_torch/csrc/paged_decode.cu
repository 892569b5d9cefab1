// Paged decode attention for Hopper (sm_90a), one walk launch (and one combine launch) per
// layer per decode step.
//
// Replaces the Pallas TPU kernel `_decode_kernel` (accelerate_tpu/ops/paged_attention.py): every
// slot's `group = NH / KV` query heads of each kv head attend the slot's pages up to `length`,
// then the current token's k_new / v_new as the final key (the engine scatters it into the pool
// after the step). Positions >= length are never read; the running max starts at M_INIT =
// -5e29, so a lane with length 0 returns v_new exactly. It is the split page walk of
// paged_common.cuh at window 1.
//
// Bound: memory, sum(lengths) * KV * D * 2 pool elements read once per launch (4 flops per
// element per query head). The design against it (paged_common.cuh): the walk is split into
// chunks over (row tile, chunk, slot x kv head) blocks, planned on the host for one to two
// waves of the 132 SMs, so one long slot no longer sets the time; bf16 rows (the group's query
// heads, padded to 16) are scored and multiplied on the tensor cores (mma.sync) from
// XOR-swizzled shared memory that each warp fills with its own cp.async ring, so the walk has
// no block-wide barrier; the current token is one more chunk of the walk (one key); the
// partials merge in chunk order in a second kernel (no atomics, the same bits every launch),
// launched as a programmatic dependent of the walk so that its launch overlaps the walk's tail.
// Not yet here: TMA page copies (a 4-D tensor map per page would need ps % 8 == 0), and a
// persistent grid that would spare the empty chunks of short slots their launch slots.
//
// Launch rules: the kernels run on the caller's stream, allocate nothing and do not
// synchronise. The C entry point returns cudaGetLastError() after the launches.

#include "paged_common.cuh"

extern "C" {

// q / out [S, NH, D], k_new / v_new [S, KV, D], pools [P, ps, KV, D], tables int32 [S, pps],
// lengths int32 [S]; scratch fp32 of S * NH * (chunks + 1) * (D + 2) floats. `chunk`
// positions a chunk (a multiple of 64, at most 2048), chunks * chunk >= pps * ps.
// dtype: 0 = float32, 1 = bfloat16; d in {32, 64, 128}. Returns a cudaError_t (0 = launched).
int paged_decode_attention(const void* q, const void* k_new, const void* v_new,
                           const void* pool_k, const void* pool_v, const void* tables,
                           const void* lengths, void* out, void* scratch, float scale, int slots,
                           int nh, int kv, int d, int ps, int pps, int chunk, int chunks,
                           int dtype, void* stream) {
  if (kv <= 0 || slots <= 0 || chunks <= 0) return cudaErrorInvalidValue;
  float* part_o = static_cast<float*>(scratch);
  const paged::Args a{q, k_new, v_new, pool_k, pool_v, static_cast<const int*>(tables),
                      static_cast<const int*>(lengths), out, part_o,
                      part_o + static_cast<size_t>(slots) * nh * (chunks + 1) * d,
                      scale, 1, nh, kv, ps, pps, chunk, chunks};
  return paged::run(a, slots, d, dtype, static_cast<cudaStream_t>(stream));
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

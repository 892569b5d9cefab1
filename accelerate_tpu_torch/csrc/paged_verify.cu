// Paged speculative-verify attention for Hopper (sm_90a), one walk launch (and one combine
// launch) per layer per verify step.
//
// Replaces the Pallas TPU kernel `_verify_kernel` (accelerate_tpu/ops/paged_attention.py): every
// slot's W window positions x `group` query heads of each kv head (row wi * group + gi) attend
// the slot's committed pages up to `length`, then the window's own keys under an in-window
// causal mask: row wi sees window keys 0 .. wi. At W = 1 this is the decode kernel's function.
// Positions >= length are never read (NaN may lie in stale tails); a length-0 lane attends
// window keys 0 .. wi only; q is scaled in q's dtype; p is rounded to the pool's dtype before
// each P.V product. Any window and any group: rows beyond one 16-row tile take more blocks
// (the grid's first axis), which read the same K/V rows through L2, and the window's keys are
// one more chunk of the walk, scored on the tensor cores under the in-window causal mask.
//
// Bound: memory, sum(lengths) * KV * D * 2 pool elements read once per launch, with 4 flops per
// element per row, W * group rows (5 at llama-1b's k = 4, 40 at the 64/8 GQA layout): the score
// block is W * group x positions. The design against it is paged_common.cuh's split page walk:
// chunks over blocks planned for one to two waves, the 16-row x 16-position score blocks and
// P.V on the tensor cores (mma.sync, bf16, fp32 sums) from swizzled per-warp cp.async rings,
// and an ordered combine of the chunks' partials (no atomics) launched as a programmatic
// dependent of the walk.
// Not yet here: TMA page copies, and rows past 16 sharing one walk block (each row tile walks
// the pages again, from L2).
//
// Launch rules: the kernels run on the caller's stream, allocate nothing and do not
// synchronise. The C entry point returns cudaGetLastError() after the launches.

#include "paged_common.cuh"

extern "C" {

// q / out [S, W, NH, D], k_new / v_new [S, W, KV, D], pools [P, ps, KV, D], tables int32
// [S, pps], lengths int32 [S]; scratch fp32 of S * W * NH * (chunks + 1) * (D + 2) floats.
// `chunk` positions a chunk (a multiple of 64, at most 2048), chunks * chunk >= pps * ps.
// dtype: 0 = float32, 1 = bfloat16; d in {32, 64, 128}. Returns a cudaError_t (0 = launched).
int paged_verify_attention(const void* q, const void* k_new, const void* v_new,
                           const void* pool_k, const void* pool_v, const void* tables,
                           const void* lengths, void* out, void* scratch, float scale, int slots,
                           int window, int nh, int kv, int d, int ps, int pps, int chunk,
                           int chunks, int dtype, void* stream) {
  if (kv <= 0 || slots <= 0 || chunks <= 0 || window <= 0) return cudaErrorInvalidValue;
  float* part_o = static_cast<float*>(scratch);
  const paged::Args a{q, k_new, v_new, pool_k, pool_v, static_cast<const int*>(tables),
                      static_cast<const int*>(lengths), out, part_o,
                      part_o + static_cast<size_t>(slots) * window * nh * (chunks + 1) * d,
                      scale, window, nh, kv, ps, pps, chunk, chunks};
  return paged::run(a, slots, d, dtype, static_cast<cudaStream_t>(stream));
}

const char* paged_verify_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

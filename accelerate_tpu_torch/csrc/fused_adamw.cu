// Fused adamw update of one parameter leaf for Hopper (sm_90a), in place.
//
// Replaces the Pallas TPU kernel `_adamw_kernel` (accelerate_tpu/ops/fused_adamw.py), which
// runs optax's adamw update for one leaf in one pass with its outputs aliased to its inputs.
// Per element, in optax's order:
//   mu' = (1-b1)*g + b1*mu;  nu' = (1-b2)*(g*g) + b2*nu
//   u = (mu'/bc1) / (sqrt(nu'/bc2 + eps_root) + eps) + wd*p;  p' = p + (-lr)*u
// with the two bias corrections bc = [1 - b1^t, 1 - b2^t] read from device memory (computed
// once per step by the wrapper, so no host sync). Every multiply and add is a rounded
// __fmul_rn / __fadd_rn that nvcc cannot contract into an FMA, and the division and square
// root are IEEE (__fdiv_rn, __fsqrt_rn): the result equals PyTorch's op-by-op plain version
// bit for bit.
//
// Bound: memory. Each element reads p, mu, nu, g and writes p, mu, nu: 28 bytes, 7 x 4 x n
// at 3.35 TB/s; 1.121 ms over llama-125m's 134.1M parameters. Design against it: one pass,
// 16-byte vector loads and stores (float4) in a grid-stride loop, a scalar tail for the
// last n % 4 elements, enough blocks to fill every SM several times over.
//
// Launch rules: the kernel runs on the caller's stream, allocates nothing and does not
// synchronise. The C entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 blocks per SM on the H100's 132 SMs

struct Hyper {
  float one_minus_b1, b1, one_minus_b2, b2, eps, eps_root, weight_decay, neg_lr;
};

__device__ __forceinline__ void update(float& p, float& mu, float& nu, float g, float bc1,
                                       float bc2, const Hyper& h) {
  const float m = __fadd_rn(__fmul_rn(h.one_minus_b1, g), __fmul_rn(h.b1, mu));
  const float v = __fadd_rn(__fmul_rn(h.one_minus_b2, __fmul_rn(g, g)), __fmul_rn(h.b2, nu));
  const float m_hat = __fdiv_rn(m, bc1);
  const float v_hat = __fdiv_rn(v, bc2);
  float u = __fdiv_rn(m_hat, __fadd_rn(__fsqrt_rn(__fadd_rn(v_hat, h.eps_root)), h.eps));
  u = __fadd_rn(u, __fmul_rn(h.weight_decay, p));
  p = __fadd_rn(p, __fmul_rn(h.neg_lr, u));
  mu = m;
  nu = v;
}

__global__ void __launch_bounds__(kThreads) adamw_kernel(
    float* __restrict__ p, float* __restrict__ mu, float* __restrict__ nu,
    const float* __restrict__ g, const float* __restrict__ bc, long long n, Hyper h) {
  const float bc1 = bc[0];
  const float bc2 = bc[1];
  const long long nvec = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* mu4 = reinterpret_cast<float4*>(mu);
  float4* nu4 = reinterpret_cast<float4*>(nu);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < nvec;
       i += stride) {
    float4 pv = p4[i], mv = mu4[i], vv = nu4[i];
    const float4 gv = __ldg(g4 + i);
    update(pv.x, mv.x, vv.x, gv.x, bc1, bc2, h);
    update(pv.y, mv.y, vv.y, gv.y, bc1, bc2, h);
    update(pv.z, mv.z, vv.z, gv.z, bc1, bc2, h);
    update(pv.w, mv.w, vv.w, gv.w, bc1, bc2, h);
    p4[i] = pv;
    mu4[i] = mv;
    nu4[i] = vv;
  }
  // the last n % 4 elements, one thread each
  const long long tail = nvec * 4 + static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tail < n) {
    float pv = p[tail], mv = mu[tail], vv = nu[tail];
    update(pv, mv, vv, g[tail], bc1, bc2, h);
    p[tail] = pv;
    mu[tail] = mv;
    nu[tail] = vv;
  }
}

}  // namespace

extern "C" {

// All pointers are fp32 device memory, 16-byte aligned; bc holds [1 - b1^t, 1 - b2^t].
// Returns a cudaError_t (0 = launched).
int fused_adamw(void* p, void* mu, void* nu, const void* g, const void* bc, long long n,
                float one_minus_b1, float b1, float one_minus_b2, float b2, float eps,
                float eps_root, float weight_decay, float neg_lr, void* stream) {
  if (n <= 0) return n == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  const long long nvec = n / 4;
  long long blocks = (nvec + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;  // a leaf under 4 elements: the tail alone
  const Hyper h{one_minus_b1, b1, one_minus_b2, b2, eps, eps_root, weight_decay, neg_lr};
  adamw_kernel<<<static_cast<int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<float*>(mu), static_cast<float*>(nu),
      static_cast<const float*>(g), static_cast<const float*>(bc), n, h);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_adamw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

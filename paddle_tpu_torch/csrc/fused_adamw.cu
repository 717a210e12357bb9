// Fused AdamW step over flat f32 vectors for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces: paddle_tpu/ops/pallas/fused_adamw.py:_adamw_kernel (launched by
// fused_adamw_flat), the Pallas TPU kernel of the AdamW A/B harness
// (tools/bench_adamw.py).
//
// What it computes. For every element i < n of w, m, v, g (f32):
//   m' = b1 m + (1 - b1) g
//   v' = b2 v + (1 - b2) g g
//   w' = w - lr ((m' / bc1) / (sqrt(v' / bc2) + eps) + wd w)
// with lr, bc1 = 1 - b1^t and bc2 = 1 - b2^t read from three 0-dim f32
// device tensors (the TPU kernel read them from SMEM), so a step never
// waits on the host. Every operation is one IEEE round-to-nearest f32
// operation in that order (__fmul_rn and friends, which the compiler never
// contracts into FMAs), so the kernel gives the plain PyTorch version's
// bits, and the tolerance on the update w - w' can be tight. Do not build
// this file with --use_fast_math.
//
// What bounds it. 4 loads and 3 stores of 4 bytes per element and ~15
// flops: 28 n bytes over 3.35 TB/s on the H100, far below the compute
// line.
//
// Design (first, simple version). A grid-stride loop over float4 groups,
// each thread loading 16 bytes of each input per iteration, with a scalar
// loop for the n % 4 tail (and for every element when a pointer is not
// 16-byte aligned). Enough 256-thread blocks to fill every SM. The TPU's
// (rows, 1024) tiling and its pad to 8 x 1024 elements have no counterpart:
// any n is taken as it is.
//
// Interface: a plain C function returning cudaError_t, bound with ctypes.
// The caller allocates the outputs and passes PyTorch's current stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;  // 2048 resident threads per SM

struct Consts {
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd;
};

__device__ __forceinline__ void adamw(float w, float m, float v, float g,
                                      float lr, float bc1, float bc2,
                                      const Consts& c, float& wo, float& mo,
                                      float& vo) {
  mo = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.one_minus_b1, g));
  vo = __fadd_rn(__fmul_rn(c.b2, v),
                 __fmul_rn(__fmul_rn(c.one_minus_b2, g), g));
  const float u = __fdiv_rn(
      __fdiv_rn(mo, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(vo, bc2)), c.eps));
  wo = __fsub_rn(w, __fmul_rn(lr, __fadd_rn(u, __fmul_rn(c.wd, w))));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    fused_adamw_kernel(const float* __restrict__ w, const float* __restrict__ m,
                       const float* __restrict__ v, const float* __restrict__ g,
                       const float* __restrict__ lr_p,
                       const float* __restrict__ bc1_p,
                       const float* __restrict__ bc2_p, float* __restrict__ wo,
                       float* __restrict__ mo, float* __restrict__ vo,
                       int64_t n, Consts c) {
  const float lr = __ldg(lr_p);
  const float bc1 = __ldg(bc1_p);
  const float bc2 = __ldg(bc2_p);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  int64_t done = 0;
  if (kVec) {
    const int64_t n4 = n / 4;
    const float4* w4 = reinterpret_cast<const float4*>(w);
    const float4* m4 = reinterpret_cast<const float4*>(m);
    const float4* v4 = reinterpret_cast<const float4*>(v);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* wo4 = reinterpret_cast<float4*>(wo);
    float4* mo4 = reinterpret_cast<float4*>(mo);
    float4* vo4 = reinterpret_cast<float4*>(vo);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 a = w4[i], b = m4[i], d = v4[i], e = g4[i];
      float4 x, y, z;
      adamw(a.x, b.x, d.x, e.x, lr, bc1, bc2, c, x.x, y.x, z.x);
      adamw(a.y, b.y, d.y, e.y, lr, bc1, bc2, c, x.y, y.y, z.y);
      adamw(a.z, b.z, d.z, e.z, lr, bc1, bc2, c, x.z, y.z, z.z);
      adamw(a.w, b.w, d.w, e.w, lr, bc1, bc2, c, x.w, y.w, z.w);
      wo4[i] = x;
      mo4[i] = y;
      vo4[i] = z;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    adamw(w[i], m[i], v[i], g[i], lr, bc1, bc2, c, wo[i], mo[i], vo[i]);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" int fused_adamw_launch(const void* w, const void* m, const void* v,
                                  const void* g, const void* lr,
                                  const void* bc1, const void* bc2,
                                  void* w_out, void* m_out, void* v_out,
                                  long long n, float beta1, float beta2,
                                  float eps, float weight_decay,
                                  void* stream) {
  if (n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  // 1 - beta in f32, as the reference's (1.0 - jnp.float32(beta))
  const Consts c{beta1, 1.0f - beta1, beta2, 1.0f - beta2, eps, weight_decay};
  const bool vec = aligned16(w) && aligned16(m) && aligned16(v) &&
                   aligned16(g) && aligned16(w_out) && aligned16(m_out) &&
                   aligned16(v_out);
  const long long units = vec ? (n + 3) / 4 : n;
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > static_cast<long long>(sms) * kBlocksPerSM) {
    blocks = static_cast<long long>(sms) * kBlocksPerSM;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* args[7] = {
      static_cast<const float*>(w),   static_cast<const float*>(m),
      static_cast<const float*>(v),   static_cast<const float*>(g),
      static_cast<const float*>(lr),  static_cast<const float*>(bc1),
      static_cast<const float*>(bc2)};
  if (vec) {
    fused_adamw_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        args[0], args[1], args[2], args[3], args[4], args[5], args[6],
        static_cast<float*>(w_out), static_cast<float*>(m_out),
        static_cast<float*>(v_out), static_cast<int64_t>(n), c);
  } else {
    fused_adamw_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                                s>>>(
        args[0], args[1], args[2], args[3], args[4], args[5], args[6],
        static_cast<float*>(w_out), static_cast<float*>(m_out),
        static_cast<float*>(v_out), static_cast<int64_t>(n), c);
  }
  return static_cast<int>(cudaGetLastError());
}

// Deterministic embedding backward for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces no Pallas kernel: on the TPU the JAX package's embedding
// gradient is XLA's scatter-add, which is deterministic there. On the card
// PyTorch's embedding backward accumulates with atomics, so two backwards
// of one state can differ in the last bits; this kernel is the port's
// backward of nn.functional.embedding while FLAGS_cudnn_deterministic is
// True (the default).
//
// What it computes. Given the ids sorted stably (sorted[i], with order[i]
// the position each came from) and the output gradient g [N, H], for every
// distinct id r:
//   grad_w[r, :] = sum over the positions p with ids[p] == r, in ascending
//                  p, of g[p, :]
// accumulated in f32 and rounded once to grad_w's dtype (f32, bf16 or
// f16, that of g). Rows no id names are left as the caller wrote them
// (zeros). The order of the sum is fixed by the data alone, so every run
// gives the same bits, and the plain version (an in-order index_add_ into
// f32 on the CPU) gives them too.
//
// What bounds it. The caller's zero fill writes V x H elements and the
// kernel reads N x H and writes the touched rows: memory-bound.
//
// Design (first, simple version). One block per position of the sorted
// ids; a block whose id equals its predecessor's returns at once, so each
// distinct id is summed by exactly one block: the head of its run. The
// block's threads stride over the H columns, each summing 8 of them
// together while it walks the run in order, with 8 rows' loads in flight
// before their adds: a hot id (a Zipf head, ~9% of the ids at s 1.1) is
// summed by one block, so its run's length in memory latencies is what
// the kernel costs, and it pays one latency per 8 rows. A run's end is
// found by a binary search over the sorted ids.
//
// Interface: a plain C function returning cudaError_t, bound with ctypes.
// The caller passes PyTorch's current stream (capturable in a CUDA graph).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 8;    // columns a thread sums together
constexpr int kUnroll = 8;  // rows of a run whose loads are in flight together

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    embedding_grad_kernel(const int64_t* __restrict__ sorted,
                          const int64_t* __restrict__ order,
                          const T* __restrict__ g, T* __restrict__ out,
                          int64_t n, int64_t h) {
  const int64_t i = blockIdx.x;
  const int64_t row = sorted[i];
  if (i > 0 && sorted[i - 1] == row) return;  // not the head of its run
  // the run's end: the first id past row (a binary search, not a walk
  // of dependent loads along a hot id's run)
  int64_t end = i + 1, hi = n;
  while (end < hi) {
    const int64_t mid = end + (hi - end) / 2;
    if (sorted[mid] == row) {
      end = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int64_t stride = blockDim.x;
  for (int64_t base = threadIdx.x; base < h; base += stride * kCols) {
    float acc[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[k] = 0.0f;
    int64_t j = i;
    // kUnroll rows x kCols columns of loads in flight, then their adds,
    // each column's in the rows' order: the plain loop's sum, bit for bit
    for (; j + kUnroll <= end; j += kUnroll) {
      float v[kUnroll][kCols];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T* src = g + order[j + u] * h;
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const int64_t c = base + k * stride;
          v[u][k] = c < h ? to_f32(src[c]) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < kCols; ++k) acc[k] = __fadd_rn(acc[k], v[u][k]);
      }
    }
    for (; j < end; ++j) {
      const T* src = g + order[j] * h;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int64_t c = base + k * stride;
        if (c < h) acc[k] = __fadd_rn(acc[k], to_f32(src[c]));
      }
    }
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int64_t c = base + k * stride;
      if (c < h) out[row * h + c] = from_f32<T>(acc[k]);
    }
  }
}

template <typename T>
int launch(const void* sorted, const void* order, const void* g, void* out,
           int64_t n, int64_t h, cudaStream_t stream) {
  if (n == 0) return 0;
  embedding_grad_kernel<T><<<static_cast<unsigned>(n), kThreads, 0, stream>>>(
      static_cast<const int64_t*>(sorted), static_cast<const int64_t*>(order),
      static_cast<const T*>(g), static_cast<T*>(out), n, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 f16. Returns a cudaError_t (0 on success).
extern "C" int embedding_grad_launch(const void* sorted, const void* order,
                                     const void* g, void* out, int64_t n,
                                     int64_t h, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(sorted, order, g, out, n, h, s);
    case 1:
      return launch<__nv_bfloat16>(sorted, order, g, out, n, h, s);
    case 2:
      return launch<__half>(sorted, order, g, out, n, h, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

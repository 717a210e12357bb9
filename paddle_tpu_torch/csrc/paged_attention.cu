// Ragged paged attention for NVIDIA Hopper (sm_90a), CUDA C++.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py:_paged_attn_kernel
// (launched by _paged_attention_pallas), the Pallas TPU kernel behind
// ragged_paged_attention.
//
// What it computes. Each query row t (a decode token or one token of a
// prompt chunk) takes the query heads of one kv head h -- the GQA group
// q[t, h*groups : (h+1)*groups, :] -- and attends over the KV pages its
// block table names, block_tables[t, j] for j < ceil(row_lens[t] /
// page_size). Keys at positions >= row_lens[t] get weight 0 (the
// reference masks their scores to -1e30). Softmax is online across pages
// in f32: running max m, running sum l (floored at 1e-30 at the end) and
// the f32 accumulator. int8 pages are widened in shared memory by their
// per-slot f32 scales, so a full-width page never exists in device memory.
// Page 0 is the pool's null page; padding rows point there.
//
// What bounds it. Decode reads every live KV page of its row once and does
// 4 flops per key element: it is bound by the bytes of the KV pages it
// reads (the page bytes over 3.35 TB/s on the H100). Chunk rows of long
// prompts do enough flops per page byte for f32 compute to matter.
//
// Design (first, simple version). One thread block per (row t, kv head h),
// a grid of (T, nkv), 128 threads. The block holds its head group's
// queries in shared memory as f32 and walks its row's pages a tile at a
// time (up to 64 keys: several whole pages), staging each tile's K and V
// slice for head h in shared memory as f32 with 16-byte vector loads.
// Scores take one warp per (query head, key) pair; the softmax update one
// warp per query head; the P.V product one thread per output element.
// There is no tensor-core use and no copy/compute overlap, and a slot's
// pages are re-read once per chunk row, as the TPU grid (T, nkv, pages)
// also did. Tiling a slot's chunk rows into one block (so a page is read
// once per chunk) and wgmma/TMA pipelining are later work.
//
// Interface: a plain C function returning cudaError_t, bound with ctypes.
// The caller allocates the output and passes PyTorch's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileKeys = 64;
constexpr float kNegInf = -1e30f;

// dtype codes shared with paddle_tpu_torch/ops/paged_attention.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kI8 = 2;

// eight consecutive elements (8-element aligned) widened to f32
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    o[2 * k] = f.x;
    o[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int k = 0; k < 8; ++k) o[k] = static_cast<float>(c[k]);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename QT, typename KVT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q,
                       const KVT* __restrict__ k_pool,
                       const KVT* __restrict__ v_pool,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ row_lens,
                       QT* __restrict__ out,
                       int nh, int nkv, int hd, int page_size,
                       int pages_per_seq, int tile_pages, float scale) {
  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int groups = nh / nkv;
  const int tile = tile_pages * page_size;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;                  // [groups, hd]
  float* acc_s = q_s + groups * hd;   // [groups, hd]
  float* k_s = acc_s + groups * hd;   // [tile, hd]
  float* v_s = k_s + tile * hd;       // [tile, hd]
  float* p_s = v_s + tile * hd;       // [groups, tile] scores, then weights
  float* m_s = p_s + groups * tile;   // [groups] running max
  float* l_s = m_s + groups;          // [groups] running sum
  float* a_s = l_s + groups;          // [groups] this tile's rescale

  const int row_len = row_lens[t];
  int n_pages = row_len > 0 ? (row_len + page_size - 1) / page_size : 0;
  if (n_pages > pages_per_seq) n_pages = pages_per_seq;
  const int kv_len = min(row_len, n_pages * page_size);
  const int* bt = block_tables + static_cast<size_t>(t) * pages_per_seq;

  const int gsize = groups * hd;
  const QT* qg = q + (static_cast<size_t>(t) * nh +
                      static_cast<size_t>(h) * groups) * hd;
  for (int e = tid; e < gsize / 8; e += kThreads) {
    float f[8];
    load8(qg + e * 8, f);
#pragma unroll
    for (int k = 0; k < 8; ++k) q_s[e * 8 + k] = f[k];
  }
  for (int e = tid; e < gsize; e += kThreads) acc_s[e] = 0.f;
  for (int g = tid; g < groups; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const size_t slot_stride = static_cast<size_t>(nkv) * hd;
  const size_t page_stride = static_cast<size_t>(page_size) * slot_stride;
  const int hvec = hd / 8;

  for (int j0 = 0; j0 < n_pages; j0 += tile_pages) {
    // the previous tile's P.V (and the prologue) must finish before the
    // tile buffers are overwritten
    __syncthreads();
    const int n_valid = min(tile, kv_len - j0 * page_size);

    // stage K and V of this tile's valid keys, widened (and dequantised)
    for (int e = tid; e < n_valid * hvec; e += kThreads) {
      const int kk = e / hvec;
      const int d8 = (e - kk * hvec) * 8;
      const int page = bt[j0 + kk / page_size];
      const int slot = kk % page_size;
      const size_t off = static_cast<size_t>(page) * page_stride +
                         static_cast<size_t>(slot) * slot_stride +
                         static_cast<size_t>(h) * hd + d8;
      float fk[8], fv[8];
      load8(k_pool + off, fk);
      load8(v_pool + off, fv);
      if (k_scale != nullptr) {
        const size_t so =
            (static_cast<size_t>(page) * page_size + slot) * nkv + h;
        const float ks = k_scale[so];
        const float vs = v_scale[so];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          fk[k] *= ks;
          fv[k] *= vs;
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        k_s[kk * hd + d8 + k] = fk[k];
        v_s[kk * hd + d8 + k] = fv[k];
      }
    }
    __syncthreads();

    // scores: a warp per (query head, key), lanes split the head dim
    for (int pr = warp; pr < groups * n_valid; pr += kWarps) {
      const int g = pr / n_valid;
      const int kk = pr - g * n_valid;
      float s = 0.f;
      for (int d = lane; d < hd; d += 32) s += q_s[g * hd + d] * k_s[kk * hd + d];
      s = warp_sum(s);
      if (lane == 0) p_s[g * tile + kk] = s * scale;
    }
    __syncthreads();

    // online softmax update: a warp per query head
    for (int g = warp; g < groups; g += kWarps) {
      float* pg = p_s + g * tile;
      float mx = kNegInf;
      for (int kk = lane; kk < n_valid; kk += 32) mx = fmaxf(mx, pg[kk]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int kk = lane; kk < n_valid; kk += 32) {
        const float p = expf(pg[kk] - m_new);
        pg[kk] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P.V, a thread per output element
    for (int e = tid; e < gsize; e += kThreads) {
      const int g = e / hd;
      const int d = e - g * hd;
      const float* pg = p_s + g * tile;
      float a = acc_s[e] * a_s[g];
      for (int kk = 0; kk < n_valid; ++kk) a += pg[kk] * v_s[kk * hd + d];
      acc_s[e] = a;
    }
  }
  __syncthreads();

  QT* og = out + (static_cast<size_t>(t) * nh +
                  static_cast<size_t>(h) * groups) * hd;
  for (int e = tid; e < gsize; e += kThreads) {
    const float l = fmaxf(l_s[e / hd], 1e-30f);
    store1(og + e, acc_s[e] / l);
  }
}

template <typename QT, typename KVT>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* block_tables, const void* row_lens, void* out,
                   int T, int nh, int nkv, int hd, int page_size,
                   int pages_per_seq, float scale, cudaStream_t stream) {
  const int groups = nh / nkv;
  int tile_pages = kTileKeys / page_size;
  if (tile_pages < 1) tile_pages = 1;
  const int tile = tile_pages * page_size;
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(groups) * hd +
                       2 * static_cast<size_t>(tile) * hd +
                       static_cast<size_t>(groups) * tile + 3 * groups);
  auto kernel = paged_attention_kernel<QT, KVT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(T, nkv);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int*>(block_tables),
      static_cast<const int*>(row_lens), static_cast<QT*>(out), nh, nkv, hd,
      page_size, pages_per_seq, tile_pages, scale);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, const void* q, const void* k_pool,
                        const void* v_pool, const void* k_scale,
                        const void* v_scale, const void* block_tables,
                        const void* row_lens, void* out, int T, int nh,
                        int nkv, int hd, int page_size, int pages_per_seq,
                        float scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32:
      return launch<QT, float>(q, k_pool, v_pool, k_scale, v_scale,
                               block_tables, row_lens, out, T, nh, nkv, hd,
                               page_size, pages_per_seq, scale, stream);
    case kBF16:
      return launch<QT, __nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale,
                                       block_tables, row_lens, out, T, nh,
                                       nkv, hd, page_size, pages_per_seq,
                                       scale, stream);
    case kI8:
      return launch<QT, int8_t>(q, k_pool, v_pool, k_scale, v_scale,
                                block_tables, row_lens, out, T, nh, nkv, hd,
                                page_size, pages_per_seq, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// out[T, nh, hd] (q's dtype) = ragged paged attention of q[T, nh, hd] over
// k_pool/v_pool[num_pages, page_size, nkv, hd]; block_tables[T,
// pages_per_seq] and row_lens[T] are int32; k_scale/v_scale are f32
// [num_pages, page_size, nkv] or both null. All arrays contiguous on the
// current device. Returns the launch's cudaError_t.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* row_lens, void* out, int T, int nh, int nkv, int hd,
    int page_size, int pages_per_seq, float scale, int q_dtype, int kv_dtype,
    void* stream) {
  if (T <= 0 || nkv <= 0 || nh % nkv != 0 || nh / nkv > 16 || hd % 8 != 0 ||
      hd > 256 || page_size < 1 || page_size > 64 || pages_per_seq < 1 ||
      (k_scale == nullptr) != (v_scale == nullptr) ||
      (kv_dtype == kI8 && k_scale == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (q_dtype) {
    case kF32:
      err = dispatch_kv<float>(kv_dtype, q, k_pool, v_pool, k_scale, v_scale,
                               block_tables, row_lens, out, T, nh, nkv, hd,
                               page_size, pages_per_seq, scale, s);
      break;
    case kBF16:
      err = dispatch_kv<__nv_bfloat16>(kv_dtype, q, k_pool, v_pool, k_scale,
                                       v_scale, block_tables, row_lens, out,
                                       T, nh, nkv, hd, page_size,
                                       pages_per_seq, scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Flash attention for NVIDIA Hopper (sm_90a), CUDA C++: forward (K1),
// dQ (K2) and dK/dV (K3).
//
// Replaces, in paddle_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_kernel -> _attn_kernel (launched by _flash_fwd_bhsd)
//   flash_dq_kernel  -> _dq_kernel   (launched by _flash_bwd_bhsd)
//   flash_dkv_kernel -> _dkv_kernel  (launched by _flash_bwd_bhsd)
//
// What they compute, per (batch b, head h) with bh = b*H + h, over
// q/k/v [B, S, H, D] read through their strides (the head dim contiguous):
//   s = scale * q.k, masked (keys past Sk; the key-padding keep mask
//   kpad[b, key] > 0.5 when given; causal bottom-right: q_row + Sk - Sq >=
//   key) to -1e30, p = softmax over the keys, O = p.v, LSE = m + log l.
//   K1 keeps (m, l, acc) online over 64-key tiles; a row with no key gives
//   O = 0 and LSE ~ -1e30. K2: dQ = scale * sum_k dS.K with p rebuilt from
//   (q, k, LSE), dS = p * (dP - Delta), dP = dO.V^T. K3: dV = sum_q
//   p_eff^T.dO and dK = scale * sum_q dS^T.Q. Delta = rowsum(dO * O) comes
//   from the caller. Dropout: keep bits from keep_bit(), a hash of the
//   global (seed, bh, row, col), identical in all three kernels and in
//   the plain version; kept p is divided by (1 - p_drop); the softmax
//   denominator l uses the undropped p.
//
// Rounding (bf16 inputs), as the Pallas kernels do: q.k, dO.v and every
// accumulator are f32; K1 rounds p (dropped, rescaled) to bf16 before
// P.V; K2 rounds dS to bf16 before dS.K; K3 rounds p_eff and dS to bf16
// before p_eff^T.dO and dS^T.Q.
//
// What bounds them on this card. At GPT-3 1.3B's shape (B 8, H 16, S
// 1024, D 128, causal, bf16) the forward moves ~134 MB (0.040 ms at 3.35
// TB/s) and does ~3.4e10 flops (0.035 ms on bf16 tensor cores), the
// backward ~8.6e10 flops: at the card's roofline they would be balanced
// between bytes and tensor-core operations. These kernels use no tensor
// cores: f32 FMAs on CUDA cores (67 TFLOP/s peak) fed from shared memory,
// so they are bound by the CUDA cores' FMA rate and shared-memory
// bandwidth, far above the roofline bound. That is the simple first
// design; mma/wgmma tiles and TMA loads are later work.
//
// Design (first, simple version). One block of 256 threads per (bh, 64-row
// tile): a q tile for K1 and K2, a k tile for K3, so a block owns its whole
// loop over the other side's 64-row tiles (the TPU grid's sequential axis
// and VMEM carries become that loop and registers). Tiles are staged in
// shared memory as f32, rows padded to D + 1 floats so that the 16 threads
// that share a row group read 16 different banks. Each thread owns a 4 x 4
// block of the 64 x 64 score tile (rows ty + 16 i, cols tx + 16 j) and a
// 4 x D/16 block of the 64 x D accumulators; row maxima and sums are
// reduced across the 16 lanes of a half-warp. Causal tiles entirely above
// the diagonal are skipped. K1 launches its heaviest (last) q tiles first.
//
// Interface: plain C functions returning cudaError_t, bound with ctypes.
// The caller allocates every output and passes PyTorch's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // rows of a q or k tile
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kLdp = kTile + 1; // row stride of a 64 x 64 tile in smem
constexpr float kNegInf = -1e30f;

// dtype codes shared with paddle_tpu_torch/ops/flash_attention.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

struct Strides {
  long long b, s, h;  // in elements; the head dim has stride 1
};

struct Layout {
  Strides t[4];  // K1: q, k, v, o;  K2/K3: q, k, v, dO
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T (identity for f32), as the Pallas kernels' astype
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// The JAX package's _keep_mask: xorshift-multiply rounds on int32 with
// wrap-around multiplies (done in uint32, where C++ defines them) and
// arithmetic right shifts (nvcc's >> on a negative int32).
__device__ __forceinline__ bool keep_bit(int seed, int bh, int row, int col,
                                         float drop_p) {
  const uint32_t a = static_cast<uint32_t>(row) * 0x9E3779B9u;
  const uint32_t b = static_cast<uint32_t>(col) * 0x85EBCA6Bu;
  const uint32_t c =
      static_cast<uint32_t>(seed) + static_cast<uint32_t>(bh) * 0x27D4EB2Fu;
  int32_t x = static_cast<int32_t>(a ^ b ^ c);
  x ^= x >> 15;
  x = static_cast<int32_t>(static_cast<uint32_t>(x) * 0x86143593u);
  x ^= x >> 13;
  x = static_cast<int32_t>(static_cast<uint32_t>(x) * 0xC2B2AE35u);
  x ^= x >> 16;
  const float u = static_cast<float>(x & 0xFFFFFF) / 16777216.0f;
  return u >= drop_p;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows r0 .. r0+63 of one (b, h) slice into dst[64][D+1] as f32, rows at
// or past n_rows as zeros (so masked keys never multiply garbage)
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss,
                                      int r0, int n_rows) {
  constexpr int LD = D + 1;
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const int gr = r0 + r;
    dst[r * LD + d] =
        gr < n_rows ? to_f(src[static_cast<long long>(gr) * ss + d]) : 0.f;
  }
}

// key validity of keys k0 .. k0+63 of batch b: inside Sk and kept by kpad
__device__ __forceinline__ void stage_keys(float* kp_s, const float* kpad,
                                           int b, int k0, int Sk) {
  if (threadIdx.x < kTile) {
    const int c = k0 + threadIdx.x;
    bool ok = c < Sk;
    if (ok && kpad != nullptr)
      ok = kpad[static_cast<long long>(b) * Sk + c] > 0.5f;
    kp_s[threadIdx.x] = ok ? 1.f : 0.f;
  }
}

// number of 64-key tiles a q tile starting at q0 needs
__device__ __forceinline__ int k_tiles_for(int q0, int Sq, int Sk,
                                           int causal) {
  int k_end = Sk;
  if (causal) k_end = min(Sk, q0 + kTile + (Sk - Sq));  // keys <= last row
  return k_end > 0 ? (k_end + kTile - 1) / kTile : 0;
}

// first 64-row q tile that reaches keys k0.. under the causal mask
__device__ __forceinline__ int first_q_tile(int k0, int Sq, int Sk,
                                            int causal) {
  if (!causal) return 0;
  const int lo = k0 - (Sk - Sq) - (kTile - 1);  // least needed tile start
  return lo <= 0 ? 0 : (lo + kTile - 1) / kTile;
}

// ───────────────────────────── K1: forward ─────────────────────────────

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ kpad,
                 T* __restrict__ o, float* __restrict__ lse, Layout lay,
                 int H, int Sq, int Sk, float scale, int causal, float drop_p,
                 float inv_keep, int seed) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [64][LD]
  float* k_s = q_s + kTile * LD;      // [64][LD]
  float* v_s = k_s + kTile * LD;      // [64][LD]
  float* p_s = v_s + kTile * LD;      // [64][kLdp]
  float* kp_s = p_s + kTile * kLdp;   // [64]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // heaviest first
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int offset = Sk - Sq;

  const Strides sq = lay.t[0], sk = lay.t[1], sv = lay.t[2], so = lay.t[3];
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  stage<T, D>(q_s, q + b * sq.b + h * sq.h, sq.s, q0, Sq);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = k_tiles_for(q0, Sq, Sk, causal);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's P.V is done with k_s/v_s/p_s
    stage<T, D>(k_s, kb, sk.s, k0, Sk);
    stage<T, D>(v_s, vb, sv.s, k0, Sk);
    stage_keys(kp_s, kpad, b, k0, Sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = q_s[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = k_s[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      unsigned ok = 0;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const bool valid =
            kp_s[tx + 16 * j] > 0.5f && (!causal || r + offset >= c);
        ok |= valid ? (1u << j) : 0u;
        s[i][j] = valid ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = (ok >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        if (drop_p > 0.f)
          p = keep_bit(seed, bh, r, k0 + tx + 16 * j, drop_p) ? p / inv_keep
                                                              : 0.f;
        p_s[(ty + 16 * i) * kLdp + tx + 16 * j] = round_to<T>(p);
      }
      sum = half_warp_sum(sum);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = p_s[(ty + 16 * i) * kLdp + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = v_s[kk * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pa[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float lf = fmaxf(l[i], 1e-30f);
    T* orow = o + b * so.b + h * so.h + static_cast<long long>(r) * so.s;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] / lf);
    if (tx == 0) lse[static_cast<long long>(bh) * Sq + r] = m[i] + logf(lf);
  }
}

// ───────────────────────────── K2: dQ ─────────────────────────────

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ kpad, T* __restrict__ dq,
                Layout lay, int H, int Sq, int Sk, float scale, int causal,
                float drop_p, float inv_keep, int seed) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [64][LD]
  float* do_s = q_s + kTile * LD;     // [64][LD]
  float* k_s = do_s + kTile * LD;     // [64][LD]
  float* v_s = k_s + kTile * LD;      // [64][LD]
  float* ds_s = v_s + kTile * LD;     // [64][kLdp]
  float* kp_s = ds_s + kTile * kLdp;  // [64]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int offset = Sk - Sq;

  const Strides sq = lay.t[0], sk = lay.t[1], sv = lay.t[2], sd = lay.t[3];
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  stage<T, D>(q_s, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
  stage<T, D>(do_s, dout + b * sd.b + h * sd.h, sd.s, q0, Sq);

  float lse_r[4], dl_r[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    const long long idx = static_cast<long long>(bh) * Sq + r;
    lse_r[i] = r < Sq ? lse[idx] : 0.f;
    dl_r[i] = r < Sq ? delta[idx] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = k_tiles_for(q0, Sq, Sk, causal);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    stage<T, D>(k_s, kb, sk.s, k0, Sk);
    stage<T, D>(v_s, vb, sv.s, k0, Sk);
    stage_keys(kp_s, kpad, b, k0, Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qa[4], da[4], ka[4], va[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = q_s[(ty + 16 * i) * LD + d];
        da[i] = do_s[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ka[j] = k_s[(tx + 16 * j) * LD + d];
        va[j] = v_s[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
          dp[i][j] = fmaf(da[i], va[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const bool valid =
            kp_s[tx + 16 * j] > 0.5f && (!causal || r + offset >= c);
        const float p = valid ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        float g = dp[i][j];
        if (drop_p > 0.f)
          g = keep_bit(seed, bh, r, c, drop_p) ? g / inv_keep : 0.f;
        ds_s[(ty + 16 * i) * kLdp + tx + 16 * j] =
            round_to<T>(p * (g - dl_r[i]));
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = ds_s[(ty + 16 * i) * kLdp + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = k_s[kk * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(da[i], kv, acc[i][j]);
      }
    }
  }

  // dq is contiguous [B, Sq, H, D]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    T* row = dq + ((static_cast<long long>(b) * Sq + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) row[tx + 16 * j] = from_f<T>(acc[i][j] * scale);
  }
}

// ───────────────────────────── K3: dK, dV ─────────────────────────────

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ kpad, T* __restrict__ dk,
                 T* __restrict__ dv, Layout lay, int H, int Sq, int Sk,
                 float scale, int causal, float drop_p, float inv_keep,
                 int seed) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                  // [64][LD] this block's keys
  float* v_s = k_s + kTile * LD;      // [64][LD]
  float* q_s = v_s + kTile * LD;      // [64][LD] the current q tile
  float* do_s = q_s + kTile * LD;     // [64][LD]
  float* p_s = do_s + kTile * LD;     // [64 keys][kLdp] p_eff^T
  float* ds_s = p_s + kTile * kLdp;   // [64 keys][kLdp] dS^T
  float* kp_s = ds_s + kTile * kLdp;  // [64]
  float* lse_s = kp_s + kTile;        // [64]
  float* dl_s = lse_s + kTile;        // [64]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int k0 = blockIdx.y * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int offset = Sk - Sq;

  const Strides sq = lay.t[0], sk = lay.t[1], sv = lay.t[2], sd = lay.t[3];
  const T* qb = q + b * sq.b + h * sq.h;
  const T* db = dout + b * sd.b + h * sd.h;
  stage<T, D>(k_s, k + b * sk.b + h * sk.h, sk.s, k0, Sk);
  stage<T, D>(v_s, v + b * sv.b + h * sv.h, sv.s, k0, Sk);
  stage_keys(kp_s, kpad, b, k0, Sk);

  float adk[4][NJ], adv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  const int n_q = (Sq + kTile - 1) / kTile;
  for (int t = first_q_tile(k0, Sq, Sk, causal); t < n_q; ++t) {
    const int q0 = t * kTile;
    __syncthreads();
    stage<T, D>(q_s, qb, sq.s, q0, Sq);
    stage<T, D>(do_s, db, sd.s, q0, Sq);
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      const long long idx = static_cast<long long>(bh) * Sq + r;
      lse_s[threadIdx.x] = r < Sq ? lse[idx] : 0.f;
      dl_s[threadIdx.x] = r < Sq ? delta[idx] : 0.f;
    }
    __syncthreads();

    // transposed tiles: rows are this block's keys (ty + 16 i), columns
    // the q tile's rows (tx + 16 j)
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float ka[4], va[4], qa[4], da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ka[i] = k_s[(ty + 16 * i) * LD + d];
        va[i] = v_s[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qa[j] = q_s[(tx + 16 * j) * LD + d];
        da[j] = do_s[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(ka[i], qa[j], s[i][j]);
          dp[i][j] = fmaf(va[i], da[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = k0 + ty + 16 * i;
      const bool key_ok = kp_s[ty + 16 * i] > 0.5f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = tx + 16 * j;
        const int r = q0 + qi;
        const bool valid =
            key_ok && r < Sq && (!causal || r + offset >= c);
        const float p = valid ? expf(s[i][j] * scale - lse_s[qi]) : 0.f;
        float p_eff = p, g = dp[i][j];
        if (drop_p > 0.f) {
          const bool kept = keep_bit(seed, bh, r, c, drop_p);
          p_eff = kept ? p / inv_keep : 0.f;
          g = kept ? g / inv_keep : 0.f;
        }
        p_s[(ty + 16 * i) * kLdp + qi] = round_to<T>(p_eff);
        ds_s[(ty + 16 * i) * kLdp + qi] = round_to<T>(p * (g - dl_s[qi]));
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
      float pa[4], sa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = p_s[(ty + 16 * i) * kLdp + qq];
        sa[i] = ds_s[(ty + 16 * i) * kLdp + qq];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float dov = do_s[qq * LD + tx + 16 * j];
        const float qv = q_s[qq * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          adv[i][j] = fmaf(pa[i], dov, adv[i][j]);
          adk[i][j] = fmaf(sa[i], qv, adk[i][j]);
        }
      }
    }
  }

  // dk, dv are contiguous [B, Sk, H, D]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= Sk) continue;
    const long long off = ((static_cast<long long>(b) * Sk + c) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[off + tx + 16 * j] = from_f<T>(adk[i][j] * scale);
      dv[off + tx + 16 * j] = from_f<T>(adv[i][j]);
    }
  }
}

// ───────────────────────────── launchers ─────────────────────────────

struct Args {
  int B, H, Sq, Sk;
  float scale;
  int causal;
  float drop_p, inv_keep;
  int seed;
};

Layout make_layout(const long long* st) {
  Layout lay;
  for (int i = 0; i < 4; ++i) lay.t[i] = Strides{st[3 * i], st[3 * i + 1],
                                                 st[3 * i + 2]};
  return lay;
}

template <int D>
constexpr size_t smem_floats(int n_tiles, int n_pt, int n_vec) {
  return static_cast<size_t>(n_tiles) * kTile * (D + 1) +
         static_cast<size_t>(n_pt) * kTile * kLdp +
         static_cast<size_t>(n_vec) * kTile;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v,
                const void* kpad, void* o, void* lse, const Layout& lay,
                const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>(3, 1, 1);
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Sq + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(kpad),
      static_cast<T*>(o), static_cast<float*>(lse), lay, a.H, a.Sq, a.Sk,
      a.scale, a.causal, a.drop_p, a.inv_keep, a.seed);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* kpad,
               void* dqp, const Layout& lay, const Args& a,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>(4, 1, 1);
  auto kernel = flash_dq_kernel<T, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Sq + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(kpad), static_cast<T*>(dqp), lay, a.H, a.Sq,
      a.Sk, a.scale, a.causal, a.drop_p, a.inv_keep, a.seed);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dkv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                const void* kpad, void* dkp, void* dvp, const Layout& lay,
                const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>(4, 2, 3);
  auto kernel = flash_dkv_kernel<T, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Sk + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(kpad), static_cast<T*>(dkp),
      static_cast<T*>(dvp), lay, a.H, a.Sq, a.Sk, a.scale, a.causal,
      a.drop_p, a.inv_keep, a.seed);
  return cudaGetLastError();
}

bool bad_args(const Args& a, int D, int dtype) {
  return a.B < 1 || a.H < 1 || a.Sq < 1 || a.Sk < 1 ||
         (D != 32 && D != 64 && D != 128) || (dtype != kF32 && dtype != kBF16) ||
         (a.Sq + kTile - 1) / kTile > 65535 ||
         (a.Sk + kTile - 1) / kTile > 65535 || !(a.drop_p >= 0.f) ||
         a.drop_p >= 1.f;
}

// Returns FN<T, D>(...) for the runtime (dtype, D).
#define FLASH_DISPATCH(FN, ...)                                        \
  switch (dtype * 1000 + D) {                                          \
    case kF32 * 1000 + 32: return FN<float, 32>(__VA_ARGS__);          \
    case kF32 * 1000 + 64: return FN<float, 64>(__VA_ARGS__);          \
    case kF32 * 1000 + 128: return FN<float, 128>(__VA_ARGS__);        \
    case kBF16 * 1000 + 32: return FN<__nv_bfloat16, 32>(__VA_ARGS__); \
    case kBF16 * 1000 + 64: return FN<__nv_bfloat16, 64>(__VA_ARGS__); \
    case kBF16 * 1000 + 128:                                           \
      return FN<__nv_bfloat16, 128>(__VA_ARGS__);                      \
    default: return cudaErrorInvalidValue;                             \
  }

cudaError_t run_fwd(const void* q, const void* k, const void* v,
                    const void* kpad, void* o, void* lse, const Layout& lay,
                    const Args& a, int D, int dtype, cudaStream_t s) {
  FLASH_DISPATCH(fwd, q, k, v, kpad, o, lse, lay, a, s)
}

cudaError_t run_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   const void* kpad, void* dqp, const Layout& lay,
                   const Args& a, int D, int dtype, cudaStream_t s) {
  FLASH_DISPATCH(dq, q, k, v, dout, lse, delta, kpad, dqp, lay, a, s)
}

cudaError_t run_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    const void* kpad, void* dkp, void* dvp, const Layout& lay,
                    const Args& a, int D, int dtype, cudaStream_t s) {
  FLASH_DISPATCH(dkv, q, k, v, dout, lse, delta, kpad, dkp, dvp, lay, a, s)
}

}  // namespace

// K1. q, k, v [B, S, H, D] (strides[0..8]: batch, seq, head strides of q,
// k, v in elements), o [B, Sq, H, D] (strides[9..11]); kpad f32 [B, Sk]
// or null; lse f32 [B*H, Sq] contiguous. dtype 0 = f32, 1 = bf16; D in
// {32, 64, 128}. Returns the launch's cudaError_t.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* kpad, void* o, void* lse,
                                const void* strides, int B, int H, int Sq,
                                int Sk, int D, float scale, int causal,
                                float drop_p, float inv_keep, int seed,
                                int dtype, void* stream) {
  const Args a{B, H, Sq, Sk, scale, causal, drop_p, inv_keep, seed};
  if (bad_args(a, D, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = make_layout(static_cast<const long long*>(strides));
  return static_cast<int>(run_fwd(q, k, v, kpad, o, lse, lay, a, D, dtype,
                                  static_cast<cudaStream_t>(stream)));
}

// K2. As K1, with dO in place of o among the strides (strides[9..11]),
// lse and delta f32 [B*H, Sq] contiguous; writes dq [B, Sq, H, D]
// contiguous.
extern "C" int flash_dq_launch(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* kpad, void* dqp,
                               const void* strides, int B, int H, int Sq,
                               int Sk, int D, float scale, int causal,
                               float drop_p, float inv_keep, int seed,
                               int dtype, void* stream) {
  const Args a{B, H, Sq, Sk, scale, causal, drop_p, inv_keep, seed};
  if (bad_args(a, D, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = make_layout(static_cast<const long long*>(strides));
  return static_cast<int>(run_dq(q, k, v, dout, lse, delta, kpad, dqp, lay,
                                 a, D, dtype,
                                 static_cast<cudaStream_t>(stream)));
}

// K3. As K2; writes dk and dv [B, Sk, H, D] contiguous.
extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* kpad,
                                void* dkp, void* dvp, const void* strides,
                                int B, int H, int Sq, int Sk, int D,
                                float scale, int causal, float drop_p,
                                float inv_keep, int seed, int dtype,
                                void* stream) {
  const Args a{B, H, Sq, Sk, scale, causal, drop_p, inv_keep, seed};
  if (bad_args(a, D, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = make_layout(static_cast<const long long*>(strides));
  return static_cast<int>(run_dkv(q, k, v, dout, lse, delta, kpad, dkp, dvp,
                                  lay, a, D, dtype,
                                  static_cast<cudaStream_t>(stream)));
}

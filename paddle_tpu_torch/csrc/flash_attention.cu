// Flash attention for NVIDIA Hopper (sm_90a), CUDA C++: forward (K1),
// dQ (K2) and dK/dV (K3).
//
// Replaces, in paddle_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_kernel      -> _attn_kernel (launched by _flash_fwd_bhsd), f32
//   flash_fwd_bf16_kernel -> _attn_kernel, bf16
//   flash_dq_kernel       -> _dq_kernel   (launched by _flash_bwd_bhsd), f32
//   flash_dq_bf16_kernel  -> _dq_kernel, bf16
//   flash_dkv_kernel      -> _dkv_kernel  (launched by _flash_bwd_bhsd), f32
//   flash_dkv_bf16_kernel -> _dkv_kernel, bf16
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
//   global (seed, bh, row, col), identical in all the kernels and in the
//   plain version; kept p is divided by (1 - p_drop); the softmax
//   denominator l uses the undropped p.
//
// Rounding (bf16 inputs), as the Pallas kernels do: q.k, dO.v and every
// accumulator are f32; K1 rounds p (dropped, rescaled) to bf16 before
// P.V; K2 rounds dS to bf16 before dS.K; K3 rounds p_eff and dS to bf16
// before p_eff^T.dO and dS^T.Q.
//
// What bounds them on this card. At GPT-3 1.3B's shape (B 8, H 16, S
// 1024, D 128, causal, bf16) the forward moves ~134 MB (0.040 ms at 3.35
// TB/s) and does ~3.4e10 flops (0.035 ms on bf16 tensor cores), dQ
// ~5.2e10 flops (0.052 ms), dK/dV ~6.9e10 flops (0.070 ms): at the
// roofline the forward is bound by bytes and the backward by tensor-core
// operations. A kernel built from mma.sync tiles is bound, short of that,
// by the tensor-core issue rate of mma.sync (below wgmma's), by the
// shared-memory reads that feed the B operands (every warp reads the
// whole k/v tile in K1 and K2, the whole q/dO tile twice in K3) and by
// the exponentials of the softmax.
//
// bf16 design (K1, K2 and K3, flash_*_bf16_kernel): tensor cores for
// every product, mma.sync.m16n8k16 with bf16 operands and f32
// accumulators. A block of 4 warps owns a 64-row tile, 16 rows a warp: q
// rows in K1 and K2, keys in K3 (so keys are the M dimension of all four
// K3 products and dK/dV need no transpose or atomics; K2 owns its q rows,
// so dQ needs none either: all deterministic). Tiles are bf16 in
// shared memory with rows padded to D + 8 elements (a row stride of 16
// bytes modulo 128, so the 8 rows an ldmatrix phase reads fall in 8
// different bank groups), filled by 16-byte cp.async.cg copies
// (zero-filled past the sequence, src-size 0, so masked rows never
// multiply garbage) through a 2-stage ring: the next tile loads while the
// current one is multiplied. K1: the warp's q fragments stay in registers
// for the whole key loop; S = Q.K^T with K through ldmatrix; the online
// softmax runs on the accumulator fragments in the log2 domain (row max
// and sum over the 4 lanes of a quad, the sum reduced once at the end);
// P is packed to bf16 A fragments in registers (the m16n8 C layout is the
// m16n8k16 A layout) and O += P.V takes V through ldmatrix.trans; O goes
// out through shared memory as 16-byte stores, LSE once per row. K2 is
// K1 with K3's direct p in place of the online softmax: Q and dO tiles
// are loaded once (Q's fragments kept in registers, dO's re-read from its
// resident tile each key tile, which keeps the registers of S, dP and the
// dQ sum free of spills), LSE (times log2 e) and Delta of the lane's two
// rows sit in registers; k/v tiles stream through the ring up to the last
// causal one; S = Q.K^T and dP = dO.V^T take K and V through ldmatrix, p =
// exp2(s scale log2 e - LSE log2 e), dS = p (dP - Delta) in registers,
// packed to bf16 A fragments, and dQ += dS.K takes K through
// ldmatrix.trans; dQ leaves through the warp's rows of the Q tile. K3: K
// and V are loaded once; q tiles stream through the ring from the first
// causal one, each in two 32-row halves (which keeps dK and dV, 2 x D/2
// f32 a thread, in registers across the loop): S^T = K.Q^T and dP^T =
// V.dO^T, p and dS in registers, p_eff^T and dS^T re-packed as A
// fragments, dV += p_eff^T.dO and dK += dS^T.Q with B through
// ldmatrix.trans. Masks are applied only on tiles that need them (the
// causal diagonal, the sequence tail, key padding); a warp skips a tile
// or half that the causal mask hides from it; K1 and K2 launch their
// heaviest (last) q tiles first. The wrapper refuses bf16 inputs off
// 16-byte alignment (data pointer, batch, sequence and head strides).
//
// f32 (flash_fwd_kernel, flash_dq_kernel, flash_dkv_kernel) keeps the
// first, simple design, without tensor cores (TF32 would move f32 results
// past their 5e-5 check): f32 FMAs on CUDA cores fed from shared memory,
// one block of 256 threads per (bh, 64-row tile), tiles staged as f32
// with rows padded to D + 1 floats; each thread owns a 4 x 4 block of the
// 64 x 64 score tile and a 4 x D/16 block of the accumulators. Known
// losses: the f32 kernels run on CUDA cores; the bf16 kernels use
// mma.sync, not wgmma with TMA and warp specialisation.
//
// Interface: plain C functions returning cudaError_t, bound with ctypes.
// The caller allocates every output and passes PyTorch's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ─────────────────── bf16 on tensor cores: K1 and K3 ───────────────────

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;  // 4 warps, 16 rows of a 64-row tile each
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zero-filled when !ok
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a.b on tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col), c f32.
// Fragments, with g = lane / 4 and t = lane % 4: a {(g, 2t..2t+1), (g+8,
// 2t..), (g, 2t+8..), (g+8, 2t+8..)}; b {(k 2t..2t+1, n g), (k 2t+8..,
// n g)}; c {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments of a 16-row x 16-column chunk from the C fragments of
// its two 8-column blocks c0 (columns 0-7) and c1 (8-15), rounded to bf16
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows r0 .. r0+63 of one (b, h) slice (row stride ss elements, 16-byte
// aligned) into dst[64][D + 8] by 16-byte cp.async, rows at or past
// n_rows zero-filled. Not waited for: the caller commits and waits.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long ss, int r0, int n_rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kMmaThreads; ++i) {
    const int e = threadIdx.x + i * kMmaThreads;
    const int r = e / kChunks, c = e - (e / kChunks) * kChunks;
    const bool ok = r0 + r < n_rows;
    const bf16* g = ok ? src + static_cast<long long>(r0 + r) * ss + c * 8 : src;
    cp_async16(smem_addr(dst + r * (D + 8) + c * 8), g, ok);
  }
}

// A warp's 16 rows x D of a [64][D + 8] tile out to global memory as
// 16-byte stores: rows row0 + r < n_rows go to dst + (row0 + r) * ss
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long long ss,
                                           const bf16* src, int row0,
                                           int n_rows) {
  constexpr int kChunks = D / 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 16 * kChunks / 32; ++i) {
    const int e = lane + i * 32;
    const int r = e / kChunks, c = e - (e / kChunks) * kChunks;
    if (row0 + r < n_rows)
      *reinterpret_cast<int4*>(dst + static_cast<long long>(row0 + r) * ss +
                               c * 8) =
          *reinterpret_cast<const int4*>(src + r * (D + 8) + c * 8);
  }
}

// A warp's C fragments acc[D/8][4] (16 rows x D) as bf16 into rows
// 0..15 of dst[.][D + 8], rows 0-7 multiplied by mul0, rows 8-15 by mul1
template <int D>
__device__ __forceinline__ void frags_to_smem(bf16* dst,
                                              const float (&acc)[D / 8][4],
                                              float mul0, float mul1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(dst + g * (D + 8) + j * 8 + 2 * t4) =
        pack_bf16(acc[j][0] * mul0, acc[j][1] * mul0);
    *reinterpret_cast<uint32_t*>(dst + (g + 8) * (D + 8) + j * 8 + 2 * t4) =
        pack_bf16(acc[j][2] * mul1, acc[j][3] * mul1);
  }
}

// ── K1, bf16: one 64-key tile of a warp's 16 q rows ──
//
// s[j][2i + e] is (row row0 + g + 8 i, key k0 + 8 j + 2 t + e). kMasked:
// the tile reaches past Sk, the causal diagonal or a padded key.
template <int D, bool kMasked>
__device__ __forceinline__ void fwd_tile(
    const uint32_t (&qf)[D / 16][4], float (&acc)[D / 8][4], float (&m)[2],
    float (&l)[2], const bf16* ks, const bf16* vs, const float* kpad_b,
    int Sk, int k0, int row0, int offset, int causal, float sl2,
    float drop_p, float inv_keep, int seed, int bh) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;

  // S = Q.K^T: K rows are keys, so plain ldmatrix gives its B fragments
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) s[j][x] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4];
      ldsm_x4(smem_addr(ks + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        kk * 16 + (((lane >> 3) & 1) << 3)),
              b);
      mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
      mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
    }
  }

  // validity bits, bit 2 j + e, for rows g and g + 8
  uint32_t ok[2] = {0xffffu, 0xffffu};
  if (kMasked) {
    uint32_t kbits = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = k0 + 8 * j + 2 * t4 + e;
        const bool kv = c < Sk && (kpad_b == nullptr || kpad_b[c] > 0.5f);
        kbits |= kv ? 1u << (2 * j + e) : 0u;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ok[i] = kbits;
      if (causal) {
        const int r = row0 + g + 8 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (r + offset < k0 + 8 * j + 2 * t4 + e)
              ok[i] &= ~(1u << (2 * j + e));
      }
    }
  }

  // online softmax in the log2 domain: x = s * scale * log2(e)
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = x >> 1, bit = 2 * j + (x & 1);
      float y = s[j][x] * sl2;
      if (kMasked && !((ok[i] >> bit) & 1u)) y = kNegInf;
      s[j][x] = y;
      mx[i] = fmaxf(mx[i], y);
    }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m[i], quad_max(mx[i]));
    alpha[i] = exp2f(m[i] - m_new);
    m[i] = m_new;
    l[i] *= alpha[i];  // this lane's part of the row sum
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = x >> 1, bit = 2 * j + (x & 1);
      float p = (!kMasked || ((ok[i] >> bit) & 1u)) ? exp2f(s[j][x] - m[i])
                                                    : 0.f;
      l[i] += p;
      if (drop_p > 0.f)
        p = keep_bit(seed, bh, row0 + g + 8 * i, k0 + 8 * j + 2 * t4 + (x & 1),
                     drop_p)
                ? p / inv_keep
                : 0.f;
      s[j][x] = p;
    }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[j][x] *= alpha[x >> 1];

  // O += P.V: P from registers, V rows are keys, so ldmatrix.trans
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t pa[4];
    pack_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
    for (int jp = 0; jp < D / 16; ++jp) {
      uint32_t b[4];
      ldsm_x4_t(smem_addr(vs + (kc * 16 + (lane & 7) +
                                (((lane >> 3) & 1) << 3)) * LD +
                          jp * 16 + ((lane >> 4) << 3)),
                b);
      mma_bf16(acc[2 * jp], pa, b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], pa, b[2], b[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const float* __restrict__ kpad, bf16* __restrict__ o,
                      float* __restrict__ lse, Layout lay, int H, int Sq,
                      int Sk, float scale, int causal, float drop_p,
                      float inv_keep, int seed) {
  constexpr int LD = D + 8;
  constexpr int kTileElems = kTile * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [64][LD], then O
  bf16* k_s = q_s + kTileElems;                   // [2][64][LD] ring
  bf16* v_s = k_s + 2 * kTileElems;               // [2][64][LD] ring

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + 16 * warp;  // this warp's first q row
  const int offset = Sk - Sq;

  const Strides sq = lay.t[0], sk = lay.t[1], sv = lay.t[2], so = lay.t[3];
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const float* kpad_b =
      kpad != nullptr ? kpad + static_cast<long long>(b) * Sk : nullptr;
  const int n_tiles = k_tiles_for(q0, Sq, Sk, causal);

  load_tile<D>(q_s, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile<D>(k_s, kb, sk.s, 0, Sk);
    load_tile<D>(v_s, vb, sv.s, 0, Sk);
  }
  cp_async_commit();
  cp_async_wait<1>();  // the q tile
  __syncthreads();

  // the warp's q fragments, in registers for the whole key loop
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(smem_addr(q_s + (16 * warp + (lane & 15)) * LD + kk * 16 +
                      ((lane >> 4) << 3)),
            qf[kk]);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[j][x] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float sl2 = scale * kLog2e;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    const int st = t & 1;
    if (t + 1 < n_tiles) {  // the next tile loads while this one computes
      load_tile<D>(k_s + (st ^ 1) * kTileElems, kb, sk.s, k0 + kTile, Sk);
      load_tile<D>(v_s + (st ^ 1) * kTileElems, vb, sv.s, k0 + kTile, Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile t
    __syncthreads();
    // a warp whose rows see no key of the tile (causal) adds nothing
    if (!causal || row0 + 15 + offset >= k0) {
      const bf16* ks = k_s + st * kTileElems;
      const bf16* vs = v_s + st * kTileElems;
      const bool masked = kpad != nullptr || k0 + kTile > Sk ||
                          (causal && row0 + offset < k0 + kTile - 1);
      if (masked)
        fwd_tile<D, true>(qf, acc, m, l, ks, vs, kpad_b, Sk, k0, row0,
                          offset, causal, sl2, drop_p, inv_keep, seed, bh);
      else
        fwd_tile<D, false>(qf, acc, m, l, ks, vs, kpad_b, Sk, k0, row0,
                           offset, causal, sl2, drop_p, inv_keep, seed, bh);
    }
    __syncthreads();  // every warp is done with stage st
  }
  cp_async_wait<0>();

  // O = acc / l through the warp's own rows of the q tile (its q
  // fragments are in registers): 16-byte stores; LSE once per row
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = quad_sum(l[i]);
  bf16* o_s = q_s + 16 * warp * LD;
  __syncwarp();
  frags_to_smem<D>(o_s, acc, 1.f / fmaxf(l[0], 1e-30f),
                   1.f / fmaxf(l[1], 1e-30f));
  __syncwarp();
  store_rows<D>(o + b * so.b + h * so.h, so.s, o_s, row0, Sq);
  if (t4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + g + 8 * i;
      // l > 0 is the row's validity bit: some key passed its masks
      if (r < Sq)
        lse[static_cast<long long>(bh) * Sq + r] =
            l[i] > 0.f ? m[i] * kLn2 + logf(l[i]) : kNegInf;
    }
  }
}

// ── K2, bf16: one 64-key tile of a warp's 16 q rows ──
//
// s[j][2i + e] and dp[j][2i + e] are (row row0 + g + 8 i, key k0 + 8 j + 2
// t + e), as in fwd_tile; lse2 and dl are rows g and g + 8's LSE * log2(e)
// and Delta. kMasked: as in fwd_tile.
template <int D, bool kMasked>
__device__ __forceinline__ void dq_tile(
    const uint32_t (&qf)[D / 16][4], float (&acc)[D / 8][4],
    const float (&lse2)[2], const float (&dl)[2], const bf16* dos,
    const bf16* ks, const bf16* vs, const float* kpad_b, int Sk, int k0,
    int row0, int offset, int causal, float sl2, float drop_p,
    float inv_keep, int seed, int bh) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;

  // S = Q.K^T and dP = dO.V^T: K and V rows are keys, so plain ldmatrix
  // gives their B fragments; dO's A fragments come from its resident tile
  float s[8][4], dp[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) s[j][x] = dp[j][x] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t da[4];
    ldsm_x4(smem_addr(dos + (lane & 15) * LD + kk * 16 + ((lane >> 4) << 3)),
            da);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      const int b_off = (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        kk * 16 + (((lane >> 3) & 1) << 3);
      uint32_t b[4];
      ldsm_x4(smem_addr(ks + b_off), b);
      mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
      mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
      ldsm_x4(smem_addr(vs + b_off), b);
      mma_bf16(dp[2 * jp], da, b[0], b[1]);
      mma_bf16(dp[2 * jp + 1], da, b[2], b[3]);
    }
  }

  // validity bits, bit 2 j + e, for rows g and g + 8 (as fwd_tile)
  uint32_t ok[2] = {0xffffu, 0xffffu};
  if (kMasked) {
    uint32_t kbits = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = k0 + 8 * j + 2 * t4 + e;
        const bool kv = c < Sk && (kpad_b == nullptr || kpad_b[c] > 0.5f);
        kbits |= kv ? 1u << (2 * j + e) : 0u;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ok[i] = kbits;
      if (causal) {
        const int r = row0 + g + 8 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (r + offset < k0 + 8 * j + 2 * t4 + e)
              ok[i] &= ~(1u << (2 * j + e));
      }
    }
  }

  // p = exp(scale s - LSE) in the log2 domain; dS = p (dP_eff - Delta),
  // in place of s
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = x >> 1, bit = 2 * j + (x & 1);
      const float p = (!kMasked || ((ok[i] >> bit) & 1u))
                          ? exp2f(s[j][x] * sl2 - lse2[i])
                          : 0.f;
      float gd = dp[j][x];
      if (drop_p > 0.f)
        gd = keep_bit(seed, bh, row0 + g + 8 * i,
                      k0 + 8 * j + 2 * t4 + (x & 1), drop_p)
                 ? gd / inv_keep
                 : 0.f;
      s[j][x] = p * (gd - dl[i]);
    }

  // dQ += dS.K: dS rounded to bf16 A fragments in registers, K rows are
  // keys (the K dimension), so ldmatrix.trans
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t sa[4];
    pack_a(sa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
    for (int jp = 0; jp < D / 16; ++jp) {
      uint32_t b[4];
      ldsm_x4_t(smem_addr(ks + (kc * 16 + (lane & 7) +
                                (((lane >> 3) & 1) << 3)) * LD +
                          jp * 16 + ((lane >> 4) << 3)),
                b);
      mma_bf16(acc[2 * jp], sa, b[0], b[1]);
      mma_bf16(acc[2 * jp + 1], sa, b[2], b[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ kpad, bf16* __restrict__ dq,
                     Layout lay, int H, int Sq, int Sk, float scale,
                     int causal, float drop_p, float inv_keep, int seed) {
  constexpr int LD = D + 8;
  constexpr int kTileElems = kTile * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [64][LD], then dQ
  bf16* do_s = q_s + kTileElems;                  // [64][LD]
  bf16* k_s = do_s + kTileElems;                  // [2][64][LD] ring
  bf16* v_s = k_s + 2 * kTileElems;               // [2][64][LD] ring

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int row0 = q0 + 16 * warp;  // this warp's first q row
  const int offset = Sk - Sq;

  const Strides sq = lay.t[0], sk = lay.t[1], sv = lay.t[2], sd = lay.t[3];
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const float* kpad_b =
      kpad != nullptr ? kpad + static_cast<long long>(b) * Sk : nullptr;
  const int n_tiles = k_tiles_for(q0, Sq, Sk, causal);

  load_tile<D>(q_s, q + b * sq.b + h * sq.h, sq.s, q0, Sq);
  load_tile<D>(do_s, dout + b * sd.b + h * sd.h, sd.s, q0, Sq);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile<D>(k_s, kb, sk.s, 0, Sk);
    load_tile<D>(v_s, vb, sv.s, 0, Sk);
  }
  cp_async_commit();

  // LSE (log2 domain) and Delta of this lane's rows g and g + 8
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    const long long idx = static_cast<long long>(bh) * Sq + r;
    lse2[i] = r < Sq ? lse[idx] * kLog2e : 0.f;
    dl[i] = r < Sq ? delta[idx] : 0.f;
  }
  cp_async_wait<1>();  // the q and dO tiles
  __syncthreads();

  // the warp's q fragments, in registers for the whole key loop
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm_x4(smem_addr(q_s + (16 * warp + (lane & 15)) * LD + kk * 16 +
                      ((lane >> 4) << 3)),
            qf[kk]);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[j][x] = 0.f;
  const float sl2 = scale * kLog2e;
  const bf16* dos = do_s + 16 * warp * LD;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    const int st = t & 1;
    if (t + 1 < n_tiles) {  // the next tile loads while this one computes
      load_tile<D>(k_s + (st ^ 1) * kTileElems, kb, sk.s, k0 + kTile, Sk);
      load_tile<D>(v_s + (st ^ 1) * kTileElems, vb, sv.s, k0 + kTile, Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile t
    __syncthreads();
    // a warp whose rows see no key of the tile (causal) adds nothing
    if (!causal || row0 + 15 + offset >= k0) {
      const bf16* ks = k_s + st * kTileElems;
      const bf16* vs = v_s + st * kTileElems;
      const bool masked = kpad != nullptr || k0 + kTile > Sk ||
                          (causal && row0 + offset < k0 + kTile - 1);
      if (masked)
        dq_tile<D, true>(qf, acc, lse2, dl, dos, ks, vs, kpad_b, Sk, k0,
                         row0, offset, causal, sl2, drop_p, inv_keep, seed,
                         bh);
      else
        dq_tile<D, false>(qf, acc, lse2, dl, dos, ks, vs, kpad_b, Sk, k0,
                          row0, offset, causal, sl2, drop_p, inv_keep, seed,
                          bh);
    }
    __syncthreads();  // every warp is done with stage st
  }
  cp_async_wait<0>();

  // dQ = scale * acc through the warp's own rows of the q tile (its q
  // fragments are in registers): 16-byte stores into contiguous [B, Sq,
  // H, D]
  bf16* dq_s = q_s + 16 * warp * LD;
  __syncwarp();
  frags_to_smem<D>(dq_s, acc, scale, scale);
  __syncwarp();
  const long long row_stride = static_cast<long long>(H) * D;
  store_rows<D>(dq + static_cast<long long>(b) * Sq * row_stride +
                    static_cast<long long>(h) * D,
                row_stride, dq_s, row0, Sq);
}

// ── K3, bf16: one 32-row half of a q tile against a warp's 16 keys ──
//
// s[j][2i + e] is (key kw0 + g + 8 i, q row q0 + c0 + 8 j + 2 t + e), c0
// = 32 * half. kMasked: the half reaches past Sq, the causal diagonal or
// a padded key.
template <int D, bool kMasked>
__device__ __forceinline__ void dkv_half(
    float (&dka)[D / 8][4], float (&dva)[D / 8][4], const bf16* ks,
    const bf16* vs, const bf16* qs, const bf16* dos, const float* ls,
    const float* dls, int c0, int q0, int kw0, int Sq, int offset,
    int causal, const bool (&kok)[2], float sl2, float drop_p,
    float inv_keep, int seed, int bh) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;

  // S^T = K.Q^T and dP^T = V.dO^T: the warp's K and V rows are the A
  // fragments, q and dO rows (plain ldmatrix) the B fragments
  float s[4][4], dp[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) s[j][x] = dp[j][x] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t ka[4], va[4];
    const int a_off = (lane & 15) * LD + kk * 16 + ((lane >> 4) << 3);
    ldsm_x4(smem_addr(ks + a_off), ka);
    ldsm_x4(smem_addr(vs + a_off), va);
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      const int b_off = (c0 + jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        kk * 16 + (((lane >> 3) & 1) << 3);
      uint32_t b[4];
      ldsm_x4(smem_addr(qs + b_off), b);
      mma_bf16(s[2 * jp], ka, b[0], b[1]);
      mma_bf16(s[2 * jp + 1], ka, b[2], b[3]);
      ldsm_x4(smem_addr(dos + b_off), b);
      mma_bf16(dp[2 * jp], va, b[0], b[1]);
      mma_bf16(dp[2 * jp + 1], va, b[2], b[3]);
    }
  }

  // p = exp(scale s - LSE) (log2 domain), p_eff, dS = p (dP_eff - Delta)
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qi = c0 + 8 * j + 2 * t4 + e;
      const float lse2 = ls[qi] * kLog2e;
      const float dl = dls[qi];
      const int r = q0 + qi;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int x = 2 * i + e;
        const int c = kw0 + g + 8 * i;
        bool valid = true;
        if (kMasked)
          valid = kok[i] && r < Sq && (!causal || r + offset >= c);
        const float p = valid ? exp2f(s[j][x] * sl2 - lse2) : 0.f;
        float p_eff = p, gd = dp[j][x];
        if (drop_p > 0.f) {
          const bool kept = keep_bit(seed, bh, r, c, drop_p);
          p_eff = kept ? p / inv_keep : 0.f;
          gd = kept ? gd / inv_keep : 0.f;
        }
        s[j][x] = p_eff;
        dp[j][x] = p * (gd - dl);
      }
    }

  // dV += p_eff^T.dO and dK += dS^T.Q: the half's q rows are the K
  // dimension, so dO and Q come through ldmatrix.trans
#pragma unroll
  for (int kc = 0; kc < 2; ++kc) {
    uint32_t pa[4], da[4];
    pack_a(pa, s[2 * kc], s[2 * kc + 1]);
    pack_a(da, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
    for (int jp = 0; jp < D / 16; ++jp) {
      const int b_off =
          (c0 + kc * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
          jp * 16 + ((lane >> 4) << 3);
      uint32_t b[4];
      ldsm_x4_t(smem_addr(dos + b_off), b);
      mma_bf16(dva[2 * jp], pa, b[0], b[1]);
      mma_bf16(dva[2 * jp + 1], pa, b[2], b[3]);
      ldsm_x4_t(smem_addr(qs + b_off), b);
      mma_bf16(dka[2 * jp], da, b[0], b[1]);
      mma_bf16(dka[2 * jp + 1], da, b[2], b[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ kpad, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, Layout lay, int H, int Sq,
                      int Sk, float scale, int causal, float drop_p,
                      float inv_keep, int seed) {
  constexpr int LD = D + 8;
  constexpr int kTileElems = kTile * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [64][LD], then dK
  bf16* v_s = k_s + kTileElems;                   // [64][LD], then dV
  bf16* q_s = v_s + kTileElems;                   // [2][64][LD] ring
  bf16* do_s = q_s + 2 * kTileElems;              // [2][64][LD] ring
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kTileElems);  // [2][64]
  float* dl_s = lse_s + 2 * kTile;                                 // [2][64]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int k0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int kw0 = k0 + 16 * warp;  // this warp's first key
  const int offset = Sk - Sq;

  const Strides sq = lay.t[0], sk = lay.t[1], sv = lay.t[2], sd = lay.t[3];
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* db = dout + b * sd.b + h * sd.h;
  const float* lse_b = lse + static_cast<long long>(bh) * Sq;
  const float* dl_b = delta + static_cast<long long>(bh) * Sq;

  // q tile t (rows, dO, LSE, Delta) into ring stage st
  auto load_q_tile = [&](int t, int st) {
    const int q0 = t * kTile;
    load_tile<D>(q_s + st * kTileElems, qb, sq.s, q0, Sq);
    load_tile<D>(do_s + st * kTileElems, db, sd.s, q0, Sq);
    const int r = threadIdx.x & (kTile - 1);
    const bool ok = q0 + r < Sq;
    if (threadIdx.x < kTile)
      cp_async4(smem_addr(lse_s + st * kTile + r), ok ? lse_b + q0 + r : lse_b,
                ok);
    else
      cp_async4(smem_addr(dl_s + st * kTile + r), ok ? dl_b + q0 + r : dl_b,
                ok);
  };

  const int t_first = first_q_tile(k0, Sq, Sk, causal);
  const int n_q = (Sq + kTile - 1) / kTile;
  load_tile<D>(k_s, k + b * sk.b + h * sk.h, sk.s, k0, Sk);
  load_tile<D>(v_s, v + b * sv.b + h * sv.h, sv.s, k0, Sk);
  if (t_first < n_q) load_q_tile(t_first, 0);
  cp_async_commit();

  // the warp's two keys of this lane (rows g, g + 8): inside Sk, kept
  bool kok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = kw0 + g + 8 * i;
    kok[i] = c < Sk &&
             (kpad == nullptr ||
              kpad[static_cast<long long>(b) * Sk + c] > 0.5f);
  }

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) dka[j][x] = dva[j][x] = 0.f;
  const float sl2 = scale * kLog2e;
  const bf16* ks = k_s + 16 * warp * LD;
  const bf16* vs = v_s + 16 * warp * LD;

  for (int t = t_first; t < n_q; ++t) {
    const int st = (t - t_first) & 1;
    const int q0 = t * kTile;
    if (t + 1 < n_q) load_q_tile(t + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // k/v and q tile t
    __syncthreads();
    const bf16* qs = q_s + st * kTileElems;
    const bf16* dos = do_s + st * kTileElems;
    const float* ls = lse_s + st * kTile;
    const float* dls = dl_s + st * kTile;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = 32 * half;
      const int r0 = q0 + c0;  // the half's first q row
      // all rows past Sq, or none of them sees a key of this warp: skip
      if (r0 >= Sq || (causal && r0 + 31 + offset < kw0)) continue;
      const bool masked = kpad != nullptr || r0 + 32 > Sq ||
                          (causal && r0 + offset < kw0 + 15);
      if (masked)
        dkv_half<D, true>(dka, dva, ks, vs, qs, dos, ls, dls, c0, q0, kw0,
                          Sq, offset, causal, kok, sl2, drop_p, inv_keep,
                          seed, bh);
      else
        dkv_half<D, false>(dka, dva, ks, vs, qs, dos, ls, dls, c0, q0, kw0,
                           Sq, offset, causal, kok, sl2, drop_p, inv_keep,
                           seed, bh);
    }
    __syncthreads();  // every warp is done with stage st
  }
  cp_async_wait<0>();

  // dK (times scale) and dV through the warp's own k/v rows: 16-byte
  // stores into contiguous [B, Sk, H, D]
  bf16* dk_s = k_s + 16 * warp * LD;
  bf16* dv_s = v_s + 16 * warp * LD;
  __syncwarp();
  frags_to_smem<D>(dk_s, dka, scale, scale);
  frags_to_smem<D>(dv_s, dva, 1.f, 1.f);
  __syncwarp();
  const long long row_stride = static_cast<long long>(H) * D;
  const long long base = static_cast<long long>(b) * Sk * row_stride +
                         static_cast<long long>(h) * D;
  store_rows<D>(dk + base, row_stride, dk_s, kw0, Sk);
  store_rows<D>(dv + base, row_stride, dv_s, kw0, Sk);
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

// bytes of shared memory of a bf16 kernel: n_tiles [64][D + 8] bf16 tiles
// and n_vec [64] f32 vectors
template <int D>
constexpr size_t smem_bf16(int n_tiles, int n_vec) {
  return static_cast<size_t>(n_tiles) * kTile * (D + 8) * sizeof(bf16) +
         static_cast<size_t>(n_vec) * kTile * sizeof(float);
}

// f32: the scalar kernel; bf16: the tensor-core kernel
template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v,
                const void* kpad, void* o, void* lse, const Layout& lay,
                const Args& a, cudaStream_t stream) {
  const dim3 grid(a.B * a.H, (a.Sq + kTile - 1) / kTile);
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t smem = smem_bf16<D>(5, 0);  // q, k ring x 2, v ring x 2
    auto kernel = flash_fwd_bf16_kernel<D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const float*>(kpad),
        static_cast<bf16*>(o), static_cast<float*>(lse), lay, a.H, a.Sq,
        a.Sk, a.scale, a.causal, a.drop_p, a.inv_keep, a.seed);
  } else {
    const size_t smem = sizeof(float) * smem_floats<D>(3, 1, 1);
    auto kernel = flash_fwd_kernel<T, D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(kpad),
        static_cast<T*>(o), static_cast<float*>(lse), lay, a.H, a.Sq, a.Sk,
        a.scale, a.causal, a.drop_p, a.inv_keep, a.seed);
  }
  return cudaGetLastError();
}

// f32: the scalar kernel; bf16: the tensor-core kernel
template <typename T, int D>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* kpad,
               void* dqp, const Layout& lay, const Args& a,
               cudaStream_t stream) {
  const dim3 grid(a.B * a.H, (a.Sq + kTile - 1) / kTile);
  if constexpr (std::is_same<T, bf16>::value) {
    const size_t smem = smem_bf16<D>(6, 0);  // q, dO, k ring x 2, v ring x 2
    auto kernel = flash_dq_bf16_kernel<D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const float*>(kpad), static_cast<bf16*>(dqp), lay, a.H,
        a.Sq, a.Sk, a.scale, a.causal, a.drop_p, a.inv_keep, a.seed);
  } else {
    const size_t smem = sizeof(float) * smem_floats<D>(4, 1, 1);
    auto kernel = flash_dq_kernel<T, D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const float*>(kpad), static_cast<T*>(dqp), lay, a.H,
        a.Sq, a.Sk, a.scale, a.causal, a.drop_p, a.inv_keep, a.seed);
  }
  return cudaGetLastError();
}

// f32: the scalar kernel; bf16: the tensor-core kernel
template <typename T, int D>
cudaError_t dkv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                const void* kpad, void* dkp, void* dvp, const Layout& lay,
                const Args& a, cudaStream_t stream) {
  const dim3 grid(a.B * a.H, (a.Sk + kTile - 1) / kTile);
  if constexpr (std::is_same<T, bf16>::value) {
    // k, v, q ring x 2, dO ring x 2; LSE and Delta rings x 2
    const size_t smem = smem_bf16<D>(6, 4);
    auto kernel = flash_dkv_bf16_kernel<D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const float*>(kpad), static_cast<bf16*>(dkp),
        static_cast<bf16*>(dvp), lay, a.H, a.Sq, a.Sk, a.scale, a.causal,
        a.drop_p, a.inv_keep, a.seed);
  } else {
    const size_t smem = sizeof(float) * smem_floats<D>(4, 2, 3);
    auto kernel = flash_dkv_kernel<T, D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<const float*>(kpad), static_cast<T*>(dkp),
        static_cast<T*>(dvp), lay, a.H, a.Sq, a.Sk, a.scale, a.causal,
        a.drop_p, a.inv_keep, a.seed);
  }
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

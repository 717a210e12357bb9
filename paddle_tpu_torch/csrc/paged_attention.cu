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
// reference masks their scores to -1e30). Softmax is online across keys
// in f32: running max m, running sum l (floored at 1e-30 at the end) and
// the f32 accumulator. int8 pages are widened in registers and scaled by
// their per-slot f32 scales, so a full-width page never exists in device
// memory. Page 0 is the pool's null page; padding rows point there.
//
// What bounds it. Decode reads every live KV page of its row once and does
// 4 flops per key element: it is bound by the bytes of the KV pages (the
// page bytes over 3.35 TB/s). The rows of a prompt chunk share their
// slot's pages, so once a page is read once per chunk tile, a chunk does
// 8-16 query rows of f32 FMAs per page element: it is bound by f32 FMAs
// on CUDA cores.
//
// Design. Two kernels behind one entry point; the launch plan (the
// wrapper's, from shapes only: T, kv heads, page size, pages per
// sequence) gives the pages per partition, the partitions n_split and
// the rows per tile R.
//
// 1. paged_attention_kernel, a grid of (T, nkv, n_split), 128 threads.
//    Block (t, h, s) takes the pages [s P, (s + 1) P) of its row's table
//    (flash-decoding: a long row is split across blocks, so the longest
//    row no longer sets the time alone). Row tiles: the leader of a tile,
//    a row t with t % R == 0, checks (one 4-byte compare per member row
//    and page of its partition, then __syncthreads_and) that rows t ..
//    t+R-1 name the same pages wherever each of them needs one; then it
//    serves all of them, each page read once for the whole tile, each row
//    masked at its own length, and the member rows' blocks, which check
//    the same predicate, exit. Otherwise (a slot boundary, decode rows of
//    different slots) every row goes alone. Both paths are exact. The
//    block's query vectors (R rows x groups heads, at most 16) are f32 in
//    shared memory for the whole partition. Keys stream through a 3-stage
//    ring of 32-key tiles filled by cp.async as the pages store them (f32,
//    bf16 or int8, never widened in memory; rows padded by 16 bytes so an
//    8-lane phase of 16-byte reads meets 8 bank groups); the next two
//    tiles are in flight while this one computes. Each warp takes 8 keys
//    of a tile:
//    for the scores, 4 lanes a key, each a quarter of the head dim, summed
//    by two shuffles; for P.V, the lanes split the head dim 4 elements
//    each and p comes by shuffle, so no thread loops over a tile's keys
//    alone. Each warp keeps its own (m, l, acc) per query vector in the
//    log2 domain; the four are merged in shared memory at the end. The
//    per-tile step is compiled twice, for one query vector (a decode row
//    of MHA) and for the block's whole set, padded with zero vectors, so
//    neither loops over query vectors behind per-vector branches. With
//    n_split 1 the block writes the output; otherwise it writes its
//    partial (m in natural-log units, l, acc unnormalised; an empty
//    partition writes m = -1e30, l = 0, acc = 0) to an f32 workspace.
// 2. paged_merge_kernel, a grid of (T, nh): o = sum_s acc_s e^(m_s - M) /
//    max(sum_s l_s e^(m_s - M), 1e-30), M = max_s m_s.
//
// Known losses: the scores and P.V of a chunk tile run on CUDA cores
// (tensor cores for bf16 q are later work), q is read from shared memory
// rather than kept in registers, every row of a tile that does not agree
// goes alone, and the plan's 132 SMs are the H100's, not read from the
// card.
//
// Interface: a plain C function returning cudaError_t, bound with ctypes.
// The caller allocates the output and the workspace and passes PyTorch's
// current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileKeys = 32;                   // keys a ring stage holds
constexpr int kWarpKeys = kTileKeys / kWarps;   // 8 keys a warp
constexpr int kStages = 3;                      // tiles in the ring
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// dtype codes shared with paddle_tpu_torch/ops/paged_attention.py
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kI8 = 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// N bytes global -> shared, asynchronously; zero-filled when !ok
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool ok) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(N), "r"(ok ? N : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// eight elements (8-element aligned in a padded shared row) as f32
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

// four elements (4-element aligned) as f32
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    o[2 * k] = f.x;
    o[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void load4(const int8_t* p, float* o) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = static_cast<float>(c[k]);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// bytes of one padded key row of a ring stage
template <typename KVT>
__host__ __device__ constexpr int row_bytes(int hd) {
  return hd * static_cast<int>(sizeof(KVT)) + 16;
}

// Shared memory of paged_attention_kernel, in bytes: the query vectors
// (f32), the per-key scales ring, then the K/V ring, which the warps'
// (m, l, acc) reuse at the end.
template <typename KVT, int kMaxQ>
__host__ __device__ constexpr size_t smem_bytes(int hd) {
  const size_t q = static_cast<size_t>(kMaxQ) * hd * 4;
  const size_t scales = kStages * 2 * kTileKeys * 4;
  const size_t ring = kStages * 2 * static_cast<size_t>(kTileKeys) *
                      row_bytes<KVT>(hd);
  const size_t merge = static_cast<size_t>(kWarps) * kMaxQ * (hd + 2) * 4;
  return q + scales + (ring > merge ? ring : merge);
}

// Whether rows lead+1 .. end-1 name the leader's pages wherever each of
// them needs one among pages [j0, j1). Block-uniform.
__device__ bool tile_agrees(const int* __restrict__ bt,
                            const int* __restrict__ row_lens, int lead,
                            int end, int j0, int j1, int page_size,
                            int pages_per_seq) {
  const int span = j1 - j0;
  const int* lbt = bt + static_cast<size_t>(lead) * pages_per_seq;
  const int cap = pages_per_seq * page_size;
  bool ok = true;
  for (int e = threadIdx.x; e < (end - lead - 1) * span; e += kThreads) {
    const int m = lead + 1 + e / span;
    const int j = j0 + e % span;
    const int need = (min(row_lens[m], cap) + page_size - 1) / page_size;
    if (j < need && bt[static_cast<size_t>(m) * pages_per_seq + j] != lbt[j])
      ok = false;
  }
  return __syncthreads_and(ok) != 0;
}

// Where a block's key tiles come from and go to
template <typename KVT>
struct TileSrc {
  const KVT* k_pool;
  const KVT* v_pool;
  const float* k_scale;  // null unless int8
  const float* v_scale;
  const int* bt;         // the block table the block reads
  unsigned char* ring;   // [kStages][K rows, V rows][32][rb bytes]
  float* sc_s;           // [kStages][K, V][32] per-key scales
  int stage_bytes, rb, kstart, kend, page_size, hd, h, nkv;
};

// Tile i of a block's keys into ring stage st by cp.async: K and V rows
// of 32 keys (head h's slice of each key's slot), 8 elements a copy, as
// the pages store them; keys past kend zero-filled. Not waited for.
template <typename KVT>
__device__ __forceinline__ void load_tile(const TileSrc<KVT>& a, int i,
                                          int st) {
  constexpr int kEl = sizeof(KVT);
  const int tid = threadIdx.x;
  unsigned char* kst = a.ring + st * a.stage_bytes;
  unsigned char* vst = kst + kTileKeys * a.rb;
  const int kt0 = a.kstart + i * kTileKeys;
  const int chunks = a.hd / 8;
  const size_t slot_stride = static_cast<size_t>(a.nkv) * a.hd;
  for (int e = tid; e < kTileKeys * chunks; e += kThreads) {
    const int key = e / chunks, c = e - (e / chunks) * chunks;
    const int pos = kt0 + key;
    const bool ok = pos < a.kend;
    size_t off = 0;
    if (ok) {
      const int j = pos / a.page_size;
      const int slot = pos - j * a.page_size;
      off = (static_cast<size_t>(a.bt[j]) * a.page_size + slot) * slot_stride +
            static_cast<size_t>(a.h) * a.hd + c * 8;
    }
    const uint32_t dk = smem_addr(kst + key * a.rb + c * 8 * kEl);
    const uint32_t dv = smem_addr(vst + key * a.rb + c * 8 * kEl);
    if constexpr (kEl == 4) {
      cp_async<16>(dk, a.k_pool + off, ok);
      cp_async<16>(dk + 16, a.k_pool + off + 4, ok);
      cp_async<16>(dv, a.v_pool + off, ok);
      cp_async<16>(dv + 16, a.v_pool + off + 4, ok);
    } else {
      cp_async<8 * kEl>(dk, a.k_pool + off, ok);
      cp_async<8 * kEl>(dv, a.v_pool + off, ok);
    }
  }
  if (a.k_scale != nullptr && tid < 2 * kTileKeys) {
    const int key = tid & (kTileKeys - 1);
    const int pos = kt0 + key;
    const bool ok = pos < a.kend;
    size_t so = 0;
    if (ok) {
      const int j = pos / a.page_size;
      so = (static_cast<size_t>(a.bt[j]) * a.page_size + pos -
            j * a.page_size) * a.nkv + a.h;
    }
    const float* sp = tid < kTileKeys ? a.k_scale : a.v_scale;
    cp_async<4>(smem_addr(a.sc_s + st * 2 * kTileKeys + tid), sp + so, ok);
  }
}

// One ring stage's 32 keys into a warp's running state (its 8 keys), for
// query vectors 0 .. NQ-1 of q_s (NQ <= kMaxQ; vectors past the block's
// count are zeros with length 0, so they add nothing). pos: the position
// of this lane's score key.
template <typename KVT, int NC, int NQ, int kMaxQ>
__device__ __forceinline__ void tile_step(
    float (&m)[kMaxQ], float (&l)[kMaxQ], float (&acc)[kMaxQ][4 * NC],
    const float* q_s, const unsigned char* kst, const unsigned char* vst,
    const float* scs, int rb, int hd, int pos, int kend,
    const int (&qlen)[kMaxQ], float scale_log2, bool scaled) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kl = warp * kWarpKeys + (lane & 7);
  const int units = hd / 4;

  // scores of this lane's key: a quarter of the head dim, 8 at a time
  float s[NQ];
#pragma unroll
  for (int qi = 0; qi < NQ; ++qi) s[qi] = 0.f;
  const KVT* krow = reinterpret_cast<const KVT*>(kst + kl * rb);
  for (int c = lane >> 3; c < hd / 8; c += 4) {
    float kf[8];
    load8(krow + c * 8, kf);
#pragma unroll
    for (int qi = 0; qi < NQ; ++qi) {
      float qf[8];
      load8(q_s + qi * hd + c * 8, qf);
#pragma unroll
      for (int x = 0; x < 8; ++x) s[qi] = fmaf(qf[x], kf[x], s[qi]);
    }
  }
  const float ksc = scaled ? scs[kl] : 1.f;

  // online softmax over the warp's 8 keys, each query vector apart
  float p[NQ];
#pragma unroll
  for (int qi = 0; qi < NQ; ++qi) {
    float y = s[qi];
    y += __shfl_xor_sync(0xffffffffu, y, 8);
    y += __shfl_xor_sync(0xffffffffu, y, 16);
    const bool valid = pos < kend && pos < qlen[qi];
    y = valid ? y * ksc * scale_log2 : kNegInf;
    float mx = fmaxf(y, __shfl_xor_sync(0xffffffffu, y, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float m_new = fmaxf(m[qi], mx);
    const float alpha = exp2f(m[qi] - m_new);
    p[qi] = valid ? exp2f(y - m_new) : 0.f;
    l[qi] = l[qi] * alpha + p[qi];
    m[qi] = m_new;
#pragma unroll
    for (int u = 0; u < 4 * NC; ++u) acc[qi][u] *= alpha;
  }

  // acc += p.V: p of key kk from lane kk, the lane's units of the head
  // dim (zero-filled rows past kend carry p = 0)
#pragma unroll
  for (int kk = 0; kk < kWarpKeys; ++kk) {
    const int vk = warp * kWarpKeys + kk;
    const float vsc = scaled ? scs[kTileKeys + vk] : 1.f;
    const KVT* vrow = reinterpret_cast<const KVT*>(vst + vk * rb);
    float pk[NQ];
#pragma unroll
    for (int qi = 0; qi < NQ; ++qi)
      pk[qi] = __shfl_sync(0xffffffffu, p[qi], kk) * vsc;
#pragma unroll
    for (int cu = 0; cu < NC; ++cu) {
      const int u = lane + 32 * cu;
      if (u < units) {
        float vf[4];
        load4(vrow + u * 4, vf);
#pragma unroll
        for (int qi = 0; qi < NQ; ++qi)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            acc[qi][4 * cu + x] = fmaf(pk[qi], vf[x], acc[qi][4 * cu + x]);
      }
    }
  }
}

// kMaxQ: the most query vectors a block serves (rows of its tile x GQA
// group). NC: 4-element units of the head dim a lane owns in P.V (hd <=
// 128 NC 1, hd <= 256 NC 2).
template <typename QT, typename KVT, int NC, int kMaxQ>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q,
                       const KVT* __restrict__ k_pool,
                       const KVT* __restrict__ v_pool,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ row_lens,
                       QT* __restrict__ out, float* __restrict__ ws, int T,
                       int nh, int nkv, int hd, int page_size,
                       int pages_per_seq, int part_pages, int rows_per_tile,
                       float scale_log2) {
  const int t = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int n_split = gridDim.z;
  const int groups = nh / nkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = sp * part_pages;
  const int j1 = min(j0 + part_pages, pages_per_seq);
  const int cap = pages_per_seq * page_size;

  // the rows this block serves: its tile (when the tile agrees), itself,
  // or none (a member row its leader covers)
  const int lead = t - t % rows_per_tile;
  const int end = min(lead + rows_per_tile, T);
  int r0 = t, nr = 1;
  if (end - lead > 1 &&
      tile_agrees(block_tables, row_lens, lead, end, j0, j1, page_size,
                  pages_per_seq)) {
    if (t != lead) return;
    r0 = lead;
    nr = end - lead;
  }
  const int nq = nr * groups;  // query vector i: row r0 + i / groups

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);         // [kMaxQ][hd]
  float* sc_s = q_s + kMaxQ * hd;  // [kStages][2][32]
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(sc_s + kStages * 2 * kTileKeys);
  const int rb = row_bytes<KVT>(hd);
  const int stage_bytes = 2 * kTileKeys * rb;  // K rows, then V rows

  // lengths: each query vector's row, and the block's key range
  int qlen[kMaxQ];
  int lmax = 0;
#pragma unroll
  for (int i = 0; i < kMaxQ; ++i) {
    qlen[i] = i < nq ? min(row_lens[r0 + i / groups], cap) : 0;
    lmax = max(lmax, qlen[i]);
  }
  const int kstart = j0 * page_size;
  const int kend = min(j1 * page_size, lmax);
  const int n_tiles = kend > kstart
                          ? (kend - kstart + kTileKeys - 1) / kTileKeys
                          : 0;
  const int* lbt = block_tables + static_cast<size_t>(r0) * pages_per_seq;

  const TileSrc<KVT> src{k_pool, v_pool, k_scale, v_scale, lbt, ring, sc_s,
                         stage_bytes, rb, kstart, kend, page_size, hd, h,
                         nkv};

  // the query vectors, f32, for the whole partition; zeros past nq
  for (int e = tid; e < kMaxQ * hd; e += kThreads) {
    const int i = e / hd, d = e - (e / hd) * hd;
    q_s[e] = i < nq ? to_f(q[(static_cast<size_t>(r0 + i / groups) * nh +
                              h * groups + i % groups) * hd + d])
                    : 0.f;
  }

  // this warp's running state, per query vector: m (log2 domain), this
  // lane's part of l (its key column), and the lane's P.V units
  float m[kMaxQ], l[kMaxQ], acc[kMaxQ][4 * NC];
#pragma unroll
  for (int i = 0; i < kMaxQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < 4 * NC; ++u) acc[i][u] = 0.f;
  }
  const int kl = warp * kWarpKeys + (lane & 7);  // this lane's score key
  const int units = hd / 4;

  // a ring of kStages tiles: tile i + kStages - 1 loads while tile i
  // computes
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(src, i, i);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const int nxt = i + kStages - 1;
    if (nxt < n_tiles) load_tile(src, nxt, nxt % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // tile i
    __syncthreads();
    const unsigned char* kst = ring + st * stage_bytes;
    const float* scs = sc_s + st * 2 * kTileKeys;
    const int pos = kstart + i * kTileKeys + kl;
    // one query vector (a decode row of MHA) or the block's whole set,
    // padded with zero vectors of length 0
    if (nq == 1)
      tile_step<KVT, NC, 1>(m, l, acc, q_s, kst, kst + kTileKeys * rb, scs,
                            rb, hd, pos, kend, qlen, scale_log2,
                            k_scale != nullptr);
    else
      tile_step<KVT, NC, kMaxQ>(m, l, acc, q_s, kst, kst + kTileKeys * rb,
                                scs, rb, hd, pos, kend, qlen, scale_log2,
                                k_scale != nullptr);
    __syncthreads();  // every warp is done with stage st
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the four warps through shared memory (over the ring)
  float* m_s = reinterpret_cast<float*>(ring);   // [kWarps][kMaxQ]
  float* l_s = m_s + kWarps * kMaxQ;             // [kWarps][kMaxQ]
  float* a_s = l_s + kWarps * kMaxQ;             // [kWarps][kMaxQ][hd]
#pragma unroll
  for (int qi = 0; qi < kMaxQ; ++qi) {
    if (qi < nq) {
      float lw = l[qi];
      lw += __shfl_xor_sync(0xffffffffu, lw, 1);
      lw += __shfl_xor_sync(0xffffffffu, lw, 2);
      lw += __shfl_xor_sync(0xffffffffu, lw, 4);
      if (lane == 0) {
        m_s[warp * kMaxQ + qi] = m[qi];
        l_s[warp * kMaxQ + qi] = lw;
      }
#pragma unroll
      for (int cu = 0; cu < NC; ++cu) {
        const int u = lane + 32 * cu;
        if (u < units)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            a_s[(warp * kMaxQ + qi) * hd + 4 * u + x] = acc[qi][4 * cu + x];
      }
    }
  }
  __syncthreads();

  const size_t n_out = static_cast<size_t>(T) * nh;
  for (int e = tid; e < nq * hd; e += kThreads) {
    const int qi = e / hd, d = e - (e / hd) * hd;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, m_s[w * kMaxQ + qi]);
    float ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(m_s[w * kMaxQ + qi] - mm);
      ls += l_s[w * kMaxQ + qi] * f;
      a += a_s[(w * kMaxQ + qi) * hd + d] * f;
    }
    const size_t oi = static_cast<size_t>(r0 + qi / groups) * nh +
                      h * groups + qi % groups;  // (row, head)
    if (n_split == 1) {
      store1(out + oi * hd + d, a / fmaxf(ls, 1e-30f));
    } else {
      const size_t wi = static_cast<size_t>(sp) * n_out + oi;
      ws[wi * hd + d] = a;
      if (d == 0) {
        float* ml = ws + static_cast<size_t>(n_split) * n_out * hd;
        ml[2 * wi] = ls > 0.f ? mm * kLn2 : kNegInf;
        ml[2 * wi + 1] = ls;
      }
    }
  }
}

// o[t, head] from the n_split partials of the workspace: acc [n_split,
// T, nh, hd], then (m, l) [n_split, T, nh, 2]
template <typename QT>
__global__ void paged_merge_kernel(const float* __restrict__ ws,
                                   QT* __restrict__ out, int n_split, int nh,
                                   int hd) {
  const size_t oi = static_cast<size_t>(blockIdx.x) * nh + blockIdx.y;
  const size_t n_out = static_cast<size_t>(gridDim.x) * nh;
  const float* ml = ws + static_cast<size_t>(n_split) * n_out * hd;
  float mm = kNegInf;
  for (int s = 0; s < n_split; ++s) mm = fmaxf(mm, ml[2 * (s * n_out + oi)]);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float ls = 0.f, a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t wi = s * n_out + oi;
      const float f = expf(ml[2 * wi] - mm);
      ls += ml[2 * wi + 1] * f;
      a += ws[wi * hd + d] * f;
    }
    store1(out + oi * hd + d, a / fmaxf(ls, 1e-30f));
  }
}

struct Plan {
  int n_split, part_pages, rows_per_tile, max_q;
};

template <typename QT, typename KVT, int NC, int kMaxQ>
cudaError_t launch_attn(const void* q, const void* k_pool,
                        const void* v_pool, const void* k_scale,
                        const void* v_scale, const void* block_tables,
                        const void* row_lens, void* out, void* ws, int T,
                        int nh, int nkv, int hd, int page_size,
                        int pages_per_seq, const Plan& plan, float scale,
                        cudaStream_t stream) {
  const size_t smem = smem_bytes<KVT, kMaxQ>(hd);
  auto kernel = paged_attention_kernel<QT, KVT, NC, kMaxQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(T, nkv, plan.n_split);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int*>(block_tables),
      static_cast<const int*>(row_lens), static_cast<QT*>(out),
      static_cast<float*>(ws), T, nh, nkv, hd, page_size, pages_per_seq,
      plan.part_pages, plan.rows_per_tile, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || plan.n_split == 1) return err;
  const dim3 mgrid(T, nh);
  paged_merge_kernel<QT><<<mgrid, (hd + 31) / 32 * 32, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<QT*>(out), plan.n_split, nh,
      hd);
  return cudaGetLastError();
}

template <typename QT, typename KVT>
cudaError_t dispatch_shape(const void* q, const void* k_pool,
                           const void* v_pool, const void* k_scale,
                           const void* v_scale, const void* block_tables,
                           const void* row_lens, void* out, void* ws, int T,
                           int nh, int nkv, int hd, int page_size,
                           int pages_per_seq, const Plan& plan, float scale,
                           cudaStream_t s) {
#define PAGED_LAUNCH(NC, MQ)                                                 \
  return launch_attn<QT, KVT, NC, MQ>(q, k_pool, v_pool, k_scale, v_scale,  \
                                      block_tables, row_lens, out, ws, T,   \
                                      nh, nkv, hd, page_size, pages_per_seq, \
                                      plan, scale, s)
  if (hd <= 128) {
    if (plan.max_q <= 8) PAGED_LAUNCH(1, 8);
    PAGED_LAUNCH(1, 16);
  }
  if (plan.max_q <= 8) PAGED_LAUNCH(2, 8);
  PAGED_LAUNCH(2, 16);
#undef PAGED_LAUNCH
}

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, const void* q, const void* k_pool,
                        const void* v_pool, const void* k_scale,
                        const void* v_scale, const void* block_tables,
                        const void* row_lens, void* out, void* ws, int T,
                        int nh, int nkv, int hd, int page_size,
                        int pages_per_seq, const Plan& plan, float scale,
                        cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32:
      return dispatch_shape<QT, float>(q, k_pool, v_pool, k_scale, v_scale,
                                       block_tables, row_lens, out, ws, T,
                                       nh, nkv, hd, page_size, pages_per_seq,
                                       plan, scale, stream);
    case kBF16:
      return dispatch_shape<QT, __nv_bfloat16>(
          q, k_pool, v_pool, k_scale, v_scale, block_tables, row_lens, out,
          ws, T, nh, nkv, hd, page_size, pages_per_seq, plan, scale, stream);
    case kI8:
      return dispatch_shape<QT, int8_t>(q, k_pool, v_pool, k_scale, v_scale,
                                        block_tables, row_lens, out, ws, T,
                                        nh, nkv, hd, page_size,
                                        pages_per_seq, plan, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// out[T, nh, hd] (q's dtype) = ragged paged attention of q[T, nh, hd] over
// k_pool/v_pool[num_pages, page_size, nkv, hd]; block_tables[T,
// pages_per_seq] and row_lens[T] are int32; k_scale/v_scale are f32
// [num_pages, page_size, nkv] or both null. The plan: n_split partitions
// of part_pages pages (n_split = ceil(pages_per_seq / part_pages)), row
// tiles of rows_per_tile rows (rows_per_tile * nh / nkv <= 16). ws: f32
// workspace of n_split * T * nh * (hd + 2) floats when n_split > 1, else
// null. All arrays contiguous on the current device. Returns the first
// failing launch's cudaError_t.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* row_lens, void* out, void* ws, int T, int nh, int nkv,
    int hd, int page_size, int pages_per_seq, int n_split, int part_pages,
    int rows_per_tile, float scale, int q_dtype, int kv_dtype,
    void* stream) {
  const int groups = nkv > 0 ? nh / nkv : 0;
  if (T <= 0 || nkv <= 0 || nh % nkv != 0 || groups > 16 || hd % 8 != 0 ||
      hd > 256 || page_size < 1 || page_size > 64 || pages_per_seq < 1 ||
      part_pages < 1 || n_split != (pages_per_seq + part_pages - 1) /
                                       part_pages ||
      n_split > 65535 || nkv > 65535 || rows_per_tile < 1 ||
      rows_per_tile * groups > 16 || (n_split > 1) != (ws != nullptr) ||
      (k_scale == nullptr) != (v_scale == nullptr) ||
      (kv_dtype == kI8 && k_scale == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan plan{n_split, part_pages, rows_per_tile, rows_per_tile * groups};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (q_dtype) {
    case kF32:
      err = dispatch_kv<float>(kv_dtype, q, k_pool, v_pool, k_scale, v_scale,
                               block_tables, row_lens, out, ws, T, nh, nkv,
                               hd, page_size, pages_per_seq, plan, scale, s);
      break;
    case kBF16:
      err = dispatch_kv<__nv_bfloat16>(kv_dtype, q, k_pool, v_pool, k_scale,
                                       v_scale, block_tables, row_lens, out,
                                       ws, T, nh, nkv, hd, page_size,
                                       pages_per_seq, plan, scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

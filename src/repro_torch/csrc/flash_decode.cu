// Flash attention decode for Hopper: one query row per (batch, head) over a
// key/value cache, on a split-K grid, float32 or bf16.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel, pallas_call at :83) for the decode
// steps of the LM path: `kernels/flash_attention.py::route` sends every
// call with Lq == 1 here. The function is the reference's,
//
//   s   = (q * scale) . k^T               in float32, scale first
//   keys past kv_offset take no part      (under `causal`)
//   out = softmax(s) . v = acc / max(l, 1e-30), in q's dtype
//
// with q (B, 1, H, D), k/v (B, Lk, KVH, D) and grouped-query heads read in
// place (query head h reads KV head h / (H / KVH)).
//
// Bound on this card. At the LM main path's decode (B 4, Lk 2,080, KVH 8,
// D 128, bf16) the cache is 34 MB, 0.010 ms at 3.35 TB/s, against 0.3
// GFLOP: bytes bound it, so the design is about reading K and V once, at
// full width, from enough CTAs to keep the card's memory busy; tensor
// cores would buy nothing.
//
// Design. Grid (key split, KV head x head group, batch): a CTA of 128
// threads takes up to four query heads of one KV group (all three of
// llama3.2-3b's), so each K and V row is read once per group, not once per
// query head, and streams one split of the visible keys through shared
// memory in sub-blocks of 32 rows: a double buffer filled with 16-byte
// cp.async copies, the next sub-block's copies in flight while this one
// is computed. Per sub-block:
// - scores: a half-warp per key row, lane j holding elements
//   [j D/16, (j + 1) D/16) of it and of each head's query (times scale,
//   float32); the four heads' partial dots are reduced across the 16
//   lanes in one transposed butterfly (5 shuffles, not 16);
// - online softmax: warp i takes head i, lane r row r of the sub-block:
//   running max m and sum l, p = exp(s - m), the rescale alpha (expf);
// - P.V: a thread per pair of columns and group of rows, every head at
//   once, accumulators rescaled by alpha (float32 FMA).
// Keys past the visible range are never loaded; a split with no visible
// key writes m = -inf, l = 0 (the reference's -1e30 would give exp(0) = 1
// per key and l = the split's length). Each CTA writes a float32 partial
// (m, l, acc) per head into a scratch tensor the wrapper allocates; the
// partials are merged in the same launch: each CTA counts itself in on a
// per-(batch, KV head, head group) arrival counter after a fence, and the
// last to arrive loads every split's (m, l) at once into shared memory,
// weighs the splits by exp(m_c - M), sums their acc (IEEE division by the
// total l) and writes the output. The counters lie at the end of the
// call's own scratch and are zeroed on the stream just before the kernel,
// so launches on other streams, or replays of other CUDA graphs, share
// none, and a launch that stops part-way leaves nothing behind for the
// next. Given an lse buffer, the merging CTA also writes each head's
// natural log-sum-exp M + log(sum of the weighted l), the figure a
// sequence-parallel decode combines across ranks (each rank holding a
// slice of the cache). The wrapper sizes the splits (multiples of 32
// keys) so the grid is about four CTAs per SM, one wave (17 splits of 128
// keys, 544 CTAs at the main path's shape; 33 KB of shared memory lets six
// share an SM), and leaves keys past the visible ones out.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int HALF_WARPS = THREADS / 16;
constexpr int GB = 4;            // query heads per CTA (one warp each)
constexpr int SB = 32;           // rows per sub-block (one per lane)
constexpr int MAX_CHUNKS = 2048;      // splits per group (the merge's
                                      // (m, l) fill 64 KB of shared memory)
constexpr int STAGES = 2;         // sub-blocks in the K/V ring
constexpr int MAX_SMEM = 200 * 1024;   // the opt-in

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// E consecutive elements of a row as float32 (global or shared memory).
template <int E>
__device__ __forceinline__ void load_row(const float* p, float (&x)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + e);
      x[e] = t.x;
      x[e + 1] = t.y;
      x[e + 2] = t.z;
      x[e + 3] = t.w;
    }
  } else if constexpr (E % 2 == 0) {
#pragma unroll
    for (int e = 0; e < E; e += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + e);
      x[e] = t.x;
      x[e + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) x[e] = p[e];
  }
}

template <int E>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&x)[E]) {
  if constexpr (E % 8 == 0) {
#pragma unroll
    for (int e = 0; e < E; e += 8) {
      const uint4 t = *reinterpret_cast<const uint4*>(p + e);
      const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[u]));
        x[e + 2 * u] = f.x;
        x[e + 2 * u + 1] = f.y;
      }
    }
  } else if constexpr (E % 2 == 0) {
#pragma unroll
    for (int e = 0; e < E; e += 2) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p + e));
      x[e] = f.x;
      x[e + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) x[e] = __bfloat162float(p[e]);
  }
}

// Two consecutive elements as float32.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The shape of a kernel instance: E = D / 16 elements per lane of a key
// row, and the P.V thread layout.
template <typename T, int E>
struct Shape {
  static constexpr int D = 16 * E;
  static constexpr int ROW = D * (int)sizeof(T);      // bytes of a row
  static constexpr int PIECES = ROW / 16;             // copies per row
  static constexpr int STAGE = SB * ROW;              // bytes of K (or V)
  static constexpr int PAIRS = D / 2;                 // column pairs
  static constexpr int NH = THREADS / PAIRS;          // row groups of P.V
  // K ring, V ring, scores (SB x GB), the row groups' sums of P.V
  static constexpr size_t TILES = (size_t)2 * STAGES * STAGE +
                                  (size_t)SB * GB * 4 +
                                  (size_t)(NH - 1) * GB * D * 4;
};

template <typename T, int E>
__global__ void __launch_bounds__(THREADS)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        float* __restrict__ lse, float* __restrict__ part,
                        unsigned* __restrict__ counters, int Lk, int H,
                        int KVH, int HG, float scale, int n_vis,
                        int chunk_len, int n_chunks) {
  using S = Shape<T, E>;
  constexpr int D = S::D;
  static_assert(GB == 4 && THREADS / 32 == GB,
                "a warp per head; P.V reads four probabilities as float4");
  extern __shared__ float4 smem4[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4);
  T* ks = reinterpret_cast<T*>(ring);                     // STAGES x SB x D
  T* vs = reinterpret_cast<T*>(ring + STAGES * S::STAGE);  // the same
  float* ps = reinterpret_cast<float*>(ring + 2 * STAGES * S::STAGE);
  float* red = ps + SB * GB;  // (NH - 1) x GB x D
  __shared__ float s_alpha[GB], s_m[GB], s_l[GB];
  __shared__ int s_last;

  const int c = blockIdx.x;
  const int kvh = blockIdx.y / HG;
  const int hg = blockIdx.y % HG;
  const int b = blockIdx.z;
  const int G = H / KVH;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hw = threadIdx.x / 16;
  const int ln = threadIdx.x % 16;
  const long long kv_stride = (long long)KVH * D;
  const T* k0 = k + ((long long)b * Lk * KVH + kvh) * D;
  const T* v0 = v + ((long long)b * Lk * KVH + kvh) * D;
  const int lo = c * chunk_len;
  const int hi = min(lo + chunk_len, n_vis);
  const int rows = max(0, hi - lo);
  const int n_sb = (rows + SB - 1) / SB;

  // Sub-block t's rows of K and V into stage t % STAGES; one commit group
  // per sub-block (empty past the last), so the wait counts stay fixed.
  auto load = [&](int t) {
    if (t < n_sb) {
      const int r0 = lo + t * SB;
      const int nr = min(SB, hi - r0);
      uint8_t* kd = ring + (t % STAGES) * S::STAGE;
      uint8_t* vd = kd + STAGES * S::STAGE;
      for (int x = threadIdx.x; x < nr * S::PIECES; x += THREADS) {
        const int r = x / S::PIECES, p = x % S::PIECES;
        const long long off = (long long)(r0 + r) * kv_stride;
        cp_async16(kd + r * S::ROW + p * 16,
                   reinterpret_cast<const uint8_t*>(k0 + off) + p * 16);
        cp_async16(vd + r * S::ROW + p * 16,
                   reinterpret_cast<const uint8_t*>(v0 + off) + p * 16);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) load(t);

  // This lane's slice of each head's query, times scale (float32).
  float qf[GB][E];
#pragma unroll
  for (int i = 0; i < GB; ++i) {
    const int g = hg * GB + i;
    if (g < G) {
      load_row(q + ((long long)b * H + kvh * G + g) * D + ln * E, qf[i]);
#pragma unroll
      for (int e = 0; e < E; ++e) qf[i][e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qf[i][e] = 0.f;
    }
  }

  float m_run = -INFINITY, l_run = 0.f;  // head `warp`, the same per lane
  const int pr = threadIdx.x % S::PAIRS;  // P.V: column pair
  const int rg = threadIdx.x / S::PAIRS;  // and row group
  const int d2 = 2 * pr;
  float a[GB][2] = {};

  for (int t = 0; t < n_sb; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // sub-block t landed; t - 1 is done with its stage
    load(t + STAGES - 1);
    const int st = t % STAGES;
    const T* kt = ks + (size_t)st * SB * D;
    const T* vt = vs + (size_t)st * SB * D;
    const int nr = min(SB, hi - (lo + t * SB));

    // Scores: rows 2 warp + {0, 1} + 8 j, a half-warp each.
#pragma unroll
    for (int r0 = 2 * warp; r0 < SB; r0 += HALF_WARPS) {
      const int r = r0 + (hw % 2);
      float kr[E];
      if (r < nr) {
        load_row(kt + (size_t)r * D + ln * E, kr);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kr[e] = 0.f;
      }
      float dd[GB];
#pragma unroll
      for (int i = 0; i < GB; ++i) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qf[i][e], kr[e], d);
        dd[i] = d;
      }
      // Lanes with bit 3 keep heads 2, 3 (else 0, 1) and swap the other
      // two with lane ^ 8; then bit 2 picks one of the pair with lane ^ 4;
      // lanes ^ 2 and ^ 1 finish the sum: lane 4 h holds head h.
      const bool up = ln & 8, up2 = ln & 4;
      const float x0 = __shfl_xor_sync(0xffffffffu, up ? dd[0] : dd[2], 8);
      const float x1 = __shfl_xor_sync(0xffffffffu, up ? dd[1] : dd[3], 8);
      const float h0 = (up ? dd[2] : dd[0]) + x0;
      const float h1 = (up ? dd[3] : dd[1]) + x1;
      float sc = (up2 ? h1 : h0) +
                 __shfl_xor_sync(0xffffffffu, up2 ? h0 : h1, 4);
      sc += __shfl_xor_sync(0xffffffffu, sc, 2);
      sc += __shfl_xor_sync(0xffffffffu, sc, 1);
      if ((ln & 3) == 0) ps[r * GB + (ln >> 2)] = r < nr ? sc : -INFINITY;
    }
    __syncthreads();

    // Online softmax: warp i takes head i, lane r row r.
    {
      const float sc = ps[lane * GB + warp];
      const float mx = fmaxf(m_run, warp_max(sc));
      const float base = mx == -INFINITY ? 0.f : mx;
      const float p = expf(sc - base);
      const float alpha = expf(m_run - base);
      l_run = l_run * alpha + warp_sum(p);
      m_run = mx;
      ps[lane * GB + warp] = p;
      if (lane == 0) s_alpha[warp] = alpha;
    }
    __syncthreads();

    // P.V for this thread's column pair over its rows of the sub-block.
    if (rg < S::NH) {
      const float4 al = *reinterpret_cast<const float4*>(s_alpha);
      a[0][0] *= al.x;
      a[0][1] *= al.x;
      a[1][0] *= al.y;
      a[1][1] *= al.y;
      a[2][0] *= al.z;
      a[2][1] *= al.z;
      a[3][0] *= al.w;
      a[3][1] *= al.w;
      for (int r = rg; r < nr; r += S::NH) {
        const float4 p = *reinterpret_cast<const float4*>(ps + r * GB);
        const float2 x = load2(vt + (size_t)r * D + d2);
        a[0][0] = fmaf(p.x, x.x, a[0][0]);
        a[0][1] = fmaf(p.x, x.y, a[0][1]);
        a[1][0] = fmaf(p.y, x.x, a[1][0]);
        a[1][1] = fmaf(p.y, x.y, a[1][1]);
        a[2][0] = fmaf(p.z, x.x, a[2][0]);
        a[2][1] = fmaf(p.z, x.y, a[2][1]);
        a[3][0] = fmaf(p.w, x.x, a[3][0]);
        a[3][1] = fmaf(p.w, x.y, a[3][1]);
      }
    }
  }
  cp_async_wait<0>();

  // The CTA's partial: the row groups of P.V summed, (m, l) per head.
  const long long group = (long long)b * gridDim.y + blockIdx.y;
  const long long n_groups = (long long)gridDim.z * gridDim.y;
  float* g_acc = part + group * n_chunks * GB * D;             // [c][i][d]
  float* g_ml = part + n_groups * n_chunks * GB * D +          // [c][i][2]
                group * n_chunks * GB * 2;
  if (rg > 0 && rg < S::NH)
#pragma unroll
    for (int i = 0; i < GB; ++i)
      *reinterpret_cast<float2*>(red + ((rg - 1) * GB + i) * D + d2) =
          make_float2(a[i][0], a[i][1]);
  if (lane == 0) {
    s_m[warp] = m_run;  // -inf, and l 0, for a split with no visible key
    s_l[warp] = l_run;
  }
  __syncthreads();
  if (rg == 0) {
    for (int g2 = 1; g2 < S::NH; ++g2)
#pragma unroll
      for (int i = 0; i < GB; ++i) {
        const float2 x = *reinterpret_cast<const float2*>(
            red + ((g2 - 1) * GB + i) * D + d2);
        a[i][0] += x.x;
        a[i][1] += x.y;
      }
#pragma unroll
    for (int i = 0; i < GB; ++i)
      *reinterpret_cast<float2*>(g_acc + ((long long)c * GB + i) * D + d2) =
          make_float2(a[i][0], a[i][1]);
  }
  if (threadIdx.x < GB) {
    g_ml[((long long)c * GB + threadIdx.x) * 2] = s_m[threadIdx.x];
    g_ml[((long long)c * GB + threadIdx.x) * 2 + 1] = s_l[threadIdx.x];
  }

  // Count this CTA in; the last of the group merges every split.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&counters[group], 1u) == (unsigned)(n_chunks - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // Every split's (m, l) at once into shared memory (over the ring), then
  // each head's max M and weights exp(m_c - M).
  float* w = reinterpret_cast<float*>(smem4);  // n_chunks x GB
  float* l = w + n_chunks * GB;                // n_chunks x GB
  for (int x = threadIdx.x; x < n_chunks * GB; x += THREADS) {
    w[x] = __ldcg(&g_ml[2 * (long long)x]);
    l[x] = __ldcg(&g_ml[2 * (long long)x + 1]);
  }
  __syncthreads();
  {
    const int i = warp;
    float mx = -INFINITY;
    for (int cc = lane; cc < n_chunks; cc += 32)
      mx = fmaxf(mx, w[cc * GB + i]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int cc = lane; cc < n_chunks; cc += 32) {
      const float mc = w[cc * GB + i];
      const float wt = mc == -INFINITY ? 0.f : expf(mc - mx);
      w[cc * GB + i] = wt;
      sum += wt * l[cc * GB + i];
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      s_l[i] = sum;
      s_m[i] = mx;
    }
  }
  __syncthreads();
  if (lse != nullptr && threadIdx.x < GB) {
    const int g = hg * GB + threadIdx.x;
    if (g < G)
      lse[(long long)b * H + kvh * G + g] =
          s_m[threadIdx.x] + logf(s_l[threadIdx.x]);
  }
  for (int x = threadIdx.x; x < GB * D; x += THREADS) {
    const int i = x / D, d = x % D;
    const int g = hg * GB + i;
    if (g >= G) continue;
    float acc = 0.f;
#pragma unroll 8
    for (int cc = 0; cc < n_chunks; ++cc)
      acc = fmaf(w[cc * GB + i],
                 __ldcg(&g_acc[((long long)cc * GB + i) * D + d]), acc);
    store1(out + ((long long)b * H + kvh * G + g) * D + d,
           acc / fmaxf(s_l[i], 1e-30f));
  }
}

template <typename T, int E>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, float* part, int B, int Lk, int H, int KVH,
           float scale, int n_vis, int chunk_len, int n_chunks,
           cudaStream_t stream) {
  // The ring and scores; after them the merge's (m, l) reuse the space.
  const size_t tiles = Shape<T, E>::TILES;
  const size_t merge = (size_t)n_chunks * GB * 2 * 4;
  const size_t smem = tiles > merge ? tiles : merge;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = flash_decode_kernel<T, E>;
  // The opt-in above 48 KB is made once per device and instantiation (so
  // that a launch captured into a CUDA graph makes no such call).
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    allowed[dev] = true;
  }
  const int G = H / KVH;
  const int HG = (G + GB - 1) / GB;
  const size_t groups = (size_t)B * KVH * HG;
  unsigned* counters = reinterpret_cast<unsigned*>(
      part + groups * n_chunks * GB * (Shape<T, E>::D + 2));
  e = cudaMemsetAsync(counters, 0, groups * sizeof(unsigned), stream);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n_chunks, KVH * HG, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, part, counters,
      Lk, H, KVH, HG, scale, n_vis, chunk_len, n_chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int E, const void* q, const void* k, const void* v, void* out,
             float* lse, float* part, int B, int Lk, int H, int KVH,
             float scale, int n_vis, int chunk_len, int n_chunks,
             cudaStream_t s) {
#define FLASH_DECODE_CASE(N)                                                \
  case N:                                                                   \
    return launch<T, N>(q, k, v, out, lse, part, B, Lk, H, KVH, scale,      \
                        n_vis, chunk_len, n_chunks, s);
  switch (E) {
    FLASH_DECODE_CASE(1)
    FLASH_DECODE_CASE(2)
    FLASH_DECODE_CASE(3)
    FLASH_DECODE_CASE(4)
    FLASH_DECODE_CASE(5)
    FLASH_DECODE_CASE(6)
    FLASH_DECODE_CASE(7)
    FLASH_DECODE_CASE(8)
    FLASH_DECODE_CASE(9)
    FLASH_DECODE_CASE(10)
    FLASH_DECODE_CASE(11)
    FLASH_DECODE_CASE(12)
    FLASH_DECODE_CASE(13)
    FLASH_DECODE_CASE(14)
    FLASH_DECODE_CASE(15)
    FLASH_DECODE_CASE(16)
  }
#undef FLASH_DECODE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface (bound with ctypes). dtype 0 is float32, 1 bfloat16; q (B, 1,
// H, D), k and v (B, Lk, KVH, D), out like q, contiguous and 16-byte
// aligned, D a multiple of 16 in [16, 256]; lse null or float32 (B, H),
// each head's log-sum-exp of the visible keys. Keys [0, n_vis) are visible;
// split c covers keys [c chunk_len, (c + 1) chunk_len), n_chunks of them
// (at most 2048). part: float32 scratch of G4 * (n_chunks * 4 * (D + 2) +
// 1) words, G4 = B * KVH * ceil(H / KVH / 4) head groups: the partials, then
// one arrival counter per head group, which the launch zeroes on `stream`.
// Returns a cudaError_t; 0 is success.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   void* part,
                                   int dtype, int B, int Lk, int H, int KVH,
                                   int D, float scale, int n_vis,
                                   int chunk_len, int n_chunks,
                                   void* stream) {
  if (B < 1 || Lk < 1 || KVH < 1 || H < KVH || H % KVH || D % 16 ||
      D < 16 || D > 256 || n_vis < 1 || n_vis > Lk || chunk_len < 1 ||
      n_chunks < 1 || n_chunks > MAX_CHUNKS || B > 65535 ||
      (long long)KVH * ((H / KVH + GB - 1) / GB) > 65535)
    return (int)cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(D / 16, q, k, v, out, l, p, B, Lk, H, KVH, scale,
                           n_vis, chunk_len, n_chunks, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D / 16, q, k, v, out, l, p, B, Lk, H,
                                   KVH, scale, n_vis, chunk_len, n_chunks,
                                   s);
  return (int)cudaErrorInvalidValue;
}

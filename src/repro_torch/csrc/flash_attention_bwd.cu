// Gradient of blocked online-softmax (flash) attention: dq, dk and dv of
// the LM substrate's training forward, grouped-query heads in place.
//
// The reference has no Pallas kernel for it: it differentiates its jnp
// blocked scan (repro/models/attention.py, _run_q_blocks), and its Pallas
// kernel repro/kernels/flash_attention.py::flash_attention has no VJP.
// Given the forward's inputs and output, per head (L queries and keys):
//
//   s   = (q * scale) . k^T in float32; under `causal` a key after its
//         query takes no part
//   P   = softmax(s) = exp(s - lse),  lse = log-sum-exp of the row
//   dv  = P^T . do
//   dP  = do . v^T,  Delta = rowsum(do o o) (= rowsum(P o dP))
//   dS  = P o (dP - Delta)
//   dq  = scale * dS . k,  dk = scale * dS^T . q
//
// with a leading batch axis (q, o, do (B, L, H, D), k/v (B, L, KVH, D)) and
// query head h reading KV head h / (H / KVH); dk and dv sum over the H/KVH
// query heads of each KV head. Inputs are float32 or bf16, the arithmetic
// float32 FMA on the CUDA cores (expf, logf, no fast math), and dq, dk and
// dv are stored in the inputs' dtype.
//
// Design. Two launches on one stream (three at D 192, below), no atomics,
// so every run gives the same bits:
//   flash_bwd_dq_kernel, one CTA of 256 threads per (64-row query block,
//     head, batch). The forward kernels do not keep the log-sum-exp, so a
//     first pass over the visible key blocks recomputes each row's max and
//     sum; Delta comes from do and o. A second pass stages V (for dP) and
//     then K (for s and dq) through one shared buffer, writes dS to a 64x64
//     tile and accumulates dS . K into registers. It writes dq and the
//     rows' (lse, Delta) to a float32 (2, B, H, L) scratch. Query blocks
//     run longest first (under `causal` the last block sees every key).
//   flash_bwd_dkdv_kernel, one CTA per (64-key block, KV head, batch). K
//     and V of the block stay in shared memory; the CTA loops over the
//     group's query heads and over the query blocks that can see its keys
//     (from its own block on, under `causal`), recomputes P^T and dS^T
//     from the scratch's lse and Delta, and accumulates P^T . do and
//     dS^T . (q * scale) in registers: the GQA sum stays inside the CTA.
// Thread (rg, cg) = (tid / 16, tid % 16) owns rows 4rg..4rg+3 of its tile
// and columns cg + 16j (j < 4), as in csrc/flash_attention.cu. Ragged L is
// masked: keys and queries at or past L take no part (their staged rows
// are zero, their P is 0), rows past L are not stored. D is one of 16, 32,
// 64, 80, 96, 128 and 192.
//
// Head dim 192 (nemotron's, float32 training). The dq launch fits as it is
// (4x12 accumulator a thread; (2 . 64 + 64) . 196 + 64 . 68 floats =
// 167,936 B of shared memory). The fused dk/dv launch would not: (2 . 64 +
// 2 . 64) . 196 + 2 . 64 . 68 floats = 235,520 B, over the 232,448 B a
// block may opt into, and two 4x12 accumulators on top of the 254
// registers it takes at D 128. So at 192 it is two launches of the same
// kernel, as csrc/flash_bwd_wgmma.cu does (`part`): dv stages K, q * scale,
// do and P^T (167,936 B) and accumulates P^T . do; dk stages K, V,
// q * scale, do and dS^T (218,112 B) and accumulates dS^T . (q * scale).
// Each recomputes s (and dk also dP) and holds one 4x12 accumulator. The
// row stride of 196 floats keeps every float4 access 16-byte aligned.
//
// Bound on this card. At the training shape (B 1, L 4096, H 24, KVH 8,
// D 128, bf16, causal) the gradient's five products of L^2/2 . D per head
// are 258 GFLOP, 0.261 ms at the 989 TFLOP/s bf16 tensor-core peak, against
// 134 MB of q, k, v, o, do, dq, dk and dv, 0.040 ms at 3.35 TB/s:
// operations bound it. This kernel does eight products (s twice in each
// launch, dP in each) on the CUDA cores at float32 (67 TFLOP/s peak), so it
// sits far above that bound; wgmma tiles fed by TMA, with the forward
// writing the log-sum-exp, are csrc/flash_bwd_wgmma.cu (bf16). In float32
// at nemotron-4-340b's shape (B 1, L 4096, H 96, KVH 8, D 192, causal) the
// five products are 1,547 GFLOP, 23.1 ms at the 67 TFLOP/s float32 FMA
// peak, against 1.31 GB, 0.39 ms: operations bound it there too.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // key rows per tile
constexpr int THREADS = 256;    // 16 row groups x 16 lanes
constexpr int PS = 64 + 4;      // row stride of a 64x64 float tile
// The dk/dv launch's `part`: both gradients, or dv or dk alone (D 192).
constexpr int PART_DKDV = 0, PART_DV = 1, PART_DK = 2;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows [r0, r0 + 64) of one head's (L, D) slice (row stride `stride`
// elements) into shared memory as float32 times `mul`, row stride D + 4;
// rows at or past L are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long stride, int r0, int L, int D,
                                      float mul) {
  const int chunks = D / 4;
  for (int e = threadIdx.x; e < 64 * chunks; e += THREADS) {
    const int r = e / chunks;
    const int c = (e - r * chunks) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < L) {
      x = load4(src + (long long)(r0 + r) * stride + c);
      x.x *= mul;
      x.y *= mul;
      x.z *= mul;
      x.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) = x;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// s[i][j] = A[r0 + i] . B[cg + 16 j] over D, both tiles of row stride DS.
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A,
                                         const float* B, int r0, int cg,
                                         int DS, int D) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (r0 + i) * DS + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (cg + 16 * j) * DS + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        x = fmaf(a[i].x, b[j].x, x);
        x = fmaf(a[i].y, b[j].y, x);
        x = fmaf(a[i].z, b[j].z, x);
        x = fmaf(a[i].w, b[j].w, x);
        s[i][j] = x;
      }
  }
}

// acc[i][t] += sum_{j < jn} P[r0 + i][j] * X[j][cg + 16 t]: P a 64x64 tile
// of row stride PS, X a tile of row stride DS; jn a multiple of 4.
template <int NT>
__device__ __forceinline__ void tile_acc(float (&acc)[4][NT], const float* P,
                                         const float* X, int r0, int cg,
                                         int DS, int nt, int jn) {
  for (int j = 0; j < jn; j += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (r0 + i) * PS + j);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (t < nt) {
        const float* xc = X + j * DS + cg + 16 * t;
        const float x0 = xc[0], x1 = xc[DS], x2 = xc[2 * DS],
                    x3 = xc[3 * DS];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = acc[i][t];
          a = fmaf(p[i].x, x0, a);
          a = fmaf(p[i].y, x1, a);
          a = fmaf(p[i].z, x2, a);
          a = fmaf(p[i].w, x3, a);
          acc[i][t] = a;
        }
      }
    }
  }
}

// NT: the largest D / 16 of the bucket (columns a thread holds per row).
template <typename T, int NT>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout, T* __restrict__ dq,
                        float* __restrict__ stats, int L, int H, int KVH,
                        int D, float scale, int causal) {
  extern __shared__ float4 smem4[];
  const int DS = D + 4;
  float* Qs = reinterpret_cast<float*>(smem4);  // BQ x DS, q * scale
  float* dOs = Qs + BQ * DS;                    // BQ x DS
  float* KVs = dOs + BQ * DS;                   // BK x DS, V then K
  float* Ps = KVs + BK * DS;                    // BQ x PS, dS

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int rg = threadIdx.x >> 4;
  const int cg = threadIdx.x & 15;
  const int r0 = rg * 4;
  const int nt = D / 16;
  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)KVH * D;
  const long long q_off = ((long long)b * L * H + h) * D;
  const T* kh = k + ((long long)b * L * KVH + kvh) * D;
  const T* vh = v + ((long long)b * L * KVH + kvh) * D;

  stage(Qs, q + q_off, q_stride, q0, L, D, scale);
  stage(dOs, dout + q_off, q_stride, q0, L, D, 1.f);

  // Delta of the thread's rows: lanes split the columns, then a shuffle sum.
  float delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + r0 + i;
    float part = 0.f;
    if (r < L) {
      for (int c = cg * 4; c < D; c += 64) {
        const float4 a = load4(o + q_off + r * q_stride + c);
        const float4 g = load4(dout + q_off + r * q_stride + c);
        part = fmaf(a.x, g.x, part);
        part = fmaf(a.y, g.y, part);
        part = fmaf(a.z, g.z, part);
        part = fmaf(a.w, g.w, part);
      }
    }
    delta[i] = half_warp_sum(part);
  }

  const int n_keys = causal ? min(L, q0 + BQ) : L;
  const int n_blocks = (n_keys + BK - 1) / BK;
  const bool live = q0 + r0 < L;

  // Pass 1: each row's max and sum over its visible keys.
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  float s[4][4];
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int k0 = blk * BK;
    __syncthreads();
    stage(KVs, kh, kv_stride, k0, L, D, 1.f);
    __syncthreads();
    tile_dot(s, Qs, KVs, r0, cg, DS, D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + r0 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + cg + 16 * j;
        if (kp < L && !(causal && kp > qp)) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + cg + 16 * j;
        if (kp < L && !(causal && kp > qp)) sum += expf(s[i][j] - m_new);
      }
      sum = half_warp_sum(sum);
      l[i] = (m_new == -INFINITY ? 0.f : l[i] * expf(m[i] - m_new)) + sum;
      m[i] = m_new;
    }
  }
  float lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) lse[i] = m[i] + logf(l[i]);

  // Pass 2: dS and dq.
  float acc[4][NT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[i][t] = 0.f;
  float dp[4][4];
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int k0 = blk * BK;
    __syncthreads();  // the last block's readers of KVs and Ps are done
    stage(KVs, vh, kv_stride, k0, L, D, 1.f);
    __syncthreads();
    tile_dot(dp, dOs, KVs, r0, cg, DS, D);
    __syncthreads();
    stage(KVs, kh, kv_stride, k0, L, D, 1.f);
    __syncthreads();
    tile_dot(s, Qs, KVs, r0, cg, DS, D);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + r0 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + cg + 16 * j;
        const bool vis = live && kp < L && !(causal && kp > qp);
        const float p = vis ? expf(s[i][j] - lse[i]) : 0.f;
        Ps[(r0 + i) * PS + cg + 16 * j] = p * (dp[i][j] - delta[i]);
      }
    }
    __syncthreads();
    if (live) {
      const int jn = (min(BK, L - k0) + 3) & ~3;  // dS and K are 0 past L
      tile_acc<NT>(acc, Ps, KVs, r0, cg, DS, nt, jn);
    }
  }

  const long long n_rows = (long long)gridDim.z * H * L;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + r0 + i;
    if (r >= L) continue;
    T* g = dq + q_off + r * q_stride + cg;
#pragma unroll
    for (int t = 0; t < NT; ++t)
      if (t < nt) store1(g + 16 * t, acc[i][t] * scale);
    if (cg == 0) {
      const long long row = ((long long)b * H + h) * L + r;
      stats[row] = lse[i];
      stats[n_rows + row] = delta[i];
    }
  }
}

// PART: PART_DKDV (both gradients), PART_DV or PART_DK (one of them; the
// other's pointer is unused). Shared memory holds only what the part reads.
template <typename T, int NT, int PART>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ stats, T* __restrict__ dk,
                          T* __restrict__ dv, int L, int H, int KVH, int D,
                          float scale, int causal) {
  constexpr bool WANT_DK = PART != PART_DV;
  constexpr bool WANT_DV = PART != PART_DK;
  extern __shared__ float4 smem4[];
  const int DS = D + 4;
  float* Ks = reinterpret_cast<float*>(smem4);   // BK x DS
  float* Vs = Ks + BK * DS;                      // BK x DS (dk only)
  float* Qs = Vs + (WANT_DK ? BK * DS : 0);      // BQ x DS, q * scale
  float* dOs = Qs + BQ * DS;                     // BQ x DS
  float* Pt = dOs + BQ * DS;                     // BK x PS, P^T (dv only)
  float* dSt = Pt + (WANT_DV ? BK * PS : 0);     // BK x PS, dS^T (dk only)

  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / KVH;
  const int rg = threadIdx.x >> 4;
  const int cg = threadIdx.x & 15;
  const int r0 = rg * 4;
  const int nt = D / 16;
  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)KVH * D;
  const long long kv_off = ((long long)b * L * KVH + kvh) * D;
  const long long n_rows = (long long)gridDim.z * H * L;

  stage(Ks, k + kv_off, kv_stride, k0, L, D, 1.f);
  if constexpr (WANT_DK) stage(Vs, v + kv_off, kv_stride, k0, L, D, 1.f);

  const bool live = k0 + r0 < L;
  // The accumulator a part does not compute is one unused column.
  float dk_acc[4][WANT_DK ? NT : 1], dv_acc[4][WANT_DV ? NT : 1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int t = 0; t < (WANT_DK ? NT : 1); ++t) dk_acc[i][t] = 0.f;
#pragma unroll
    for (int t = 0; t < (WANT_DV ? NT : 1); ++t) dv_acc[i][t] = 0.f;
  }

  const int first = causal ? k0 / BQ : 0;
  const int n_qblocks = (L + BQ - 1) / BQ;
  float s[4][4], dp[4][4];
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const long long q_off = ((long long)b * L * H + h) * D;
    const float* lse_h = stats + ((long long)b * H + h) * L;
    const float* delta_h = lse_h + n_rows;
    for (int qb = first; qb < n_qblocks; ++qb) {
      const int q0 = qb * BQ;
      __syncthreads();  // the last block's readers of Qs, dOs, Pt, dSt
      stage(Qs, q + q_off, q_stride, q0, L, D, scale);
      stage(dOs, dout + q_off, q_stride, q0, L, D, 1.f);
      __syncthreads();
      tile_dot(s, Ks, Qs, r0, cg, DS, D);
      if constexpr (WANT_DK) tile_dot(dp, Vs, dOs, r0, cg, DS, D);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qp = q0 + cg + 16 * j;
        const float lse_j = qp < L ? lse_h[qp] : 0.f;
        float delta_j = 0.f;
        if constexpr (WANT_DK) delta_j = qp < L ? delta_h[qp] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kp = k0 + r0 + i;
          const bool vis = live && qp < L && kp < L && !(causal && kp > qp);
          const float p = vis ? expf(s[i][j] - lse_j) : 0.f;
          if constexpr (WANT_DV) Pt[(r0 + i) * PS + cg + 16 * j] = p;
          if constexpr (WANT_DK)
            dSt[(r0 + i) * PS + cg + 16 * j] = p * (dp[i][j] - delta_j);
        }
      }
      __syncthreads();
      if (live) {
        const int jn = (min(BQ, L - q0) + 3) & ~3;  // P, dS, q, do 0 past L
        if constexpr (WANT_DV)
          tile_acc<NT>(dv_acc, Pt, dOs, r0, cg, DS, nt, jn);
        if constexpr (WANT_DK)
          tile_acc<NT>(dk_acc, dSt, Qs, r0, cg, DS, nt, jn);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + r0 + i;
    if (r >= L) continue;
    const long long off = kv_off + r * kv_stride + cg;
#pragma unroll
    for (int t = 0; t < NT; ++t)
      if (t < nt) {
        if constexpr (WANT_DK) store1(dk + off + 16 * t, dk_acc[i][t]);
        if constexpr (WANT_DV) store1(dv + off + 16 * t, dv_acc[i][t]);
      }
  }
}

// Above 48 KB of shared memory only after an opt-in, made once per device
// and instantiation (so a launch captured into a CUDA graph makes no call).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t (&allowed)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > allowed[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed[dev] = smem;
  }
  return cudaSuccess;
}

template <typename T, int NT>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, void* dq, float* stats, int B, int L, int H,
              int KVH, int D, float scale, int causal, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, NT>;
  const size_t smem =
      (size_t)((2 * BQ + BK) * (D + 4) + BQ * PS) * sizeof(float);
  static size_t allowed[64] = {};
  const cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<T*>(dq), stats, L, H, KVH, D,
      scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int NT, int PART>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const float* stats, void* dk, void* dv,
                int B, int L, int H, int KVH, int D, float scale, int causal,
                cudaStream_t stream) {
  auto kernel = flash_bwd_dkdv_kernel<T, NT, PART>;
  const int kv_tiles = PART == PART_DKDV ? 2 : 1;  // K and V, or K alone
  const int p_tiles = PART == PART_DKDV ? 2 : 1;   // P^T and dS^T, or one
  const int extra = PART == PART_DK ? 1 : 0;       // dk reads V too
  const size_t smem = (size_t)(((kv_tiles + extra) * BK + 2 * BQ) * (D + 4) +
                               p_tiles * BK * PS) *
                      sizeof(float);
  static size_t allowed[64] = {};
  const cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BK - 1) / BK, KVH, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), stats,
      static_cast<T*>(dk), static_cast<T*>(dv), L, H, KVH, D, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dkdv_part(int part, const void* q, const void* k, const void* v,
              const void* dout, const float* stats, void* dk, void* dv,
              int B, int L, int H, int KVH, int D, float scale, int causal,
              cudaStream_t s) {
  if (D > 128) {
    if (part == PART_DV)
      return launch_dkdv<T, 12, PART_DV>(q, k, v, dout, stats, dk, dv, B, L,
                                         H, KVH, D, scale, causal, s);
    if (part == PART_DK)
      return launch_dkdv<T, 12, PART_DK>(q, k, v, dout, stats, dk, dv, B, L,
                                         H, KVH, D, scale, causal, s);
    return (int)cudaErrorInvalidValue;  // D 192 takes dv and dk apart
  }
  if (part != PART_DKDV) return (int)cudaErrorInvalidValue;
  return D <= 64 ? launch_dkdv<T, 4, PART_DKDV>(q, k, v, dout, stats, dk, dv,
                                                B, L, H, KVH, D, scale,
                                                causal, s)
                 : launch_dkdv<T, 8, PART_DKDV>(q, k, v, dout, stats, dk, dv,
                                                B, L, H, KVH, D, scale,
                                                causal, s);
}

bool valid(int B, int L, int H, int KVH, int D) {
  return B >= 1 && L >= 1 && KVH >= 1 && H % KVH == 0 && B <= 65535 &&
         H <= 65535 &&
         (D == 16 || D == 32 || D == 64 || D == 80 || D == 96 || D == 128 ||
          D == 192);
}

}  // namespace

// C interface (bound with ctypes). dtype 0 is float32, 1 bfloat16; q, o,
// dout and dq (B, L, H, D), k and v (B, L, KVH, D), all contiguous and
// 16-byte aligned; stats a float32 (2, B, H, L) scratch. The dq launch
// writes dq and stats (each row's lse, then Delta); the dk/dv launch, on
// the same stream after it, reads them: `part` 0 writes dk and dv (D up to
// 128), 1 dv alone and 2 dk alone (D 192, two launches; the other pointer
// is not read). Each returns a cudaError_t; 0 is success.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, void* dq, void* stats,
                                   int dtype, int B, int L, int H, int KVH,
                                   int D, float scale, int causal,
                                   void* stream) {
  if (!valid(B, L, H, KVH, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (dtype == 0)
    return D <= 64    ? launch_dq<float, 4>(q, k, v, o, dout, dq, st, B, L, H,
                                            KVH, D, scale, causal, s)
           : D <= 128 ? launch_dq<float, 8>(q, k, v, o, dout, dq, st, B, L, H,
                                            KVH, D, scale, causal, s)
                      : launch_dq<float, 12>(q, k, v, o, dout, dq, st, B, L,
                                             H, KVH, D, scale, causal, s);
  if (dtype == 1)
    return D <= 64
               ? launch_dq<__nv_bfloat16, 4>(q, k, v, o, dout, dq, st, B, L,
                                             H, KVH, D, scale, causal, s)
           : D <= 128
               ? launch_dq<__nv_bfloat16, 8>(q, k, v, o, dout, dq, st, B, L,
                                             H, KVH, D, scale, causal, s)
               : launch_dq<__nv_bfloat16, 12>(q, k, v, o, dout, dq, st, B, L,
                                              H, KVH, D, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkdv_launch(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* stats, void* dk, void* dv,
                                     int dtype, int B, int L, int H, int KVH,
                                     int D, float scale, int causal, int part,
                                     void* stream) {
  if (!valid(B, L, H, KVH, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(stats);
  if (dtype == 0)
    return dkdv_part<float>(part, q, k, v, dout, st, dk, dv, B, L, H, KVH, D,
                            scale, causal, s);
  if (dtype == 1)
    return dkdv_part<__nv_bfloat16>(part, q, k, v, dout, st, dk, dv, B, L, H,
                                    KVH, D, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

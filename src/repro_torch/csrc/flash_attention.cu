// Blocked online-softmax (flash) attention for the LM substrate's prefill
// and decode, grouped-query heads in place.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel), whose grid (H, Lq/bq, Lk/bk) runs
// its K axis in order and carries the running max, sum and accumulator in
// VMEM scratch from one grid step to the next. It computes, per head:
//
//   s   = (q * scale) . k^T                 in float32, scale first
//   s   = -1e30 where k_pos > q_pos + kv_offset        (under `causal`)
//   m   = running max, l = running sum of exp(s - m), acc = running
//         exp(s - m) . v, each rescaled by exp(m_old - m_new) per block
//   out = acc / max(l, 1e-30), cast to the input dtype
//
// with two extensions that keep the function per head: a leading batch
// axis (q (B, Lq, H, D), k/v (B, Lk, KVH, D)) and grouped-query heads read
// in place, query head h reading KV head h / (H / KVH) (the head order of
// the reference's q.reshape(b, L, kvh, g, hd)).
//
// Design. One CTA of 256 threads per (64-row query block, head, batch).
// CTAs run in parallel in no order, so the K loop lives inside the CTA: the
// query tile is staged once into shared memory (float32, pre-scaled), and
// each 64-key block of K and then of V goes through one shared buffer.
// Thread (rg, cg) = (tid / 16, tid % 16) owns query rows 4rg..4rg+3: it
// computes their scores against keys cg + 16j (j < 4) with float4 reads
// along D, reduces max and sum over its 16-lane half-warp with shuffles,
// writes exp(s - m) into a 64x64 tile, and accumulates P.V into columns
// cg + 16t (t < D/16) of its rows in registers. Under `causal` the loop
// stops after the last block that a row of the CTA can see; that is exact,
// since a masked term is exp(-1e30 - m) = 0 in float32 and block 0 always
// holds a visible key (kv_offset >= 0). Ragged Lq and Lk are masked by
// bounds checks (keys past Lk take no part; rows past Lq are not stored).
// Arithmetic is float32 FMA for both input dtypes, with expf and IEEE
// division (no fast math). D is a multiple of 16 up to 256; the register
// tile is sized by a bucket of D (64, 128, 192, 256).
//
// Bound on this card. At the LM main path's prefill shape (B 4, L 2048,
// H 24, KVH 8, D 128, bf16, causal) the work is 4*B*H*(L(L+1)/2)*D = 103
// GFLOP, 0.104 ms at the 989 TFLOP/s bf16 tensor-core peak, against 134 MB
// of q, k, v and out, 0.040 ms at 3.35 TB/s: operations bound it. This
// kernel uses the CUDA cores at float32 (67 TFLOP/s peak), so it sits well
// above that bound; wgmma tiles fed by TMA are a later step. At the decode
// shape (Lq 1, Lk 2080) the 34 MB of K/V cache bound it (0.010 ms); there
// a CTA still stages 64 query rows for 1 live one (only the threads of
// live rows compute), and B*H CTAs (96 at batch 4) leave a third of the
// 132 SMs idle: a split-K decode grid is a later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per block of the loop
constexpr int THREADS = 256;    // 16 row groups x 16 lanes
constexpr int PS = BK + 4;      // row stride of the P tile, in floats
constexpr float kNeg = -1e30f;  // the reference's masked score

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
  for (int e = threadIdx.x; e < BQ * chunks; e += THREADS) {
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

// NT: the largest D / 16 of the bucket (columns of the output a thread
// holds per row).
template <typename T, int NT>
__global__ void __launch_bounds__(THREADS, NT <= 8 ? 2 : 1)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int Lq, int Lk, int H, int KVH, int D, float scale,
                           int causal, int kv_offset) {
  extern __shared__ float4 smem4[];
  const int DS = D + 4;
  float* Qs = reinterpret_cast<float*>(smem4);  // BQ x DS
  float* KVs = Qs + BQ * DS;                    // BK x DS, K then V
  float* Ps = KVs + BK * DS;                    // BQ x PS

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int rg = threadIdx.x >> 4;
  const int cg = threadIdx.x & 15;
  const int r0 = rg * 4;
  const int nt = D / 16;
  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)KVH * D;
  const T* qh = q + ((long long)b * Lq * H + h) * D;
  const T* kh = k + ((long long)b * Lk * KVH + kvh) * D;
  const T* vh = v + ((long long)b * Lk * KVH + kvh) * D;

  stage(Qs, qh, q_stride, q0, Lq, D, scale);

  long long n_keys = Lk;
  if (causal) {
    const long long last_q = (long long)min(q0 + BQ, Lq) - 1 + kv_offset;
    n_keys = min(n_keys, last_q + 1);
  }
  const int n_blocks = (int)((n_keys + BK - 1) / BK);
  // Threads whose rows are all past Lq (decode: all but the first row
  // group) skip the products but keep to the barriers and shuffles.
  const bool live = q0 + r0 < Lq;

  float m[4], l[4], acc[4][NT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[i][t] = 0.f;
  }

  for (int blk = 0; blk < n_blocks; ++blk) {
    const int k0 = blk * BK;
    __syncthreads();  // the last block's readers of KVs and Ps are done
    stage(KVs, kh, kv_stride, k0, Lk, D, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    if (live) {
      for (int d = 0; d < D; d += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(Qs + (r0 + i) * DS + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] =
              *reinterpret_cast<const float4*>(KVs + (cg + 16 * j) * DS + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float a = s[i][j];
            a = fmaf(qv[i].x, kv[j].x, a);
            a = fmaf(qv[i].y, kv[j].y, a);
            a = fmaf(qv[i].z, kv[j].z, a);
            a = fmaf(qv[i].w, kv[j].w, a);
            s[i][j] = a;
          }
      }
    }

    // Mask, then the online-softmax update of each row.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long q_pos = (long long)q0 + r0 + i + kv_offset;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + cg + 16 * j;
        if (causal && kp > q_pos) s[i][j] = kNeg;
        if (kp < Lk) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + cg + 16 * j;
        const float p = kp < Lk ? expf(s[i][j] - m_new) : 0.f;
        Ps[(r0 + i) * PS + cg + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[i][t] *= alpha;
    }

    __syncthreads();  // P written, every read of K done
    stage(KVs, vh, kv_stride, k0, Lk, D, 1.f);
    __syncthreads();

    if (live) {
      const int jn = (min(BK, Lk - k0) + 3) & ~3;  // P and V are 0 past Lk
      for (int j = 0; j < jn; j += 4) {
        float4 pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pv[i] = *reinterpret_cast<const float4*>(Ps + (r0 + i) * PS + j);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          if (t < nt) {
            const float* vc = KVs + j * DS + cg + 16 * t;
            const float v0 = vc[0], v1 = vc[DS], v2 = vc[2 * DS],
                        v3 = vc[3 * DS];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float a = acc[i][t];
              a = fmaf(pv[i].x, v0, a);
              a = fmaf(pv[i].y, v1, a);
              a = fmaf(pv[i].z, v2, a);
              a = fmaf(pv[i].w, v3, a);
              acc[i][t] = a;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + r0 + i;
    if (r >= Lq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + (((long long)b * Lq + r) * H + h) * D + cg;
#pragma unroll
    for (int t = 0; t < NT; ++t)
      if (t < nt) store1(o + 16 * t, acc[i][t] / denom);
  }
}

template <typename T, int NT>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Lq, int Lk, int H, int KVH, int D, float scale, int causal,
           int kv_offset, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, NT>;
  const size_t smem = (size_t)((BQ + BK) * (D + 4) + BQ * PS) * sizeof(float);
  // Above 48 KB only after an opt-in, made once per device and
  // instantiation (so a launch captured into a CUDA graph makes no call).
  static size_t allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > allowed[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = smem;
  }
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Lq, Lk, H, KVH, D,
      scale, causal, kv_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int Lq, int Lk, int H, int KVH, int D, float scale, int causal,
             int kv_offset, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 4>(q, k, v, out, B, Lq, Lk, H, KVH, D, scale, causal,
                        kv_offset, stream);
  if (D <= 128)
    return launch<T, 8>(q, k, v, out, B, Lq, Lk, H, KVH, D, scale, causal,
                        kv_offset, stream);
  if (D <= 192)
    return launch<T, 12>(q, k, v, out, B, Lq, Lk, H, KVH, D, scale, causal,
                         kv_offset, stream);
  return launch<T, 16>(q, k, v, out, B, Lq, Lk, H, KVH, D, scale, causal,
                       kv_offset, stream);
}

}  // namespace

// C interface (bound with ctypes). dtype 0 is float32, 1 bfloat16; q
// (B, Lq, H, D), k and v (B, Lk, KVH, D), out like q, all contiguous and
// 16-byte aligned. Returns a cudaError_t; 0 is success.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int B, int Lq, int Lk, int H, int KVH,
                                      int D, float scale, int causal,
                                      int kv_offset, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || KVH < 1 || H % KVH || D % 16 || D < 16 ||
      D > 256 || kv_offset < 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, Lq, Lk, H, KVH, D, scale, causal,
                           kv_offset, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, Lq, Lk, H, KVH, D, scale,
                                   causal, kv_offset, s);
  return (int)cudaErrorInvalidValue;
}

// Flash attention prefill in float32 on Hopper's tensor cores: q, k, v
// float32 with head dim 64, 80, 96, 128 or 192, every product taken as
// three TF32 passes (3xTF32, csrc/tf32x3.cuh), so the float32 paths keep
// float32's accuracy.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel, pallas_call at :83) for the float32
// prefill shapes; `kernels/flash_attention.py::route` sends float32 calls
// with Lq > 1 and D in {64, 80, 96, 128, 192} here (the `tf32x3` route).
// It computes what csrc/flash_attention.cu (the `simt` route) computes,
// per head:
//
//   s   = (q * scale) . k^T                 in float32, scale first
//   s   = -1e30 where k_pos > q_pos + kv_offset        (under `causal`)
//   online softmax over key blocks (running max m, running sum l of
//   exp(s - m), acc of exp(s - m) . v, rescaled by exp(m_old - m_new))
//   out = acc / max(l, 1e-30)
//
// with a batch axis (q (B, Lq, H, D), k/v (B, Lk, KVH, D)) and grouped-query
// heads read in place (query head h reads KV head h / (H / KVH)); given a
// float32 (B, H, Lq) `lse`, each row's natural log-sum-exp m + log l is
// written there (the training forward's, which csrc/flash_bwd_tf32x3.cu
// reads), as csrc/flash_prefill_wgmma.cu writes it.
//
// Instruction family. mma.sync.m16n8k8 with TF32 operands, each product
// three passes (lo . hi, hi . lo, hi . hi), a block's passes into a zeroed
// float32 accumulator that is then added to the running one.
// wgmma takes TF32 only K-major from shared memory (the transpose bits are
// for 16-bit types), so O = P . V, whose B operand V runs along the keys,
// would need a transposed copy of V or P staged through shared memory;
// mma.sync's fragments are loaded by each thread from shared memory in
// either orientation and split into hi and lo in registers, and P's
// accumulator layout feeds the next product with no shuffle (the summed
// axis permuted inside each slice of 8, tf32x3.cuh). Simpler, at a lower
// peak than wgmma's.
//
// Bound on this card. nemotron-4-340b's float32 attention (B 1, L 4096,
// H 96, KVH 8, D 192, causal): 4 . B . H . L(L+1)/2 . D = 619 GFLOP, 1.25
// ms at the 495 TFLOP/s TF32 tensor-core peak for one pass, 3.75 ms for
// three (9.23 ms at the 67 TFLOP/s float32 peak of the CUDA cores), against
// 0.35 GB of q, k, v and out (0.10 ms at 3.35 TB/s): operations bound it.
// llama's (H 24, KVH 8, D 128) is 0.63 ms for three passes (1.54 ms at 67
// TFLOP/s).
//
// Design. One CTA of 8 warps per (128 query rows, head, batch); a warp
// owns 16 rows. The query tile is staged once, times scale, in float32
// (128 x (D + 4) floats); K and V blocks of 64 keys stream through one
// buffer each by cp.async (zero-filled past Lk), V of a block in flight
// while S = Q . K^T is computed and K of the next one while O += P . V is.
// A warp's S (16 x 64) and O (16 x D) live in registers (32 and D / 2
// floats a thread); the mask applies only on a block that holds a key past
// Lk or past the causal limit of the warp's first row, and a warp skips a
// block wholly after its rows (exact: such a block adds exp(-1e30 - m) = 0
// and rescales by 1, as block 0 always holds a visible key). The softmax is
// float32 with expf (no fast math: ex2.approx would spend the limits'
// margin); each thread keeps its share of l and the four lanes of a row
// add them at the end. Query blocks run longest first. Rows past Lq are
// not stored. Shared memory (128 + 2 . 64) . (D + 4) . 4 bytes: 200,704 B
// at D 192, 135,168 at 128, 102,400 at 96, 86,016 at 80, 69,632 at 64.
// Registers (nvcc 12.8's ptxas for sm_90a, -Xptxas=-v;
// kernels/_build.py::build_log): 217, 224, 238, 254, 255 at D 64, 80, 96,
// 128, 192, 0 spill: one CTA an SM.
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = 16 * WARPS;   // query rows per CTA
constexpr int BK = 64;           // keys per block of the loop
constexpr float kNeg = -1e30f;   // the reference's masked score

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_prefill_tf32x3_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                float* __restrict__ out,
                                float* __restrict__ lse, int Lq, int Lk,
                                int H, int KVH, float scale, int causal,
                                int kv_offset) {
  constexpr int S = D + 4;    // row stride of every tile, in floats
  constexpr int NT = D / 8;   // n tiles of O
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // BQ x S, q * scale
  float* Ks = Qs + BQ * S;                      // BK x S
  float* Vs = Ks + BK * S;                      // BK x S

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int w0 = warp * 16;  // the warp's first row in the tile
  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)KVH * D;
  const float* qh = q + ((long long)b * Lq * H + h) * D;
  const float* kh = k + ((long long)b * Lk * KVH + kvh) * D;
  const float* vh = v + ((long long)b * Lk * KVH + kvh) * D;

  long long n_keys = Lk;
  if (causal)
    n_keys = min(n_keys, (long long)min(q0 + BQ, Lq) + kv_offset);
  const int n_blocks = (int)((n_keys + BK - 1) / BK);

  stage_async<BK, D, THREADS>(Ks, kh, kv_stride, 0, Lk);
  cp_async_commit();
  for (int e = threadIdx.x; e < BQ * (D / 4); e += THREADS) {
    const int r = e / (D / 4);
    const int c = (e - r * (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Lq) {
      x = *reinterpret_cast<const float4*>(qh + (q0 + r) * q_stride + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(Qs + r * S + c) = x;
  }

  const int row0 = q0 + w0 + g;  // the thread's rows: row0 and row0 + 8
  const bool warp_live = q0 + w0 < Lq;
  // The last key a row of the warp can see under `causal`.
  const long long warp_last = (long long)q0 + w0 + 15 + kv_offset;

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};  // the thread's share of each row's sum

  for (int blk = 0; blk < n_blocks; ++blk) {
    const int k0 = blk * BK;
    stage_async<BK, D, THREADS>(Vs, vh, kv_stride, k0, Lk);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // K of this block (and the query tile) in place

    const bool active = warp_live && !(causal && k0 > warp_last);
    float s[8][4];
    if (active) {
      tile_abt<S, D>(s, Qs, w0, Ks, g, t);
      if (k0 + BK > Lk || (causal && k0 + BK - 1 > warp_last - 15)) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + 8 * j + 2 * t + (e & 1);
            const long long qp = (long long)row0 + (e >> 1) * 8 + kv_offset;
            if (causal && kp > qp) s[j][e] = kNeg;
            if (kp >= Lk) s[j][e] = -INFINITY;  // no part in max or sum
          }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = quad_max(mx[i]);
        alpha[i] = expf(m[i] - mx[i]);
        m[i] = mx[i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - mx[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
    }

    __syncthreads();  // every warp is done with K
    if (blk + 1 < n_blocks) {
      stage_async<BK, D, THREADS>(Ks, kh, kv_stride, k0 + BK, Lk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // V of this block in place

    if (active) acc_cb<S, NT>(o, s, Vs, g, t);
    __syncthreads();  // every warp is done with V
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = quad_sum(l[i]);
    const int r = row0 + 8 * i;
    if (r >= Lq) continue;
    const float denom = fmaxf(li, 1e-30f);
    float* orow = out + (((long long)b * Lq + r) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(o[n][2 * i] / denom, o[n][2 * i + 1] / denom);
    if (lse != nullptr && t == 0)
      lse[((long long)b * H + h) * Lq + r] = m[i] + logf(li);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* out,
           float* lse, int B, int Lq, int Lk, int H, int KVH, float scale,
           int causal, int kv_offset, cudaStream_t stream) {
  auto kernel = flash_prefill_tf32x3_kernel<D>;
  const size_t smem = (size_t)(BQ + 2 * BK) * (D + 4) * sizeof(float);
  static size_t allowed[64] = {};
  const cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(q, k, v, out, lse, Lq, Lk, H, KVH,
                                          scale, causal, kv_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes): float32 q (B, Lq, H, D), k and v (B, Lk,
// KVH, D), out like q, all contiguous and 16-byte aligned; D 64, 80, 96,
// 128 or 192; lse a float32 (B, H, Lq) output of each row's natural
// log-sum-exp, or null. Returns a cudaError_t; 0 is success.
extern "C" int flash_prefill_tf32x3_launch(const void* q, const void* k,
                                           const void* v, void* out,
                                           void* lse, int B, int Lq, int Lk,
                                           int H, int KVH, int D, float scale,
                                           int causal, int kv_offset,
                                           void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || KVH < 1 || H % KVH || kv_offset < 0 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* o = static_cast<float*>(out);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(qf, kf, vf, o, l, B, Lq, Lk, H, KVH, scale, causal,
                        kv_offset, s);
    case 80:
      return launch<80>(qf, kf, vf, o, l, B, Lq, Lk, H, KVH, scale, causal,
                        kv_offset, s);
    case 96:
      return launch<96>(qf, kf, vf, o, l, B, Lq, Lk, H, KVH, scale, causal,
                        kv_offset, s);
    case 128:
      return launch<128>(qf, kf, vf, o, l, B, Lq, Lk, H, KVH, scale, causal,
                         kv_offset, s);
    case 192:
      return launch<192>(qf, kf, vf, o, l, B, Lq, Lk, H, KVH, scale, causal,
                         kv_offset, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

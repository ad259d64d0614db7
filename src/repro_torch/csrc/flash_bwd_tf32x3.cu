// Gradient of flash attention in float32 on Hopper's tensor cores: q, k, v,
// o and do float32 with head dim 64, 80, 96, 128 or 192, every product
// taken as three TF32 passes (3xTF32, csrc/tf32x3.cuh), reading the
// log-sum-exp that the forward (csrc/flash_prefill_tf32x3.cu) wrote.
//
// Replaces no TPU kernel: the reference differentiates its jnp blocked
// scan (repro/models/attention.py, _run_q_blocks), and its Pallas kernel
// repro/kernels/flash_attention.py::flash_attention has no VJP. It is the
// `tf32x3` route of the backward (`kernels/flash_attention.py::route_bwd`:
// float32, L > 1, D in {64, 80, 96, 128, 192}); csrc/flash_attention_bwd.cu
// (the `simt` route) keeps D 16 and 32. Per head, with lse the forward's
// natural log-sum-exp of each query row:
//
//   s   = (q * scale) . k^T in float32; under `causal` a key after its
//         query takes no part
//   P   = exp(s - lse)
//   dv  = P^T . do
//   dP  = do . v^T,  Delta = rowsum(do o o)
//   dS  = P o (dP - Delta)
//   dq  = scale * dS . k,  dk = scale * dS^T . q
//
// with a batch axis (q, o, do (B, L, H, D), k/v (B, L, KVH, D)) and query
// head h reading KV head h / (H / KVH); dk and dv sum over the H/KVH query
// heads of each KV head. The softmax is float32 with expf (no fast math).
//
// Instruction family: mma.sync.m16n8k8 with TF32 operands, three passes a
// product, as in the forward (csrc/flash_prefill_tf32x3.cu says why not
// wgmma: here dq = dS . K, dk = dS^T . Q and dv = P^T . dO all read their
// B operand along the summed axis, which TF32 wgmma cannot). dS and P^T
// feed their products from registers, no shuffle (tf32x3.cuh).
//
// Bound on this card. nemotron-4-340b's float32 attention (B 1, L 4096,
// H 96, KVH 8, D 192, causal): the five products of L(L+1)/2 . D a head
// are 1.5466 TFLOP, 3.12 ms at the 495 TFLOP/s TF32 peak for one pass,
// 9.37 ms for three (23.08 ms at the 67 TFLOP/s float32 peak of the CUDA
// cores), against 1.31 GB (0.39 ms at 3.35 TB/s): operations bound it.
// llama's (H 24, KVH 8, D 128) is 1.56 ms for three passes (3.85 ms at 67
// TFLOP/s). This design does seven products (s in both launches), eight
// at D 192 (s in all three, dP in two).
//
// Design. Two launches on one stream (three at D 192), no atomics, so
// every run gives the same bits. A warp owns 16 rows of its tile; K, V, Q
// and dO tiles are float32 rows of D + 4 floats in shared memory, filled by
// cp.async (zero past L).
//   flash_bwd_tf32x3_dq_kernel, one CTA per (16 . WARPS query rows, head,
//     batch): 8 warps, 4 at D 192. Q (times scale) and dO of the rows are
//     staged once; each row's Delta is summed from o and do in global
//     memory and written to a float32 (B, H, L) scratch for the second
//     launch. Blocks of 64 keys: dP = dO . V^T (V of the block in place),
//     then the next block's V goes in flight while S = Q . K^T, P =
//     exp(s - lse) (no pass over the keys for the max: the forward's lse),
//     dS = P o (dP - Delta) and dQ += dS . K run, and the next block's K
//     while the next dP runs. dQ (D / 2 floats a thread), S and dP (32
//     each) live in registers. Query blocks run longest first.
//   flash_bwd_tf32x3_dkdv_kernel, one CTA per (16 . WARPS keys, KV head,
//     batch): 8 warps, 4 for D 192's dk. K (and V) of the block are staged
//     once; the CTA loops over the group's query heads and the blocks of
//     64 queries that can see its keys (from its own block on, under
//     `causal`), staging Q and dO (each by cp.async, Q's copy waited on
//     first) and the rows' lse and Delta. Per block: S^T = K . (Q .
//     scale)^T, P^T = exp(S^T - lse), dV += P^T . dO; dP^T = V . dO^T,
//     dS^T = P^T o (dP^T - Delta), dK += dS^T . Q (times scale at the
//     end). dK and dV stay in registers for the whole loop: the GQA sum
//     stays inside the CTA.
//   At D 192 dK and dV are 96 floats each a thread; with S^T and dP^T they
//     pass what a thread can hold, so the second launch is two of the same
//     kernel (`part`), as on the other routes: dv (S^T, P^T, dV; V not
//     staged) and dk (S^T, dP^T, dS^T, dK).
// Causal: a warp skips a block wholly on the far side of its rows' limit;
// only blocks that cross it (and a ragged last block) are masked.
// Shared memory, the tiles of D + 4 floats a row and the rows' lse and
// Delta: dq 203,264 B at D 128, 200,960 at 192 (4 warps); dk/dv 203,264
// at 128; dv 201,216 and dk 201,216 at 192. Registers (nvcc 12.8's ptxas
// for sm_90a, -Xptxas=-v; kernels/_build.py::build_log): dq 197, 223,
// 241, 255, 255 at D 64, 80, 96, 128, 192 (68 spill bytes, stores and
// loads, at 192, else 0); dk/dv 254, 255, 255, 255 at D 64-128 (1,000
// spill bytes at 128, 8 at 96); dv and dk at 192 255 each (8 and 0).
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int BK = 64;   // keys per block of the dq launch
constexpr int BQ2 = 64;  // queries per block of the dk/dv launch
// The dk/dv launch's `part`: both gradients, or dv or dk alone (D 192).
constexpr int PART_DKDV = 0, PART_DV = 1, PART_DK = 2;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__host__ __device__ constexpr int dq_warps() {
  return D == 192 ? 4 : 8;
}

template <int D, int PART>
__host__ __device__ constexpr int dkdv_warps() {
  return D == 192 && PART == PART_DK ? 4 : 8;
}

template <int D>
__global__ void __launch_bounds__(dq_warps<D>() * 32, 1)
    flash_bwd_tf32x3_dq_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ o,
                               const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               float* __restrict__ dq,
                               float* __restrict__ delta, int L, int H,
                               int KVH, float scale, int causal) {
  constexpr int WARPS = dq_warps<D>();
  constexpr int THREADS = WARPS * 32;
  constexpr int BQ = 16 * WARPS;
  constexpr int S = D + 4;
  constexpr int NT = D / 8;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // BQ x S, q * scale
  float* dOs = Qs + BQ * S;                     // BQ x S
  float* Ks = dOs + BQ * S;                     // BK x S
  float* Vs = Ks + BK * S;                      // BK x S
  float* Ds = Vs + BK * S;                      // BQ, Delta of the rows

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int w0 = warp * 16;
  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)KVH * D;
  const long long q_off = ((long long)b * L * H + h) * D;
  const float* kh = k + ((long long)b * L * KVH + kvh) * D;
  const float* vh = v + ((long long)b * L * KVH + kvh) * D;
  const long long row_off = ((long long)b * H + h) * L;  // of lse, Delta

  const int n_keys = causal ? min(L, q0 + BQ) : L;
  const int n_blocks = (n_keys + BK - 1) / BK;

  stage_async<BQ, D, THREADS>(dOs, dout + q_off, q_stride, q0, L);
  stage_async<BK, D, THREADS>(Vs, vh, kv_stride, 0, L);
  cp_async_commit();
  stage_async<BK, D, THREADS>(Ks, kh, kv_stride, 0, L);
  cp_async_commit();
  for (int e = threadIdx.x; e < BQ * (D / 4); e += THREADS) {
    const int r = e / (D / 4);
    const int c = (e - r * (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < L) {
      x = *reinterpret_cast<const float4*>(q + q_off + (q0 + r) * q_stride +
                                           c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(Qs + r * S + c) = x;
  }
  // Delta of the warp's 16 rows: the lanes split the columns.
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + w0 + r;
    float part = 0.f;
    if (row < L) {
      for (int c = lane * 4; c < D; c += 128) {
        const float4 a =
            *reinterpret_cast<const float4*>(o + q_off + row * q_stride + c);
        const float4 gd = *reinterpret_cast<const float4*>(
            dout + q_off + row * q_stride + c);
        part = fmaf(a.x, gd.x, part);
        part = fmaf(a.y, gd.y, part);
        part = fmaf(a.z, gd.z, part);
        part = fmaf(a.w, gd.w, part);
      }
    }
    part = warp_sum(part);
    if (lane == 0) {
      Ds[w0 + r] = part;
      if (row < L) delta[row_off + row] = part;
    }
  }
  __syncwarp();

  const int row0 = q0 + w0 + g;  // the thread's rows: row0 and row0 + 8
  float lse_r[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    lse_r[i] = r < L ? lse[row_off + r] : 0.f;
    dl[i] = Ds[w0 + g + 8 * i];
  }
  const bool warp_live = q0 + w0 < L;
  const int warp_last = q0 + w0 + 15;  // the last key the warp can see

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int blk = 0; blk < n_blocks; ++blk) {
    const int k0 = blk * BK;
    cp_async_wait<1>();
    __syncthreads();  // V of this block (and dO, Q) in place
    const bool active = warp_live && !(causal && k0 > warp_last);
    float dp[8][4];
    if (active) tile_abt<S, D>(dp, dOs, w0, Vs, g, t);
    __syncthreads();  // every warp is done with V
    if (blk + 1 < n_blocks) {
      stage_async<BK, D, THREADS>(Vs, vh, kv_stride, k0 + BK, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // K of this block in place

    if (active) {
      float s[8][4];
      tile_abt<S, D>(s, Qs, w0, Ks, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + 2 * t + (e & 1);
          const int qp = row0 + 8 * (e >> 1);
          const bool vis = qp < L && kp < L && !(causal && kp > qp);
          const float p = vis ? expf(s[j][e] - lse_r[e >> 1]) : 0.f;
          s[j][e] = p * (dp[j][e] - dl[e >> 1]);
        }
      acc_cb<S, NT>(acc, s, Ks, g, t);
    }
    __syncthreads();  // every warp is done with K
    if (blk + 1 < n_blocks) {
      stage_async<BK, D, THREADS>(Ks, kh, kv_stride, k0 + BK, L);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= L) continue;
    float* grow = dq + q_off + r * q_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(grow + 8 * n) =
          make_float2(acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
}

// PART: PART_DKDV (both gradients), PART_DV or PART_DK (one of them; the
// other's pointer is unused). Shared memory holds only what the part reads.
template <int D, int PART>
__global__ void __launch_bounds__(dkdv_warps<D, PART>() * 32, 1)
    flash_bwd_tf32x3_dkdv_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 const float* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 float* __restrict__ dk,
                                 float* __restrict__ dv, int L, int H,
                                 int KVH, float scale, int causal) {
  constexpr bool WANT_DK = PART != PART_DV;
  constexpr bool WANT_DV = PART != PART_DK;
  constexpr int WARPS = dkdv_warps<D, PART>();
  constexpr int THREADS = WARPS * 32;
  constexpr int BKR = 16 * WARPS;  // keys per CTA
  constexpr int S = D + 4;
  constexpr int NT = D / 8;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // BKR x S
  float* Vs = Ks + BKR * S;                     // BKR x S (dk only)
  float* Qs = Vs + (WANT_DK ? BKR * S : 0);     // BQ2 x S
  float* dOs = Qs + BQ2 * S;                    // BQ2 x S
  float* Ls = dOs + BQ2 * S;                    // BQ2, lse of the rows
  float* Ds = Ls + BQ2;                         // BQ2, Delta (dk only)

  const int k0 = blockIdx.x * BKR;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / KVH;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int w0 = warp * 16;
  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)KVH * D;
  const long long kv_off = ((long long)b * L * KVH + kvh) * D;

  stage_async<BKR, D, THREADS>(Ks, k + kv_off, kv_stride, k0, L);
  if constexpr (WANT_DK)
    stage_async<BKR, D, THREADS>(Vs, v + kv_off, kv_stride, k0, L);
  cp_async_commit();

  const int key0 = k0 + w0 + g;  // the thread's keys: key0 and key0 + 8
  const bool warp_live = k0 + w0 < L;
  // The accumulator a part does not compute is one unused n tile.
  float dk_acc[WANT_DK ? NT : 1][4], dv_acc[WANT_DV ? NT : 1][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int n = 0; n < (WANT_DK ? NT : 1); ++n) dk_acc[n][e] = 0.f;
#pragma unroll
    for (int n = 0; n < (WANT_DV ? NT : 1); ++n) dv_acc[n][e] = 0.f;
  }

  const int first = causal ? k0 / BQ2 : 0;
  const int n_qblocks = (L + BQ2 - 1) / BQ2;
  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const long long q_off = ((long long)b * L * H + h) * D;
    const long long row_off = ((long long)b * H + h) * L;
    for (int qb = first; qb < n_qblocks; ++qb) {
      const int q0 = qb * BQ2;
      __syncthreads();  // every warp is done with the last block's tiles
      stage_async<BQ2, D, THREADS>(Qs, q + q_off, q_stride, q0, L);
      cp_async_commit();
      stage_async<BQ2, D, THREADS>(dOs, dout + q_off, q_stride, q0, L);
      cp_async_commit();
      for (int i = threadIdx.x; i < BQ2; i += THREADS) {
        const bool in = q0 + i < L;
        Ls[i] = in ? lse[row_off + q0 + i] : 0.f;
        if constexpr (WANT_DK) Ds[i] = in ? delta[row_off + q0 + i] : 0.f;
      }
      cp_async_wait<1>();
      __syncthreads();  // K (V), Q, lse and Delta in place

      // Some query of the block sees some key of the warp.
      const bool active = warp_live && !(causal && q0 + BQ2 - 1 < k0 + w0);
      float st[8][4];  // S^T, then P^T: the warp's 16 keys x 64 queries
      if (active) {
        tile_abt<S, D>(st, Ks, w0, Qs, g, t, scale);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + 2 * t + (e & 1);
            const int qp = q0 + c;
            const int kp = key0 + 8 * (e >> 1);
            const bool vis = qp < L && kp < L && !(causal && kp > qp);
            st[j][e] = vis ? expf(st[j][e] - Ls[c]) : 0.f;
          }
      }
      cp_async_wait<0>();
      __syncthreads();  // dO in place

      if (active) {
        float dpt[8][4];  // dP^T, then dS^T
        if constexpr (WANT_DK) {
          tile_abt<S, D>(dpt, Vs, w0, dOs, g, t);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dpt[j][e] = st[j][e] * (dpt[j][e] - Ds[8 * j + 2 * t + (e & 1)]);
        }
        if constexpr (WANT_DV) acc_cb<S, NT>(dv_acc, st, dOs, g, t);
        if constexpr (WANT_DK) acc_cb<S, NT>(dk_acc, dpt, Qs, g, t);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = key0 + 8 * i;
    if (r >= L) continue;
    const long long off = kv_off + r * kv_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if constexpr (WANT_DK)
        *reinterpret_cast<float2*>(dk + off + 8 * n) = make_float2(
            dk_acc[n][2 * i] * scale, dk_acc[n][2 * i + 1] * scale);
      if constexpr (WANT_DV)
        *reinterpret_cast<float2*>(dv + off + 8 * n) =
            make_float2(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v, const float* o,
              const float* dout, const float* lse, float* dq, float* delta,
              int B, int L, int H, int KVH, float scale, int causal,
              cudaStream_t stream) {
  constexpr int WARPS = dq_warps<D>();
  auto kernel = flash_bwd_tf32x3_dq_kernel<D>;
  const size_t smem =
      ((size_t)(2 * 16 * WARPS + 2 * BK) * (D + 4) + 16 * WARPS) *
      sizeof(float);
  static size_t allowed[64] = {};
  const cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + 16 * WARPS - 1) / (16 * WARPS), H, B);
  kernel<<<grid, WARPS * 32, smem, stream>>>(q, k, v, o, dout, lse, dq, delta,
                                             L, H, KVH, scale, causal);
  return (int)cudaGetLastError();
}

template <int D, int PART>
int launch_dkdv(const float* q, const float* k, const float* v,
                const float* dout, const float* lse, const float* delta,
                float* dk, float* dv, int B, int L, int H, int KVH,
                float scale, int causal, cudaStream_t stream) {
  constexpr int WARPS = dkdv_warps<D, PART>();
  constexpr int kv_tiles = PART == PART_DV ? 1 : 2;  // K, or K and V
  auto kernel = flash_bwd_tf32x3_dkdv_kernel<D, PART>;
  const size_t smem =
      ((size_t)(kv_tiles * 16 * WARPS + 2 * BQ2) * (D + 4) + 2 * BQ2) *
      sizeof(float);
  static size_t allowed[64] = {};
  const cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + 16 * WARPS - 1) / (16 * WARPS), KVH, B);
  kernel<<<grid, WARPS * 32, smem, stream>>>(q, k, v, dout, lse, delta, dk, dv,
                                             L, H, KVH, scale, causal);
  return (int)cudaGetLastError();
}

bool valid(int B, int L, int H, int KVH) {
  return B >= 1 && L >= 1 && KVH >= 1 && H % KVH == 0 && B <= 65535 &&
         H <= 65535;
}

}  // namespace

// C interface (bound with ctypes): float32 q, o, dout and dq (B, L, H, D),
// k and v (B, L, KVH, D), all contiguous and 16-byte aligned; D 64, 80, 96,
// 128 or 192; lse the forward's float32 (B, H, L) log-sum-exp; delta a
// float32 (B, H, L) scratch. The dq launch writes dq and delta; the dk/dv
// launch, on the same stream after it, reads lse and delta: `part` 0
// writes dk and dv (D up to 128), 1 dv alone and 2 dk alone (D 192, two
// launches; the other pointer is not read). Each returns a cudaError_t; 0
// is success.
extern "C" int flash_bwd_tf32x3_dq_launch(const void* q, const void* k,
                                          const void* v, const void* o,
                                          const void* dout, const void* lse,
                                          void* dq, void* delta, int B, int L,
                                          int H, int KVH, int D, float scale,
                                          int causal, void* stream) {
  if (!valid(B, L, H, KVH)) return (int)cudaErrorInvalidValue;
  const float* a[6] = {static_cast<const float*>(q),
                       static_cast<const float*>(k),
                       static_cast<const float*>(v),
                       static_cast<const float*>(o),
                       static_cast<const float*>(dout),
                       static_cast<const float*>(lse)};
  float* g = static_cast<float*>(dq);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dq<64>(a[0], a[1], a[2], a[3], a[4], a[5], g, dl, B, L, H,
                           KVH, scale, causal, s);
    case 80:
      return launch_dq<80>(a[0], a[1], a[2], a[3], a[4], a[5], g, dl, B, L, H,
                           KVH, scale, causal, s);
    case 96:
      return launch_dq<96>(a[0], a[1], a[2], a[3], a[4], a[5], g, dl, B, L, H,
                           KVH, scale, causal, s);
    case 128:
      return launch_dq<128>(a[0], a[1], a[2], a[3], a[4], a[5], g, dl, B, L,
                            H, KVH, scale, causal, s);
    case 192:
      return launch_dq<192>(a[0], a[1], a[2], a[3], a[4], a[5], g, dl, B, L,
                            H, KVH, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_bwd_tf32x3_dkdv_launch(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const void* lse,
                                            const void* delta, void* dk,
                                            void* dv, int B, int L, int H,
                                            int KVH, int D, float scale,
                                            int causal, int part,
                                            void* stream) {
  if (!valid(B, L, H, KVH)) return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* gk = static_cast<float*>(dk);
  float* gv = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 192) {
    if (part == PART_DV)
      return launch_dkdv<192, PART_DV>(qf, kf, vf, df, lf, dl, gk, gv, B, L,
                                       H, KVH, scale, causal, s);
    if (part == PART_DK)
      return launch_dkdv<192, PART_DK>(qf, kf, vf, df, lf, dl, gk, gv, B, L,
                                       H, KVH, scale, causal, s);
    return (int)cudaErrorInvalidValue;  // D 192 takes dv and dk apart
  }
  if (part != PART_DKDV) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch_dkdv<64, PART_DKDV>(qf, kf, vf, df, lf, dl, gk, gv, B, L,
                                        H, KVH, scale, causal, s);
    case 80:
      return launch_dkdv<80, PART_DKDV>(qf, kf, vf, df, lf, dl, gk, gv, B, L,
                                        H, KVH, scale, causal, s);
    case 96:
      return launch_dkdv<96, PART_DKDV>(qf, kf, vf, df, lf, dl, gk, gv, B, L,
                                        H, KVH, scale, causal, s);
    case 128:
      return launch_dkdv<128, PART_DKDV>(qf, kf, vf, df, lf, dl, gk, gv, B, L,
                                         H, KVH, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

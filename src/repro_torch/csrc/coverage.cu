// Max-k-cover marginal-gain counts, summed over the pool's batches, for one
// or several active masks per batch.
//
// Replaces the Pallas kernel repro/kernels/coverage.py::cover_counts (body
// _coverage_kernel), which the reference vmaps over B batches
// (kernels/ops.py::cover_counts_batched), then sums on the host graph
// (core/imm.py:217), and maps over Q query slots for the serving engine's
// marginal gains (serve/influence/engine.py:109-113). Both the sum over B
// and the map over Q are fused here:
//
//   counts[q, v] = sum_b sum_w popc(visited[b, v, w] & active[b, q, w])
//
// for Q >= 1 masks, reading each visited word once per launch (per eight
// masks: a launch of Q > 8 walks the stack once per group of eight).
//
// Design. The kernel is bound by the bytes of visited (B*V*W*4; 33.5 MB at
// the pool's (64, 65,536, 2)), so it is shaped for the card's bandwidth:
//   - a thread owns kVerts consecutive vertices, kWords = lcm(W, 4) words
//     of each batch's flat (V*W) slab, read as 16-byte loads (at W = 2 a
//     uint4 covers two vertices); where a slab is not 16-byte aligned
//     (V*W not a multiple of 4, or an offset base) a thread owns one vertex
//     and reads its W words one by one;
//   - it issues the loads of kStep batches (about kInFlight 16-byte loads)
//     before it counts any of them, so many bytes are in flight per SM;
//   - the CTA stages its batches' active words (kStage batches x 8 masks x
//     W words at a time) in shared memory, so each is read from device
//     memory once per CTA, not once per vertex;
//   - B is split over gridDim.y into as many batch ranges as one wave of
//     resident CTAs holds (at (64, 65,536, 2): 8 ranges, 1,024 CTAs, ~7.8
//     a SM; on the H100 a sweep found one wave 4-7% faster than two, and
//     one range 2x slower); the ranges' partial sums meet in counts with
//     atomicAdd after the launcher zeroes counts on the stream (integer
//     addition, so the result is exact and does not depend on the order).
//     A launch of one range stores its sums and needs no zeroing.
// The int32 sum is exact (at most 32*W*B per vertex).
//
// Bound. B*V*W*4 bytes read, Q*V*4 written, against 3 integer operations
// per (word, mask): bytes bound it at Q = 1; at Q = 8 the popcounts (16 a
// clock on an SM) come close.
#include <cuda_runtime.h>
#include <stdint.h>

#include "words.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQMax = 8;     // active masks per grid z step
constexpr int kStage = 64;   // batches of active words staged at a time
constexpr int kInFlight = 8;  // 16-byte loads a thread issues, then counts

constexpr int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }
constexpr int at_least_1(int x) { return x > 0 ? x : 1; }

// What one thread reads of one batch: kWords words covering kVerts
// vertices, and how many batches it loads before it counts (kStep).
template <int W, bool kVec>
struct Shape {
  static constexpr int kWords = kVec ? W * 4 / gcd(W, 4) : W;
  static constexpr int kVerts = kWords / W;
  static constexpr int kStep =
      at_least_1(kVec ? kInFlight * 4 / kWords : 4 * kInFlight / W);
};

template <int N, bool kVec>
__device__ __forceinline__ void load_words(uint32_t (&x)[N],
                                           const uint32_t* __restrict__ p) {
  if constexpr (kVec) {
#pragma unroll
    for (int n = 0; n < N / 4; ++n) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + n);
      x[4 * n] = v.x;
      x[4 * n + 1] = v.y;
      x[4 * n + 2] = v.z;
      x[4 * n + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) x[n] = __ldg(p + n);
  }
}

template <int W, int kQ, bool kVec>
__global__ void __launch_bounds__(kThreads)
cover_counts_kernel(const uint32_t* __restrict__ visited,
                    const uint32_t* __restrict__ active,
                    int32_t* __restrict__ counts, int B, long long V, int Q,
                    int batches_per_split, long long n_groups) {
  using S = Shape<W, kVec>;
  __shared__ uint32_t s_act[kStage * kQ * W];
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool mine = g < n_groups;
  const int b_lo = blockIdx.y * batches_per_split;
  const int b_hi = min(B, b_lo + batches_per_split);
  const int q0 = blockIdx.z * kQ;
  const size_t slab = (size_t)V * W;

  int cnt[kQ][S::kVerts];
#pragma unroll
  for (int q = 0; q < kQ; ++q)
#pragma unroll
    for (int i = 0; i < S::kVerts; ++i) cnt[q][i] = 0;

  for (int s0 = b_lo; s0 < b_hi; s0 += kStage) {
    const int ns = min(kStage, b_hi - s0);
    __syncthreads();  // the previous stage's words are consumed
    for (int i = threadIdx.x; i < ns * kQ * W; i += kThreads) {
      const int bb = i / (kQ * W), q = i / W % kQ, w = i % W;
      s_act[i] = q0 + q < Q
                     ? active[((size_t)(s0 + bb) * Q + q0 + q) * W + w]
                     : 0u;
    }
    __syncthreads();
    if (!mine) continue;
    const uint32_t* base =
        visited + (size_t)s0 * slab + (size_t)g * S::kWords;
    for (int bb = 0; bb < ns; bb += S::kStep) {
      uint32_t x[S::kStep][S::kWords];
#pragma unroll
      for (int j = 0; j < S::kStep; ++j) {
        if (bb + j < ns) {
          load_words<S::kWords, kVec>(x[j], base + (size_t)(bb + j) * slab);
        } else {
#pragma unroll
          for (int k = 0; k < S::kWords; ++k) x[j][k] = 0u;
        }
      }
#pragma unroll
      for (int j = 0; j < S::kStep; ++j) {
        // Past the stage's end x[j] is 0, so any active words count 0.
        const uint32_t* act = s_act + min(bb + j, ns - 1) * kQ * W;
#pragma unroll
        for (int q = 0; q < kQ; ++q)
#pragma unroll
          for (int k = 0; k < S::kWords; ++k)
            cnt[q][k / W] += __popc(x[j][k] & act[q * W + k % W]);
      }
    }
  }
  if (!mine) return;
  const bool accumulate = gridDim.y > 1;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    if (q0 + q >= Q) break;
#pragma unroll
    for (int i = 0; i < S::kVerts; ++i) {
      int32_t* c = counts + (size_t)(q0 + q) * V + g * S::kVerts + i;
      if (!accumulate)
        *c = cnt[q][i];
      else if (cnt[q][i])
        atomicAdd(c, cnt[q][i]);
    }
  }
}

// More than 8 words a row (over 256 colours, which no tile kernel takes):
// one thread per vertex, W read at run time, active read through the
// read-only cache, one split.
template <int kQ>
__global__ void __launch_bounds__(kThreads)
cover_counts_any_w_kernel(const uint32_t* __restrict__ visited,
                          const uint32_t* __restrict__ active,
                          int32_t* __restrict__ counts, int B, long long V,
                          int W, int Q) {
  const long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (v >= V) return;
  const int q0 = blockIdx.z * kQ;
  int cnt[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) cnt[q] = 0;
  for (int b = 0; b < B; ++b) {
    const uint32_t* row = visited + ((size_t)b * V + v) * W;
    const uint32_t* act = active + ((size_t)b * Q + q0) * W;
    for (int w = 0; w < W; ++w) {
      const uint32_t x = __ldg(row + w);
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        if (q0 + q < Q) cnt[q] += __popc(x & __ldg(act + (size_t)q * W + w));
    }
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q)
    if (q0 + q < Q) counts[(size_t)(q0 + q) * V + v] = cnt[q];
}

// The CTAs of one instantiation resident on the card at once (SMs times
// CTAs per SM), read once per instantiation.
template <int W, int kQ, bool kVec>
int wave_ctas() {
  static int ctas = 0;
  if (ctas == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cover_counts_kernel<W, kQ, kVec>, kThreads, 0);
    ctas = sms * (per_sm > 0 ? per_sm : 1);
  }
  return ctas;
}

// Launch on `stream`, B split over gridDim.y into as many batch ranges as
// one wave of resident CTAs holds.
template <int W, int kQ, bool kVec>
cudaError_t launch(const uint32_t* visited, const uint32_t* active,
                   int32_t* counts, int B, long long V, int Q,
                   cudaStream_t stream) {
  using S = Shape<W, kVec>;
  const long long n_groups = V / S::kVerts;  // exact: see launch_w
  const long long cx = (n_groups + kThreads - 1) / kThreads;
  const long long want = wave_ctas<W, kQ, kVec>() / cx;
  int split = (int)(want < B ? want : B);
  split = split < 1 ? 1 : (split > 65535 ? 65535 : split);
  const int per = (B + split - 1) / split;
  split = (B + per - 1) / per;
  if (split > 1) {
    const cudaError_t err = cudaMemsetAsync(
        counts, 0, (size_t)Q * V * sizeof(int32_t), stream);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)cx, (unsigned)split,
                  (unsigned)((Q + kQ - 1) / kQ));
  cover_counts_kernel<W, kQ, kVec><<<grid, kThreads, 0, stream>>>(
      visited, active, counts, B, V, Q, per, n_groups);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_w(const uint32_t* visited, const uint32_t* active,
                     int32_t* counts, int B, long long V, int Q,
                     cudaStream_t stream) {
  // 16-byte loads need every batch's slab, and the base, 16-byte aligned;
  // then V*W is a multiple of lcm(W, 4), so V one of kVerts.
  const bool vec = (V * W) % 4 == 0 && (uintptr_t)visited % 16 == 0;
  if (Q == 1) {
    return vec ? launch<W, 1, true>(visited, active, counts, B, V, Q, stream)
               : launch<W, 1, false>(visited, active, counts, B, V, Q,
                                     stream);
  }
  return vec ? launch<W, kQMax, true>(visited, active, counts, B, V, Q,
                                      stream)
             : launch<W, kQMax, false>(visited, active, counts, B, V, Q,
                                       stream);
}

}  // namespace

// C interface (bound with ctypes). Returns a cudaError_t; 0 is success.
// visited (B, V, W) and active (B, Q, W) uint32, counts (Q, V) int32;
// W >= 1.
extern "C" int cover_counts_launch(const void* visited, const void* active,
                                   void* counts, int B, long long V, int W,
                                   int Q, void* stream) {
  if (B < 0 || V < 0 || Q < 0 || W < 1) return (int)cudaErrorInvalidValue;
  if (V == 0 || Q == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (B == 0)
    return (int)cudaMemsetAsync(counts, 0, (size_t)Q * V * sizeof(int32_t),
                                s);
  if (!words::valid(W)) {
    const dim3 grid((unsigned)((V + kThreads - 1) / kThreads), 1,
                    (unsigned)((Q + kQMax - 1) / kQMax));
    cover_counts_any_w_kernel<kQMax><<<grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(visited),
        static_cast<const uint32_t*>(active), static_cast<int32_t*>(counts),
        B, V, W, Q);
    return (int)cudaGetLastError();
  }
  return (int)words::dispatch(W, [&](auto w) {
    return launch_w<decltype(w)::value>(
        static_cast<const uint32_t*>(visited),
        static_cast<const uint32_t*>(active), static_cast<int32_t*>(counts),
        B, V, Q, s);
  });
}

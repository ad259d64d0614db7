// The slot-list walk the three tile kernels share (csrc/fused_expand.cu,
// IC; csrc/fused_expand_q.cu, quantised IC; csrc/lt_select_expand.cu, LT);
// each supplies only its edge gate.
//
// The list (core/tiles.py, SlotList) holds, per tile in tile order, the
// slots whose value passes the kernel's test, each as its source row, its
// destination row, its value and its RNG key; tile t's entries are
// [slot_ptr[t], slot_ptr[t+1]). A thread owns one entry: it reads the W
// frontier words of the source row and the W visited words of the
// destination row (both masks sit in L2), forms pending = frontier &
// ~visited, and draws only the pending colours. The warp then merges the
// entries that share a destination row (__match_any_sync on the row, an OR
// over the matching lanes with __reduce_or_sync), and one lane per row ORs
// the words into out with atomicOr. OR is commutative and idempotent, so
// the result does not depend on the order in which CTAs arrive: it is
// bit-identical to the tile walk. The launcher zeroes out on the call's
// stream first (a memset node, which a CUDA graph captures). An entry with
// no pending colour reads neither its value nor its key.
//
// Two grids:
//   dense — every entry of the list, one thread each;
//   list  — the tiles listed in tile_ids (ascending original ids, the
//           sparse frontier's compacted list): a CTA takes kThreads listed
//           tiles, scans their entry counts in shared memory and walks the
//           concatenation of their entries kThreads at a time, each thread
//           finding its entry's tile by a binary search over the scan. A
//           tile's entries thus spread over the whole CTA: on a clustered
//           graph a diagonal tile holds hundreds of entries, which one warp
//           would walk 32 at a time, in turn, while the card waits for it.
//
// A Gate holds one launch's view of the diffusion's edge test:
//   Gate::Edge edge(int e, int d) const — per live entry e (one with a
//     pending colour), once; d is the entry's destination row;
//   uint32_t draw(const Gate::Edge&, int w, uint32_t pending) const
//     — the colours of word w among `pending` that cross the edge.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "words.cuh"

namespace slot_expand {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// One entry: valid lanes draw, then every lane of the warp (valid or not)
// takes part in the merge, so the caller must keep the warp converged.
template <int W, class Gate>
__device__ __forceinline__ void expand_entry(
    bool valid, int e, const int32_t* __restrict__ src_row,
    const int32_t* __restrict__ dst_row, const uint32_t* __restrict__ frontier,
    const uint32_t* __restrict__ visited, uint32_t* __restrict__ out,
    const Gate& gate) {
  uint32_t bits[W];
  int d = -1;
  uint32_t any = 0u;
#pragma unroll
  for (int w = 0; w < W; ++w) bits[w] = 0u;
  if (valid) {
    const size_t s = (size_t)src_row[e];
    d = dst_row[e];
    uint32_t pending[W];
    uint32_t live = 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      pending[w] = frontier[s * W + w] & ~visited[(size_t)d * W + w];
      live |= pending[w];
    }
    if (live) {
      const auto edge = gate.edge(e, d);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (pending[w]) bits[w] = gate.draw(edge, w, pending[w]);
        any |= bits[w];
      }
    }
  }
  const unsigned active = __ballot_sync(kFull, any != 0u);
  if (any == 0u) return;
  const unsigned peers = __match_any_sync(active, d);
  const bool leader = (threadIdx.x & 31) == __ffs(peers) - 1;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t word = __reduce_or_sync(peers, bits[w]);
    if (leader && word) atomicOr(out + (size_t)d * W + w, word);
  }
}

template <int W, class Gate>
__global__ void __launch_bounds__(kThreads)
dense_kernel(const int32_t* __restrict__ src_row,
             const int32_t* __restrict__ dst_row, int n_entries,
             const uint32_t* __restrict__ frontier,
             const uint32_t* __restrict__ visited, uint32_t* __restrict__ out,
             Gate gate) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  expand_entry<W>(e < n_entries, e, src_row, dst_row, frontier, visited, out,
                  gate);
}

template <int W, class Gate>
__global__ void __launch_bounds__(kThreads)
list_kernel(const int32_t* __restrict__ slot_ptr,
            const int32_t* __restrict__ tile_ids, int n_listed,
            const int32_t* __restrict__ src_row,
            const int32_t* __restrict__ dst_row,
            const uint32_t* __restrict__ frontier,
            const uint32_t* __restrict__ visited, uint32_t* __restrict__ out,
            Gate gate) {
  __shared__ int s_incl[kThreads];   // inclusive scan of the CTA's counts
  __shared__ int s_begin[kThreads];  // first entry of each listed tile
  __shared__ int s_warp[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int listed = blockIdx.x * kThreads + threadIdx.x;
  int begin = 0, count = 0;
  if (listed < n_listed) {
    const int tile = tile_ids[listed];
    begin = slot_ptr[tile];
    count = slot_ptr[tile + 1] - begin;
  }
  int incl = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kThreads / 32 ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < kThreads / 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t += v;
    }
    if (lane < kThreads / 32) s_warp[lane] = t;
  }
  __syncthreads();
  if (warp > 0) incl += s_warp[warp - 1];
  s_incl[threadIdx.x] = incl;
  s_begin[threadIdx.x] = begin;
  __syncthreads();
  const int total = s_incl[kThreads - 1];
  for (int base = 0; base < total; base += kThreads) {
    const int f = base + threadIdx.x;  // this thread's place in the walk
    // The owner is the number of listed tiles whose inclusive count <= f.
    int owner = 0;
#pragma unroll
    for (int step = kThreads / 2; step > 0; step >>= 1) {
      if (s_incl[owner + step - 1] <= f) owner += step;
    }
    const int skip = owner ? s_incl[owner - 1] : 0;
    expand_entry<W>(f < total, s_begin[owner] + (f - skip), src_row, dst_row,
                    frontier, visited, out, gate);
  }
}

// Zero out, then launch the dense grid (n_listed < 0) or the list grid
// over n_listed >= 0 tiles (tile_ids may be null when n_listed is 0: an
// empty tensor's address) on `stream`; returns the launch's cudaError_t.
template <int W, class Gate>
cudaError_t launch(const int32_t* slot_ptr, const int32_t* src_row,
                   const int32_t* dst_row, int n_entries,
                   const int32_t* tile_ids, int n_listed,
                   const uint32_t* frontier, const uint32_t* visited,
                   uint32_t* out, int n_rows, const Gate& gate,
                   cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)n_rows * W * sizeof(uint32_t), stream);
  if (err != cudaSuccess) return err;
  const bool dense = n_listed < 0;
  const int work = dense ? n_entries : n_listed;
  if (work == 0) return cudaSuccess;
  const int blocks = (work + kThreads - 1) / kThreads;
  if (!dense) {
    list_kernel<W><<<blocks, kThreads, 0, stream>>>(
        slot_ptr, tile_ids, n_listed, src_row, dst_row, frontier, visited,
        out, gate);
  } else {
    dense_kernel<W><<<blocks, kThreads, 0, stream>>>(
        src_row, dst_row, n_entries, frontier, visited, out, gate);
  }
  return cudaGetLastError();
}

}  // namespace slot_expand

// The tile walk of the LT kernel (csrc/lt_select_expand.cu), which supplies
// its edge gate. (The two IC kernels walk per-tile lists of nonzero slots
// instead: csrc/slot_expand.cuh.)
//
// One CTA owns one destination block: entries [run_ptr[b], run_ptr[b+1]) of
// the tile list. Thread j owns destination lane j and keeps its W visited
// and output words in registers, so no accumulation crosses CTAs and blocks
// that no entry reaches write 0. Per tile the CTA stages the source block's
// frontier rows in shared memory and ballots which rows carry any colour; it
// then walks only those rows. A thread consults the gate only for (slot,
// colour) pairs that can change its result: prob > 0, colour set in the
// source row, and colour not already visited or already reached.
//
// Tile list. With tile_ids == nullptr the list is every tile of the layout
// (the dense grid, run_ptr = dst_run_ptr). Otherwise entry t is tile
// tile_ids[t]: an ascending list of original ids (the sparse frontier's
// tiles with an active source block) with run pointers over that list, and
// each listed tile is read where it lies in the stacks. This replaces the
// reference's gather of the compacted stacks plus an appended null tile
// (repro/core/tiled_traversal.py:57-75, repro/core/tiles.py:173-198), which
// would copy whole 12 GiB stacks at n = 65,536.
//
// The stack is float32 probabilities (0: no edge). A Gate holds one
// thread's view of the diffusion's edge test:
//   Gate::Edge edge(size_t slot, float p) const — per live slot, once;
//   bool pass(const Gate::Edge&, int colour) const — per pending colour.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "words.cuh"

namespace tile_expand {

inline bool valid_shape(int T, int W) {
  return T >= 32 && T <= 1024 && T % 32 == 0 && words::valid(W);
}

// Dynamic shared memory of one CTA: T frontier rows of W words, T/32 ballots.
inline size_t smem_bytes(int T, int W) {
  return (size_t)(T * W + T / 32) * sizeof(uint32_t);
}

template <int W, class Gate>
__device__ __forceinline__ void expand_block(
    const float* __restrict__ prob, const int32_t* __restrict__ tile_ids,
    const int32_t* __restrict__ tile_src, const int32_t* __restrict__ run_ptr,
    const uint32_t* __restrict__ frontier,
    const uint32_t* __restrict__ visited, uint32_t* __restrict__ out, int T,
    const Gate& gate) {
  extern __shared__ uint32_t smem[];
  uint32_t* fr_rows = smem;               // [T][W] source-block frontier
  uint32_t* live_rows = smem + T * W;     // [T/32] row ballots
  const int j = threadIdx.x;
  const size_t row = (size_t)blockIdx.x * T + j;

  uint32_t vis[W], acc[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    vis[w] = visited[row * W + w];
    acc[w] = 0u;
  }
  const int t_end = run_ptr[blockIdx.x + 1];
  for (int t = run_ptr[blockIdx.x]; t < t_end; ++t) {
    const int tile = tile_ids ? tile_ids[t] : t;
    const size_t src_row = (size_t)tile_src[tile] * T + j;
    uint32_t any = 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t f = frontier[src_row * W + w];
      fr_rows[j * W + w] = f;
      any |= f;
    }
    const uint32_t ballot = __ballot_sync(0xffffffffu, any != 0u);
    if ((j & 31) == 0) live_rows[j >> 5] = ballot;
    __syncthreads();

    const size_t tile_base = (size_t)tile * T * T;
    for (int g = 0; g < T / 32; ++g) {
      uint32_t rows = live_rows[g];
      while (rows) {                      // uniform across the CTA
        const int i = g * 32 + __ffs(rows) - 1;
        rows &= rows - 1;
        const size_t slot = tile_base + (size_t)i * T + j;
        const float p = prob[slot];
        if (!(p > 0.0f)) continue;
        uint32_t lanes[W];
        uint32_t pending = 0u;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          lanes[w] = fr_rows[i * W + w] & ~vis[w] & ~acc[w];
          pending |= lanes[w];
        }
        if (!pending) continue;
        const auto edge = gate.edge(slot, p);
#pragma unroll
        for (int w = 0; w < W; ++w) {
          uint32_t l = lanes[w];
          while (l) {
            const int c = __ffs(l) - 1;
            l &= l - 1;
            if (gate.pass(edge, w * 32 + c)) acc[w] |= 1u << c;
          }
        }
      }
    }
    __syncthreads();  // fr_rows / live_rows are rewritten by the next tile
  }
#pragma unroll
  for (int w = 0; w < W; ++w) out[row * W + w] = acc[w] & ~vis[w];
}

}  // namespace tile_expand

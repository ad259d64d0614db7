// One fused-BPT IC level over the slot list of the dst-sorted 128x128
// adjacency tiles.
//
// Replaces the Pallas kernel repro/kernels/fused_expand.py::fused_expand
// (body _expand_kernel). It computes
//
//   out[d] = OR over tiles t with tile_dst[t] = d/T, OR over source rows i of
//            frontier[tile_src[t]*T + i] & bernoulli(seed, level, edge_id, p)
//            & ~visited[d]
//
// bit for bit, with the repository's own counter hash (core/rng.py), so the
// result equals the CSR sweep and the reference package.
//
// Design. The Pallas grid runs in order because consecutive tiles of one
// destination block accumulate into one output block. Here the work is the
// layout's slot list (core/tiles.py, ic_slot_list: per tile, the slots with
// prob > 0, each with its source and destination rows, probability and edge
// id), one thread per entry over many CTAs, merged into out with a warp
// reduction and atomicOr: the walk is csrc/slot_expand.cuh, shared with the
// quantised kernel. This file supplies the IC gate: per entry one fold of
// the edge id, per pending colour one hash and one compare (a uniform in
// [0,1) is never below 0, so slots with prob <= 0 are not listed). The list
// is every entry (the dense grid) or the entries of the listed tiles (the
// sparse frontier's compacted list, read in place).
//
// Bound. A level reads the probability and edge id of every edge whose
// source row is live, the frontier and visited masks, and writes the output
// mask: bytes-bound unless the live (edge, colour) pairs are many (about
// 20 integer operations per hashed colour). The tile walk this replaces
// (one CTA per destination block walking ~387 tiles in turn, one dependent
// load per live source row for ~2 edges per 16,384-slot tile) was
// latency-bound at ~4,100x that bound; the list's work follows the edges.
//
// Exactness: the compare is the exact __uint2float_rn(h >> 8) * 2^-24 < p,
// built without --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"
#include "slot_expand.cuh"

namespace {

using counter_hash::fold;

// The IC edge test: colour c crosses the edge of entry e when the counter
// hash of (seed, level, edge_id[e], c) gives a uniform below prob[e].
struct IcGate {
  struct Edge {
    uint32_t h;
    float p;
  };
  const float* prob;
  const int32_t* edge_id;
  uint32_t h_level;

  __device__ __forceinline__ Edge edge(int e, int) const {
    return {fold(h_level, (uint32_t)edge_id[e]), prob[e]};
  }
  __device__ __forceinline__ uint32_t draw(const Edge& x, int w,
                                           uint32_t pending) const {
    uint32_t bits = 0u;
    while (pending) {
      const int c = __ffs(pending) - 1;
      pending &= pending - 1;
      const uint32_t h = fold(x.h, (uint32_t)(w * 32 + c));
      // uniform_from_u32: a 24-bit integer times 2^-24, both exact.
      if (__uint2float_rn(h >> 8) * (1.0f / 16777216.0f) < x.p)
        bits |= 1u << c;
    }
    return bits;
  }
};

}  // namespace

// C interface (bound with ctypes). Returns a cudaError_t; 0 is success.
// The list: slot_ptr (n_tiles + 1), src_row, dst_row, prob, edge_id
// (n_entries each). tile_ids: n_listed ascending tile ids, or n_listed < 0
// for every entry. frontier, visited and out are (n_rows, W), 1 <= W <= 8.
extern "C" int fused_expand_launch(const void* slot_ptr, const void* src_row,
                                   const void* dst_row, const void* prob,
                                   const void* edge_id, int n_entries,
                                   const void* tile_ids, int n_listed,
                                   const void* frontier, const void* visited,
                                   void* out, int n_rows, int W,
                                   unsigned int seed, unsigned int level,
                                   void* stream) {
  if (!words::valid(W)) return (int)cudaErrorInvalidValue;
  const IcGate gate{static_cast<const float*>(prob),
                    static_cast<const int32_t*>(edge_id),
                    counter_hash::level_prefix(seed, level)};
  return (int)words::dispatch(W, [&](auto w) {
    return slot_expand::launch<decltype(w)::value>(
        static_cast<const int32_t*>(slot_ptr),
        static_cast<const int32_t*>(src_row),
        static_cast<const int32_t*>(dst_row), n_entries,
        static_cast<const int32_t*>(tile_ids), n_listed,
        static_cast<const uint32_t*>(frontier),
        static_cast<const uint32_t*>(visited), static_cast<uint32_t*>(out),
        n_rows, gate, static_cast<cudaStream_t>(stream));
  });
}

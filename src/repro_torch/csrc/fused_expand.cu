// One fused-BPT IC level over the dst-sorted 128x128 adjacency tiles.
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
// destination block accumulate into one output block. Here one CTA owns one
// destination block and walks its run of the tile list (every tile, or a
// compacted list read in place): the walk is csrc/tile_expand.cuh, shared
// with the LT kernel. This file supplies the IC gate: per live slot one
// fold of the edge id, per pending colour one hash and one compare. A
// thread hashes only (slot, colour) pairs that can change its result (prob
// > 0, since a uniform in [0,1) is never below 0), so the work is
// proportional to the live (row, slot, colour) triples, not to 32*W hashes
// per stored slot.
//
// Bound. A level reads each live source row's probabilities (T floats per
// tile row), the edge ids of live slots, the frontier and visited masks,
// and writes the output mask: bytes-bound unless the live triples are many
// (about 20 integer operations per hashed colour).
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"
#include "tile_expand.cuh"

namespace {

using counter_hash::fold;

// The IC edge test: colour c crosses the edge in slot s when the counter
// hash of (seed, level, edge_id[s], c) gives a uniform below prob[s].
struct IcGate {
  struct Edge {
    uint32_t h;
    float p;
  };
  const int32_t* edge_id;
  uint32_t h_level;

  __device__ __forceinline__ Edge edge(size_t slot, uint32_t /*cell*/,
                                       float p) const {
    return {fold(h_level, (uint32_t)edge_id[slot]), p};
  }
  __device__ __forceinline__ bool pass(const Edge& e, int colour) const {
    const uint32_t h = fold(e.h, (uint32_t)colour);
    // uniform_from_u32: a 24-bit integer times 2^-24, both exact.
    return __uint2float_rn(h >> 8) * (1.0f / 16777216.0f) < e.p;
  }
};

template <int W>
__global__ void __launch_bounds__(1024)
fused_expand_kernel(const float* __restrict__ prob,
                    const int32_t* __restrict__ edge_id,
                    const int32_t* __restrict__ tile_ids,
                    const int32_t* __restrict__ tile_src,
                    const int32_t* __restrict__ run_ptr,
                    const uint32_t* __restrict__ frontier,
                    const uint32_t* __restrict__ visited,
                    uint32_t* __restrict__ out, int T, uint32_t h_level) {
  tile_expand::expand_block<W>(prob, tile_ids, tile_src, run_ptr, frontier,
                               visited, out, T, IcGate{edge_id, h_level});
}

}  // namespace

// C interface (bound with ctypes). Returns a cudaError_t; 0 is success.
// n_blocks = rows of out / T; T a multiple of 32 in [32, 1024]; 1 <= W <= 8.
// tile_ids may be null (every tile); run_ptr has n_blocks + 1 entries.
extern "C" int fused_expand_launch(const void* prob, const void* edge_id,
                                   const void* tile_ids,
                                   const void* tile_src,
                                   const void* run_ptr,
                                   const void* frontier, const void* visited,
                                   void* out, int n_blocks, int T, int W,
                                   unsigned int seed, unsigned int level,
                                   void* stream) {
  if (!tile_expand::valid_shape(T, W)) return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  const uint32_t h_level = counter_hash::level_prefix(seed, level);
  return (int)tile_expand::dispatch_words(W, [&](auto words) {
    constexpr int kW = decltype(words)::value;
    fused_expand_kernel<kW><<<n_blocks, T, tile_expand::smem_bytes(T, kW),
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(prob), static_cast<const int32_t*>(edge_id),
        static_cast<const int32_t*>(tile_ids),
        static_cast<const int32_t*>(tile_src),
        static_cast<const int32_t*>(run_ptr),
        static_cast<const uint32_t*>(frontier),
        static_cast<const uint32_t*>(visited), static_cast<uint32_t*>(out), T,
        h_level);
    return cudaGetLastError();
  });
}

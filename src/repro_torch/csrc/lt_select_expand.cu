// One fused-BPT LT level over the dst-sorted adjacency tiles.
//
// Replaces the Pallas kernel repro/kernels/lt_select_expand.py::
// lt_select_expand (body _lt_kernel, and the zeroing of destination blocks
// no tile reaches). Colour c of destination j is reached from source i when
//
//   frontier[i] carries c,  prob[i,j] > 0,
//   cb[i,j] <= u[j,c] < cb[i,j] + prob[i,j],  and c is not in visited[j],
//
// i.e. the edge is j's live in-edge for c under the LT live-edge selection.
// u is the per-traversal (rows, W*32) uniform table (kernels/ref.py::
// lt_selection_uniforms); the kernel runs no RNG. hi = cb + prob is one
// float32 add, round to nearest, and the compares are float32: the file is
// built without --use_fast_math and without flush-to-zero, so the result
// equals the reference's bit for bit.
//
// Design: one CTA per destination block walks the block's run of the tile
// list (every tile, or a compacted list read in place), only live source
// rows, through the walk of csrc/tile_expand.cuh.
// This file supplies the LT gate. A thread tests only (slot, colour) pairs
// that can change its result: prob > 0, colour in the source row, not
// visited and not reached yet. It reads u[j,c] from device memory for those
// pairs alone: an LT RRR set is a path, so a level tests at most a few
// hundred pairs, and staging each CTA's (T, W*32) slice of u would read the
// whole 16.8 MB table (n = 65,536, 64 colours) every level for nothing.
//
// Bound. A level reads prob and cb of each live source row's slots, u for
// each tested pair, the tile list and the three masks, and writes the output
// mask: bytes-bound (one add and two compares per tested pair).
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_expand.cuh"

namespace {

// The LT edge test for destination lane j: colour c crosses the edge in
// slot s when cb[s] <= u[j,c] < cb[s] + prob[s].
struct LtGate {
  struct Edge {
    float lo, hi;
  };
  const float* cb;
  const float* u_row;  // u[j, 0:W*32]

  __device__ __forceinline__ Edge edge(size_t slot, float p) const {
    const float lo = cb[slot];
    return {lo, __fadd_rn(lo, p)};
  }
  __device__ __forceinline__ bool pass(const Edge& e, int colour) const {
    const float x = __ldg(u_row + colour);
    return x >= e.lo && x < e.hi;
  }
};

template <int W>
__global__ void __launch_bounds__(1024)
lt_select_expand_kernel(const float* __restrict__ prob,
                        const float* __restrict__ cb,
                        const int32_t* __restrict__ tile_ids,
                        const int32_t* __restrict__ tile_src,
                        const int32_t* __restrict__ run_ptr,
                        const uint32_t* __restrict__ frontier,
                        const uint32_t* __restrict__ visited,
                        const float* __restrict__ u,
                        uint32_t* __restrict__ out, int T) {
  const size_t row = (size_t)blockIdx.x * T + threadIdx.x;
  tile_expand::expand_block<W>(prob, tile_ids, tile_src, run_ptr, frontier,
                               visited, out, T,
                               LtGate{cb, u + row * (W * 32)});
}

}  // namespace

// C interface (bound with ctypes). Returns a cudaError_t; 0 is success.
// n_blocks = rows of out / T; T a multiple of 32 in [32, 1024]; 1 <= W <= 8;
// tile_ids may be null (every tile); run_ptr has n_blocks + 1 entries;
// u has n_blocks * T rows of W * 32 floats.
extern "C" int lt_select_expand_launch(const void* prob, const void* cb,
                                       const void* tile_ids,
                                       const void* tile_src,
                                       const void* run_ptr,
                                       const void* frontier,
                                       const void* visited, const void* u,
                                       void* out, int n_blocks, int T, int W,
                                       void* stream) {
  if (!tile_expand::valid_shape(T, W)) return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  return (int)words::dispatch(W, [&](auto w) {
    constexpr int kW = decltype(w)::value;
    lt_select_expand_kernel<kW><<<n_blocks, T,
                                  tile_expand::smem_bytes(T, kW),
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(prob), static_cast<const float*>(cb),
        static_cast<const int32_t*>(tile_ids),
        static_cast<const int32_t*>(tile_src),
        static_cast<const int32_t*>(run_ptr),
        static_cast<const uint32_t*>(frontier),
        static_cast<const uint32_t*>(visited), static_cast<const float*>(u),
        static_cast<uint32_t*>(out), T);
    return cudaGetLastError();
  });
}

// One fused-BPT LT level over the slot list of the dst-sorted adjacency
// tiles.
//
// Replaces the Pallas kernel repro/kernels/lt_select_expand.py::
// lt_select_expand (body _lt_kernel, and the zeroing of destination blocks
// no tile reaches). Colour c of destination d is reached from source s when
//
//   frontier[s] carries c,  prob(s,d) > 0,
//   cb(s,d) <= u[d,c] < cb(s,d) + prob(s,d),  and c is not in visited[d],
//
// i.e. the edge is d's live in-edge for c under the LT live-edge selection.
// u is the per-traversal (rows, W*32) uniform table (kernels/ref.py::
// lt_selection_uniforms); the kernel runs no RNG. hi = cb + prob is one
// float32 add, round to nearest, and the compares are float32: the file is
// built without --use_fast_math and without flush-to-zero, so the result
// equals the reference's bit for bit.
//
// Design. The work is the layout's LT slot list (core/tiles.py,
// lt_slot_list: per tile, the slots with prob > 0, each with its source and
// destination rows, its probability and its cb prefix as float32 bits), one
// thread per entry over many CTAs, merged into out with a warp reduction and
// atomicOr: the walk is csrc/slot_expand.cuh, shared with the two IC
// kernels; the list is every entry (the dense grid) or the entries of the
// listed tiles (the sparse frontier's compacted list, read in place). This
// file supplies the LT gate: per live entry it reads cb and prob and forms
// hi once, and per pending colour it reads u[d, c] from device memory and
// compares. An LT RRR set is a path, so a level tests at most a few
// hundred (entry, colour) pairs: staging u would read the whole 16.8 MB
// table (n = 65,536, 64 colours) every level for nothing.
//
// The tile walk this replaces (one CTA per destination block over its run of
// the tile list, ~387 tiles at n = 65,536, two __syncthreads and a dependent
// prob load per live source row) took 0.2132 ms a level on the dense grid
// and 0.0184 ms on the compacted list, and the list needed run pointers
// built on every level.
//
// Bound. A level reads prob and cb of every entry whose source row is live,
// u for each tested pair, the frontier and visited rows, and writes the
// output mask: bytes-bound (one add and two compares per tested pair).
#include <cuda_runtime.h>
#include <stdint.h>

#include "slot_expand.cuh"

namespace {

// The LT edge test: colour c of destination d crosses the edge of entry e
// when lo <= u[d, c] < hi, with lo = cb[e] and hi = lo + prob[e].
struct LtGate {
  struct Edge {
    float lo, hi;
    const float* u_row;  // u[d, 0:W*32]
  };
  const float* prob;
  const int32_t* cb_bits;
  const float* u;
  int u_stride;  // W * 32 floats a row

  __device__ __forceinline__ Edge edge(int e, int d) const {
    const float lo = __int_as_float(cb_bits[e]);
    return {lo, __fadd_rn(lo, prob[e]), u + (size_t)d * u_stride};
  }
  __device__ __forceinline__ uint32_t draw(const Edge& x, int w,
                                           uint32_t pending) const {
    uint32_t bits = 0u;
    while (pending) {
      const int c = __ffs(pending) - 1;
      pending &= pending - 1;
      const float v = __ldg(x.u_row + w * 32 + c);
      if (v >= x.lo && v < x.hi) bits |= 1u << c;
    }
    return bits;
  }
};

}  // namespace

// C interface (bound with ctypes). Returns a cudaError_t; 0 is success.
// The list: slot_ptr (n_tiles + 1), src_row, dst_row, prob (float32), cb
// (float32 bits as int32; n_entries each). tile_ids: n_listed ascending
// tile ids, or n_listed < 0 for every entry. frontier, visited and out are
// (n_rows, W), 1 <= W <= 8; u is (n_rows, W * 32) float32.
extern "C" int lt_select_expand_launch(const void* slot_ptr,
                                       const void* src_row,
                                       const void* dst_row, const void* prob,
                                       const void* cb, int n_entries,
                                       const void* tile_ids, int n_listed,
                                       const void* frontier,
                                       const void* visited, void* out,
                                       int n_rows, int W, const void* u,
                                       void* stream) {
  if (!words::valid(W)) return (int)cudaErrorInvalidValue;
  const LtGate gate{static_cast<const float*>(prob),
                    static_cast<const int32_t*>(cb),
                    static_cast<const float*>(u), W * 32};
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

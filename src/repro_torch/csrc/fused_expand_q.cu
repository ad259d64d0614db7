// One quantised fused-BPT IC level over the dst-sorted adjacency tiles.
//
// Replaces both Pallas kernels of repro/kernels/fused_expand_q.py:
// fused_expand_q (body _expand_q_kernel, the dense grid, and the zeroing of
// destination blocks no tile reaches) and fused_expand_q_gathered (body
// _expand_q_gathered_kernel, a compacted null-padded tile list whose RNG
// counters key on the original tile ids). It computes
//
//   out[d] = OR over tiles t with tile_dst[t] = d/T, OR over source rows i of
//            frontier[tile_src[t]*T + i] & bern_q(seed, level, cell, q)
//            & ~visited[d]
//
// where the stack holds one uint8 threshold q per slot (0: no edge), the
// counter is the slot's position cell = (t*T*T + i*T + j) mod 2^32 in
// uint32 arithmetic (it wraps from tile id 2^18 at T = 128, as the
// reference's does), and colour c of a slot crosses when byte (c % 4) of
// hash_u32(seed, level, cell, c / 4) is at most q (unsigned compare; q > 0
// is the walk's test). For colour c = 32*w + l that is lane l of word w
// drawing hash w*8 + l/4, byte l%4: the reference's _bern_word_q.
//
// Design. The walk is csrc/tile_expand.cuh's, with a uint8 stack: one CTA
// per destination block walks the block's run of the tile list (every
// tile, or a list of original ids read in place: the reference's gathered
// copy and null tile are not needed, since the null tile contributes
// nothing), only the source rows with a live frontier word, and a thread
// hashes only pending (slot, colour) pairs: q > 0, colour in the source
// row, not visited and not reached yet. Per live slot one fold of the cell,
// per pending colour one fold and a byte compare. (One hash serves four
// colours; reusing it across the four is left for a faster version.)
//
// Bound, reckoned by chip_smoke.py from each level's own data:
//   bytes      = the q byte of every edge whose source row is live, the
//                frontier rows of the walked tiles' source blocks and the
//                visited rows of their destination blocks (the whole
//                masks on the dense grid), the output mask, and the tile
//                list (ids, source blocks, run pointers);
//   operations = one cell fold (14 integer operations) per live edge, plus
//                one hash and byte compare (20) per live nibble (a group
//                of four colours of the source row not all visited at the
//                destination), against the card's 32-bit operation rate.
// On chip_smoke.py's main path (262,144 vertices, cluster order, 591,103
// tiles, 64 colours; NVIDIA H100 80GB HBM3 at 700 W) the mean per level is
// 0.0026 ms by bytes on the dense grid (0.0028 on the compacted list) and
// 0.00008 ms by operations: bytes set the bound. The kernel takes 1.06 to
// 38.9 ms per level (mean 12.7): latency-bound. A CTA walks its ~289
// tiles in turn, and each live source row costs one dependent load of a
// 128-byte q row that holds 0.02 edges on average (2.59 edges per
// 16,384-slot tile); at the widest levels nearly every row is live.
//
// Exactness: integer arithmetic only, built without --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"
#include "tile_expand.cuh"

namespace {

using counter_hash::fold;

// The quantised IC edge test of one thread's slot.
struct QGate {
  struct Edge {
    uint32_t h;  // hash state after seed, level and the cell
    uint32_t q;
  };
  uint32_t h_level;

  __device__ __forceinline__ Edge edge(size_t /*slot*/, uint32_t cell,
                                       uint8_t q) const {
    return {fold(h_level, cell), (uint32_t)q};
  }
  __device__ __forceinline__ bool pass(const Edge& e, int colour) const {
    const uint32_t bits = fold(e.h, (uint32_t)colour >> 2);
    return ((bits >> (8 * (colour & 3))) & 0xFFu) <= e.q;
  }
};

template <int W>
__global__ void __launch_bounds__(1024)
fused_expand_q_kernel(const uint8_t* __restrict__ q8,
                      const int32_t* __restrict__ tile_ids,
                      const int32_t* __restrict__ tile_src,
                      const int32_t* __restrict__ run_ptr,
                      const uint32_t* __restrict__ frontier,
                      const uint32_t* __restrict__ visited,
                      uint32_t* __restrict__ out, int T, uint32_t h_level) {
  tile_expand::expand_block<W>(q8, tile_ids, tile_src, run_ptr, frontier,
                               visited, out, T, QGate{h_level});
}

}  // namespace

// C interface (bound with ctypes). Returns a cudaError_t; 0 is success.
// n_blocks = rows of out / T; T a multiple of 32 in [32, 1024]; 1 <= W <= 8.
// tile_ids may be null (every tile); run_ptr has n_blocks + 1 entries.
extern "C" int fused_expand_q_launch(const void* q8, const void* tile_ids,
                                     const void* tile_src,
                                     const void* run_ptr,
                                     const void* frontier,
                                     const void* visited, void* out,
                                     int n_blocks, int T, int W,
                                     unsigned int seed, unsigned int level,
                                     void* stream) {
  if (!tile_expand::valid_shape(T, W)) return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  const uint32_t h_level = counter_hash::level_prefix(seed, level);
  return (int)tile_expand::dispatch_words(W, [&](auto words) {
    constexpr int kW = decltype(words)::value;
    fused_expand_q_kernel<kW><<<n_blocks, T, tile_expand::smem_bytes(T, kW),
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(q8),
        static_cast<const int32_t*>(tile_ids),
        static_cast<const int32_t*>(tile_src),
        static_cast<const int32_t*>(run_ptr),
        static_cast<const uint32_t*>(frontier),
        static_cast<const uint32_t*>(visited), static_cast<uint32_t*>(out), T,
        h_level);
    return cudaGetLastError();
  });
}

// One quantised fused-BPT IC level over the slot list of the dst-sorted
// adjacency tiles.
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
// for every listed slot). For colour c = 32*w + l that is lane l of word w
// drawing hash w*8 + l/4, byte l%4: the reference's _bern_word_q.
//
// Design. The walk is csrc/slot_expand.cuh's over the quantised slot list
// (core/tiles.py, q_slot_list: per tile, the slots with q > 0, each with
// its rows, q and cell of the original tile id), one thread per entry over
// many CTAs, merged into out by a warp reduction and atomicOr. The list
// mode walks the entries of the listed tiles in place: the reference's
// gathered copy and null tile are not needed, since the null tile
// contributes nothing. Per entry one fold of the cell, then one hash per
// pending nibble (four colours of one byte each), reused across its four
// colours.
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
// tiles, 64 colours; NVIDIA H100 80GB HBM3 at 700 W) bytes set the bound
// (0.0026 ms per level on the dense grid). The tile walk this replaces (a
// CTA walking ~289 tiles in turn, one dependent 128-byte q-row load per
// live source row for 0.02 edges) took 1.06 to 38.9 ms per level.
//
// Exactness: integer arithmetic only, built without --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

#include "counter_hash.cuh"
#include "slot_expand.cuh"

namespace {

using counter_hash::fold;

// The quantised IC edge test of one entry.
struct QGate {
  struct Edge {
    uint32_t h;  // hash state after seed, level and the cell
    uint32_t q;
  };
  const uint8_t* q8;
  const uint32_t* cell;
  uint32_t h_level;

  __device__ __forceinline__ Edge edge(int e, int) const {
    return {fold(h_level, cell[e]), (uint32_t)q8[e]};
  }
  // One hash per pending nibble k of word w (colours 32w + 4k + b, b in
  // 0..3): byte b of fold(h, 8w + k) at most q lets colour 4k + b cross.
  __device__ __forceinline__ uint32_t draw(const Edge& x, int w,
                                           uint32_t pending) const {
    uint32_t bits = 0u;
    while (pending) {
      const int k = (__ffs(pending) - 1) >> 2;
      const uint32_t nibble = 0xFu << (4 * k);
      const uint32_t h = fold(x.h, (uint32_t)(w * 8 + k));
      uint32_t cross = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        cross |= (uint32_t)(((h >> (8 * b)) & 0xFFu) <= x.q) << b;
      bits |= (cross << (4 * k)) & pending & nibble;
      pending &= ~nibble;
    }
    return bits;
  }
};

}  // namespace

// C interface (bound with ctypes). Returns a cudaError_t; 0 is success.
// The list: slot_ptr (n_tiles + 1), src_row, dst_row, q8 (uint8), cell
// (n_entries each). tile_ids: n_listed ascending tile ids, or n_listed < 0
// for every entry. frontier, visited and out are (n_rows, W), 1 <= W <= 8.
extern "C" int fused_expand_q_launch(const void* slot_ptr,
                                     const void* src_row,
                                     const void* dst_row, const void* q8,
                                     const void* cell, int n_entries,
                                     const void* tile_ids, int n_listed,
                                     const void* frontier,
                                     const void* visited, void* out,
                                     int n_rows, int W, unsigned int seed,
                                     unsigned int level, void* stream) {
  if (!words::valid(W)) return (int)cudaErrorInvalidValue;
  const QGate gate{static_cast<const uint8_t*>(q8),
                   static_cast<const uint32_t*>(cell),
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

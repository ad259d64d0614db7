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
// destination block (tiles [dst_run_ptr[b], dst_run_ptr[b+1])) and thread j
// owns destination lane j, keeping its W output words in registers, so no
// accumulation crosses CTAs and blocks that no tile reaches simply write 0.
// Per tile the CTA stages the source block's frontier rows in shared memory
// and ballots which rows carry any colour; it then walks only those rows.
// A thread hashes only (slot, colour) pairs that can change its result:
// prob > 0 (a uniform in [0,1) is never below 0), colour set in the source
// row, and colour not already visited or already reached. The work is thus
// proportional to the live (row, slot, colour) triples, not to 32*W hashes
// per stored slot.
//
// Bound. A level reads each live source row's probabilities (T floats per
// tile row), the edge ids of live slots, the frontier and visited masks,
// and writes the output mask: bytes-bound unless the live triples are many
// (about 20 integer operations per hashed colour).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr int kMaxWords = 8;  // up to 256 colours

__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= kM1;
  x ^= x >> 13;
  x *= kM2;
  x ^= x >> 16;
  return x;
}

__host__ __device__ __forceinline__ uint32_t fold(uint32_t h, uint32_t v) {
  return mix32(h ^ (v + kGolden + (h << 6) + (h >> 2)));
}

template <int W>
__global__ void __launch_bounds__(1024)
fused_expand_kernel(const float* __restrict__ prob,
                    const int32_t* __restrict__ edge_id,
                    const int32_t* __restrict__ tile_src,
                    const int32_t* __restrict__ dst_run_ptr,
                    const uint32_t* __restrict__ frontier,
                    const uint32_t* __restrict__ visited,
                    uint32_t* __restrict__ out, int T, uint32_t h_level) {
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
  const int t_end = dst_run_ptr[blockIdx.x + 1];
  for (int t = dst_run_ptr[blockIdx.x]; t < t_end; ++t) {
    const size_t src_row = (size_t)tile_src[t] * T + j;
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

    const size_t tile_base = (size_t)t * T * T;
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
        const uint32_t h_edge = fold(h_level, (uint32_t)edge_id[slot]);
#pragma unroll
        for (int w = 0; w < W; ++w) {
          uint32_t l = lanes[w];
          while (l) {
            const int c = __ffs(l) - 1;
            l &= l - 1;
            const uint32_t h = fold(h_edge, (uint32_t)(w * 32 + c));
            // uniform_from_u32: a 24-bit integer times 2^-24, both exact.
            if (__uint2float_rn(h >> 8) * (1.0f / 16777216.0f) < p)
              acc[w] |= 1u << c;
          }
        }
      }
    }
    __syncthreads();  // fr_rows / live_rows are rewritten by the next tile
  }
#pragma unroll
  for (int w = 0; w < W; ++w) out[row * W + w] = acc[w] & ~vis[w];
}

template <int W>
cudaError_t launch(const float* prob, const int32_t* edge_id,
                   const int32_t* tile_src, const int32_t* dst_run_ptr,
                   const uint32_t* frontier, const uint32_t* visited,
                   uint32_t* out, int n_blocks, int T, uint32_t h_level,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(T * W + T / 32) * sizeof(uint32_t);
  fused_expand_kernel<W><<<n_blocks, T, smem, stream>>>(
      prob, edge_id, tile_src, dst_run_ptr, frontier, visited, out, T,
      h_level);
  return cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes). Returns a cudaError_t; 0 is success.
// n_blocks = rows of out / T; T a multiple of 32 in [32, 1024]; 1 <= W <= 8.
extern "C" int fused_expand_launch(const void* prob, const void* edge_id,
                                   const void* tile_src,
                                   const void* dst_run_ptr,
                                   const void* frontier, const void* visited,
                                   void* out, int n_blocks, int T, int W,
                                   unsigned int seed, unsigned int level,
                                   void* stream) {
  if (T < 32 || T > 1024 || T % 32 != 0 || W < 1 || W > kMaxWords)
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return 0;
  const uint32_t h_level = fold(seed * kGolden, level);
  const auto* p = static_cast<const float*>(prob);
  const auto* e = static_cast<const int32_t*>(edge_id);
  const auto* ts = static_cast<const int32_t*>(tile_src);
  const auto* rp = static_cast<const int32_t*>(dst_run_ptr);
  const auto* fr = static_cast<const uint32_t*>(frontier);
  const auto* vi = static_cast<const uint32_t*>(visited);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return (int)launch<1>(p, e, ts, rp, fr, vi, o, n_blocks, T, h_level, s);
    case 2: return (int)launch<2>(p, e, ts, rp, fr, vi, o, n_blocks, T, h_level, s);
    case 3: return (int)launch<3>(p, e, ts, rp, fr, vi, o, n_blocks, T, h_level, s);
    case 4: return (int)launch<4>(p, e, ts, rp, fr, vi, o, n_blocks, T, h_level, s);
    case 5: return (int)launch<5>(p, e, ts, rp, fr, vi, o, n_blocks, T, h_level, s);
    case 6: return (int)launch<6>(p, e, ts, rp, fr, vi, o, n_blocks, T, h_level, s);
    case 7: return (int)launch<7>(p, e, ts, rp, fr, vi, o, n_blocks, T, h_level, s);
    default: return (int)launch<8>(p, e, ts, rp, fr, vi, o, n_blocks, T, h_level, s);
  }
}

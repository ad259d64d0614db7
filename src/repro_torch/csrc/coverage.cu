// Max-k-cover marginal-gain counts, summed over the pool's batches.
//
// Replaces the Pallas kernel repro/kernels/coverage.py::cover_counts (body
// _coverage_kernel), which the reference vmaps over B batches
// (kernels/ops.py::cover_counts_batched) and then sums on the host graph
// (core/imm.py:217, serve/influence/engine.py:112). Every caller sums at
// once, so the sum over B is fused here:
//
//   counts[v] = sum_b sum_w popc(visited[b, v, w] & active[b, w])
//
// Design. One thread per vertex walks the B batches; a warp reads 32*W
// consecutive words per batch, so every load is coalesced, and __popc does
// the SWAR popcount of the reference in one instruction. The int32 sum is
// exact (at most 32*W*B per vertex) and needs no atomics.
//
// Bound. Each visited word is read once: B*V*W*4 bytes per call against 3
// integer operations per word, so the kernel is bound by memory bandwidth.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void cover_counts_kernel(const uint32_t* __restrict__ visited,
                                    const uint32_t* __restrict__ active,
                                    int32_t* __restrict__ counts, int B,
                                    long long V, int W) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  int sum = 0;
#pragma unroll 4
  for (int b = 0; b < B; ++b) {
    const uint32_t* row = visited + ((size_t)b * V + v) * W;
    const uint32_t* act = active + (size_t)b * W;
    for (int w = 0; w < W; ++w) sum += __popc(row[w] & __ldg(act + w));
  }
  counts[v] = sum;
}

}  // namespace

// C interface (bound with ctypes). Returns a cudaError_t; 0 is success.
extern "C" int cover_counts_launch(const void* visited, const void* active,
                                   void* counts, int B, long long V, int W,
                                   void* stream) {
  if (B < 0 || V < 0 || W < 1) return (int)cudaErrorInvalidValue;
  if (V == 0) return 0;
  const int threads = 256;
  const long long blocks = (V + threads - 1) / threads;
  cover_counts_kernel<<<(unsigned int)blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(visited),
      static_cast<const uint32_t*>(active), static_cast<int32_t*>(counts), B,
      V, W);
  return (int)cudaGetLastError();
}

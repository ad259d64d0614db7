// Float32 products on Hopper's tensor cores as three TF32 passes (3xTF32),
// shared by csrc/flash_prefill_tf32x3.cu and csrc/flash_bwd_tf32x3.cu.
//
// A float32 x is split into two TF32 values, hi = x rounded to TF32
// (as cvt.rna.tf32.f32 rounds: to nearest, ties away from zero; the low 13
// mantissa bits cleared) and lo = x - hi rounded the same way (x - hi is
// exact in float32), so hi + lo holds x to about 2^-21 of |x|. A product
// a . b is then lo_a . hi_b + hi_a . lo_b + hi_a . hi_b, the two small
// terms first, each an mma.sync.m16n8k8 TF32 product accumulated in
// float32 into one accumulator (a zeroed one per block of a long sum,
// `acc_cb`); lo_a . lo_b (about 2^-22 of the product) is dropped. That
// keeps float32's accuracy: the split is what does it, not TF32
// arithmetic, and PyTorch's allow_tf32 flags (which govern its own GEMMs)
// have no bearing on it. One TF32 pass alone would err by about 1e-3 on
// attention's products (kernels/ref.py::tf32x3_matmul emulates both).
//
// Fragments (PTX ISA, mma.m16n8k8 with .tf32): lane = 4 g + t (g the
// group, t the thread in the group). A (16 x 8, row): a0 (g, t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4). B (8 x 8, col): b0 (t, g),
// b1 (t + 4, g). C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
// c3 (g + 8, 2t + 1).
//
// A product whose A operand is another product's C tile (P . V, dS . K,
// P^T . dO, dS^T . Q) reads it from registers with no shuffle by
// permuting the summed axis inside each slice of 8: A's column t is the
// slice's element 2t and column t + 4 element 2t + 1, so a = (c0, c2, c1,
// c3); the B operand reads the same permutation (rows 2t and 2t + 1 of
// its slice). A sum does not depend on the order of its terms' indices,
// only on the order of the additions, which the mma does in hardware.
//
// Shared-memory tiles are float32 rows of D + 4 floats (D a multiple of
// 16): the row-wise fragment reads (bank 4g + t, or 20g + t at D 80) and
// the permuted column-wise ones (bank 8t + g) are free of bank conflicts.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when `valid` is
// false (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) of an (L, D) slice (row stride `stride` floats) into
// a shared tile of row stride D + 4 by cp.async, rows at or past L zero.
// Not committed: the caller commits the group.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void stage_async(float* dst, const float* src,
                                            long long stride, int r0, int L) {
  constexpr int CHUNKS = D / 4;
  for (int e = threadIdx.x; e < ROWS * CHUNKS; e += THREADS) {
    const int r = e / CHUNKS;
    const int c = (e - r * CHUNKS) * 4;
    const bool valid = r0 + r < L;
    cp_async16(dst + r * (D + 4) + c,
               valid ? src + (long long)(r0 + r) * stride + c : src, valid);
  }
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero; the low 13 bits cleared), in integer arithmetic: adding half
// a TF32 ulp to the magnitude bits carries into bit 13 exactly when the
// dropped bits are half an ulp or more. The same bits as cvt.rna for
// finite x, on the integer units: conversions issue at 16 lanes a clock
// on an SM, integer adds and logic ops at 64 or more.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi = x rounded to TF32, lo = x - hi (exact in float32) rounded to TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// c += a . b, one TF32 pass.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A split operand of one mma: 4 values (A) or 2 (B), hi and lo.
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
};

template <int N>
__device__ __forceinline__ Frag<N> split_frag(const float (&x)[N]) {
  Frag<N> f;
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], f.hi[i], f.lo[i]);
  return f;
}

// c += a . b in three passes: lo . hi, hi . lo, then hi . hi.
__device__ __forceinline__ void mma3(float (&c)[4], const Frag<4>& a,
                                     const Frag<2>& b) {
  mma(c, a.lo, b.hi);
  mma(c, a.hi, b.lo);
  mma(c, a.hi, b.hi);
}

// A fragment of a row-major tile (rows m, columns k; row stride S): rows
// m0 + g and m0 + g + 8, columns k0 + t and k0 + t + 4, times `mul`.
template <int S>
__device__ __forceinline__ Frag<4> a_rows(const float* A, int m0, int k0,
                                          int g, int t, float mul = 1.f) {
  const float* p = A + (m0 + g) * S + k0 + t;
  const float x[4] = {p[0] * mul, p[8 * S] * mul, p[4] * mul,
                      p[8 * S + 4] * mul};
  return split_frag(x);
}

// B fragment from a tile holding B^T row-major (rows n, columns k): row
// n0 + g, columns k0 + t and k0 + t + 4, times `mul`.
template <int S>
__device__ __forceinline__ Frag<2> b_rows(const float* Bt, int n0, int k0,
                                          int g, int t, float mul = 1.f) {
  const float* p = Bt + (n0 + g) * S + k0 + t;
  const float x[2] = {p[0] * mul, p[4] * mul};
  return split_frag(x);
}

// B fragment from a row-major tile (rows k, columns n) in the permuted
// order: rows k0 + 2t and k0 + 2t + 1, column n0 + g.
template <int S>
__device__ __forceinline__ Frag<2> b_cols(const float* B, int k0, int n0,
                                          int g, int t) {
  const float* p = B + (k0 + 2 * t) * S + n0 + g;
  const float x[2] = {p[0], p[S]};
  return split_frag(x);
}

// A fragment of the 8-column slice of a C tile (c0..c3 of one n tile), in
// the permuted order.
__device__ __forceinline__ Frag<4> a_from_c(const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  return split_frag(x);
}

// S-like tile: c[j] = A(rows m0.., all D columns) . Bt(rows 8j.., all D
// columns)^T for the 8 n tiles j (64 columns of c), B's values times
// `bmul`; A and Bt row-major of row stride S. The passes go pass by pass
// over the 8 independent accumulators, so no mma waits on the one before.
template <int S, int D>
__device__ __forceinline__ void tile_abt(float (&c)[8][4], const float* A,
                                         int m0, const float* Bt, int g,
                                         int t, float bmul = 1.f) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < D; kk += 8) {
    const Frag<4> a = a_rows<S>(A, m0, kk, g, t);
    Frag<2> b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = b_rows<S>(Bt, 8 * j, kk, g, t, bmul);
#pragma unroll
    for (int j = 0; j < 8; ++j) mma(c[j], a.lo, b[j].hi);
#pragma unroll
    for (int j = 0; j < 8; ++j) mma(c[j], a.hi, b[j].lo);
#pragma unroll
    for (int j = 0; j < 8; ++j) mma(c[j], a.hi, b[j].hi);
  }
}

// acc += c . B: c a 16 x 64 C tile in registers (P or dS, the A operand in
// the permuted order), B a row-major 64 x D tile of row stride S. The
// n tiles go NG at a time into zeroed accumulators (the passes of the NG
// interleaved), which are then added to acc: the tensor cores' float32
// accumulation truncates, so a long chain of mmas into one large
// accumulator drifts toward zero (about half an ulp of it each), while
// these adds round to nearest.
template <int S, int NT>
__device__ __forceinline__ void acc_cb(float (&acc)[NT][4],
                                       const float (&c)[8][4], const float* B,
                                       int g, int t) {
  constexpr int NG = NT % 4 == 0 ? 4 : 2;
  Frag<4> a[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j] = a_from_c(c[j]);
#pragma unroll
  for (int n0 = 0; n0 < NT; n0 += NG) {
    float part[NG][4];
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      Frag<2> b[NG];
#pragma unroll
      for (int i = 0; i < NG; ++i)
        b[i] = b_cols<S>(B, 8 * j, 8 * (n0 + i), g, t);
#pragma unroll
      for (int i = 0; i < NG; ++i) mma(part[i], a[j].lo, b[i].hi);
#pragma unroll
      for (int i = 0; i < NG; ++i) mma(part[i], a[j].hi, b[i].lo);
#pragma unroll
      for (int i = 0; i < NG; ++i) mma(part[i], a[j].hi, b[i].hi);
    }
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + i][e] += part[i][e];
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Above 48 KB of shared memory only after an opt-in, made once per device
// and instantiation (so a launch captured into a CUDA graph makes no call).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t (&allowed)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > allowed[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed[dev] = smem;
  }
  return cudaSuccess;
}

}  // namespace tf32x3

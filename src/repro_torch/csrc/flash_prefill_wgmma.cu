// Flash attention prefill for Hopper: bf16 q, k, v with head dim 64, 80,
// 96, 128 or 192, tensor-core products (wgmma) on tiles that TMA copies
// into shared memory.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel, pallas_call at :83) for the prefill
// shapes of the LM path; `kernels/flash_attention.py::route` sends bf16
// calls with Lq > 1 and D in {64, 80, 96, 128, 192} here. The function is the
// reference's, per head:
//
//   s   = (q . k^T) * scale              in float32 (the scale on s, in
//                                        float32: q is never rescaled)
//   s   = masked where k_pos > q_pos + kv_offset       (under `causal`)
//   online softmax over key blocks, out = acc / max(l, 1e-30) in bf16
//
// with a batch axis (q (B, Lq, H, D), k/v (B, Lk, KVH, D)) and grouped-query
// heads read in place (query head h reads KV head h / (H / KVH)).
//
// Bound on this card. At the LM main path's prefill (B 4, L 2048, H 24,
// KVH 8, D 128, causal) the work is 4*B*H*(L(L+1)/2)*D = 103 GFLOP, 0.104
// ms at the 989 TFLOP/s bf16 tensor-core peak, against 134 MB of q, k, v
// and out (0.040 ms at 3.35 TB/s): operations bound it, and only wgmma
// reaches that rate. phi-3-vision's prefill (H = KVH 32, D 96) does the
// same work; zamba2's shared block (H = KVH 32, D 80) 86 GFLOP, 0.087 ms.
// nemotron-4-340b's attention (B 1, L 4096, H 96, KVH 8, D 192, causal)
// is 619 GFLOP, 0.626 ms.
//
// Design. A CTA owns 128 query rows of one (head, batch): two consumer
// warpgroups of 64 rows each and one producer warp (288 threads).
// - Copies. One producer thread issues TMA loads (cp.async.bulk.tensor,
//   4-D maps over (D, heads, L, B), completion counted in bytes on an
//   mbarrier): the query tile once, then K and V blocks of BK keys (128;
//   64 at D 192) into a ring of two stages, each stage with its own K-full, V-full and free
//   barrier; so the next block's copies run while this one's products do.
//   A row is one (D 64), two (D 80, 96, 128) or three (D 192) 64-column
//   boxes (128 bytes
//   each, the widest the 128-byte swizzle takes); each box lands as rows
//   of 128 bytes, swizzled, at the 1024-byte alignment wgmma's swizzle
//   atom needs. TMA fills reads past L (or past the batch) with zeros, and
//   past D: the second box of D 80 (96) reads 16 (32) real columns, so
//   device memory moves only real bytes, while the barriers count whole
//   boxes, zeros included, as TMA does.
// - S = Q . K^T: wgmma m64n{BK}k16 per 16 columns of D (D / 16 k steps:
//   4, 5, 6, 8 or 12, never into the zero fill), both operands K-major in
//   shared memory (descriptor start advanced 32 bytes per k step inside a
//   swizzled row, one box per 64 columns); the 64 x BK float32 tile
//   stays in registers.
// - Softmax on those registers: s * (scale * log2 e), the mask (only on a
//   block that holds a key past Lk or past the causal limit of the
//   warpgroup's first row: the diagonal block), row max over the four
//   lanes that hold a row (shuffles), exp2 of s - m, running max and
//   sum per row (the sum's lane shares added once at the end), acc
//   rescaled in registers.
// - O += P . V: P goes to bf16 in registers, and its accumulator layout is
//   wgmma's register-A layout for k16 slices, so no shuffle; V is read in
//   place as an MN-major B operand (the transpose bit that 16-bit types
//   allow), no transposing copy, by one wgmma of N = D (80 and 96 are
//   legal widths: the product reads the second box's first 16 or 32
//   columns and the accumulator holds D / 2 floats a thread).
// - D 192: O takes 96 registers a thread; with S (BK / 2) and P (BK / 4)
//   at BK 128 a consumer would need 192 for those alone, past the 224
//   that 288 threads a CTA leave it with the addresses and the softmax's
//   state. A block of 64 keys halves S and P (32 and 16), so the same two
//   consumer warpgroups and producer warp fit without giving registers
//   back (no setmaxnreg); the price is twice as many softmax rounds and
//   barrier waits per key, each on half the work. Shared memory holds
//   the 128 x 192 query tile and two stages of 64-key K and V blocks,
//   144 KiB.
// - Causal: a CTA loads only the blocks up to its last row's limit, and the
//   grid is ordered heaviest query block first, so the short blocks of
//   the causal triangle fill the last wave. Rows at or past Lq are not
//   stored; keys at or past Lk are masked (TMA gave them zeros).
// - Log-sum-exp: given an `lse` output (the training forward, whose
//   backward is flash_bwd_wgmma.cu), each row's natural log-sum-exp
//   (m + log2 l) . ln 2 is written beside the output, one float a row;
//   with a null pointer (serving) nothing more is written.
// - Arithmetic: products in float32 on the tensor cores from bf16 inputs
//   (P rounded to bf16 as the A operand), softmax in float32 with the
//   special-function unit's ex2.approx in place of exp2f (both well
//   inside bf16's rounding).
// Left for later: overlap of one block's softmax with the next block's
// wgmma inside a warpgroup (it needs a second S and P in registers, past
// the 168 that ptxas gives the D 128 kernel), a persistent grid, fp8; D
// a producer warpgroup whose registers the consumers take (setmaxnreg),
// which would let D 192 keep blocks of 128 keys.
#include "hopper.cuh"

namespace {

constexpr int BQ = 128;               // query rows per CTA
constexpr int STAGES = 2;             // K/V ring depth
constexpr int CONSUMERS = 256;        // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp

// Keys per block: 128, or 64 at D 192 (its registers; design above).
template <int D>
__host__ __device__ constexpr int block_keys() { return D > 128 ? 64 : 128; }

// D: the head dim, 64, 80, 96, 128 or 192 (one to three 64-column boxes a
// row).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_prefill_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ lse, int Lq, int Lk, int H,
                         int KVH, int B, float scale, int causal,
                         int kv_offset) {
  constexpr int BOXES = boxes<D>();
  constexpr int BK = block_keys<D>();
  // Whole boxes, the zero fill past D included: what lands in shared
  // memory and what TMA counts on the barriers.
  constexpr int Q_BYTES = BQ * BOXES * ROW;
  constexpr int KV_BYTES = BK * BOXES * ROW;
  constexpr int NS = BK / 2;   // S registers per thread (64 x BK tile)
  constexpr int NO = D / 2;    // O registers per thread (64 x D tile)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sk = sq + Q_BYTES;
  uint8_t* sv = sk + STAGES * KV_BYTES;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sv + STAGES * KV_BYTES);
  uint64_t* bar_k = bar_q + 1;
  uint64_t* bar_v = bar_k + STAGES;
  uint64_t* bar_free = bar_v + STAGES;

  // Heaviest query block first: the grid's first H*B CTAs take the last
  // block of every (head, batch).
  const int nq = (Lq + BQ - 1) / BQ;
  const int hb = H * B;
  const int qblk = nq - 1 - (int)(blockIdx.x / hb);
  const int h = (int)(blockIdx.x % hb) % H;
  const int b = (int)(blockIdx.x % hb) / H;
  const int kvh = h / (H / KVH);
  const int q0 = qblk * BQ;
  long long n_keys = Lk;
  if (causal)
    n_keys = min(n_keys, (long long)min(q0 + BQ, Lq) + kv_offset);
  const int n_blocks = (int)((n_keys + BK - 1) / BK);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&bar_k[s], 1);
      mbar_init(&bar_v[s], 1);
      mbar_init(&bar_free[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // Producer: one thread keeps the ring full.
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(bar_q, Q_BYTES);
      for (int x = 0; x < BOXES; ++x)
        tma_load(sq + x * BQ * ROW, &tm_q, bar_q, 64 * x, h, q0, b);
      for (int j = 0; j < n_blocks; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&bar_free[s], ((j / STAGES) - 1) & 1);
        mbar_expect_tx(&bar_k[s], KV_BYTES);
        for (int x = 0; x < BOXES; ++x)
          tma_load(sk + s * KV_BYTES + x * BK * ROW, &tm_k, &bar_k[s],
                   64 * x, kvh, j * BK, b);
        mbar_expect_tx(&bar_v[s], KV_BYTES);
        for (int x = 0; x < BOXES; ++x)
          tma_load(sv + s * KV_BYTES + x * BK * ROW, &tm_v, &bar_v[s],
                   64 * x, kvh, j * BK, b);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows q0 + 64 wg .. + 63. In wgmma's
  // accumulator layout thread (warp w, lane) holds rows 16 w + lane / 4
  // and that + 8, columns 8 j + 2 (lane % 4) + {0, 1} for every j:
  // register 4 j + 2 i + c is (row + 8 i, column 8 j + 2 (lane % 4) + c).
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int wg_row0 = q0 + 64 * wg;
  const int row0 = wg_row0 + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  const float c2 = scale * kLog2e;

  float o[NO];
#pragma unroll
  for (int x = 0; x < NO; ++x) o[x] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  uint32_t pa[BK / 16][4];

  const uint32_t q_addr = smem_u32(sq) + wg * 64 * ROW;
  mbar_wait(bar_q, 0);

  for (int j = 0; j < n_blocks; ++j) {
    const int s = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    const uint32_t k_addr = smem_u32(sk + s * KV_BYTES);
    const uint32_t v_addr = smem_u32(sv + s * KV_BYTES);
    const int k0 = j * BK;

    // S = Q . K^T, 64 x BK, float32 in registers.
    float sc[NS];
    mbar_wait(&bar_k[s], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // inside the swizzled row
      wgmma_ss_nk<BK>(sc,
                      sdesc(q_addr + (kk / 4) * BQ * ROW + off, 16, 1024),
                      sdesc(k_addr + (kk / 4) * BK * ROW + off, 16, 1024),
                      kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(sc);

#pragma unroll
    for (int x = 0; x < NS; ++x) sc[x] *= c2;
    if (k0 + BK > Lk || (causal && k0 + BK - 1 > wg_row0 + kv_offset)) {
#pragma unroll
      for (int x = 0; x < NS; ++x) {
        const int key = k0 + 8 * (x / 4) + col0 + (x % 2);
        const int row = row0 + 8 * ((x / 2) % 2);
        if (key >= Lk || (causal && key > row + kv_offset))
          sc[x] = -INFINITY;
      }
    }

    // Online softmax per row (in log2 units: sc holds s * scale * log2 e).
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int jj = 0; jj < NS / 4; ++jj)
        mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * i], sc[4 * jj + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // A row with no visible key yet keeps m = -inf: p = 0, alpha = 1.
      const float base = mx == -INFINITY ? 0.f : mx;
      alpha[i] = exp2_approx(m[i] - base);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < NS / 4; ++jj) {
        const float p0 = exp2_approx(sc[4 * jj + 2 * i] - base);
        const float p1 = exp2_approx(sc[4 * jj + 2 * i + 1] - base);
        sc[4 * jj + 2 * i] = p0;
        sc[4 * jj + 2 * i + 1] = p1;
        sum += p0 + p1;
      }
      l[i] = l[i] * alpha[i] + sum;   // this thread's share of the row
    }
#pragma unroll
    for (int x = 0; x < NO; ++x) o[x] *= alpha[(x / 2) % 2];
    // P to bf16: the accumulator's columns 16 kk .. 16 kk + 15 are
    // registers 8 kk .. 8 kk + 7, in the order of wgmma's A fragment.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

    // O += P . V, V (keys x D) read as an MN-major B: 16 keys per step
    // (two 8-row groups, 1024 bytes apart), one 64-column box per 128-byte
    // swizzle atom along D (boxes BK * 128 bytes apart).
    mbar_wait(&bar_v[s], parity);
    hold(o);
    hold(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_rs_nd<D>(o, pa[kk],
                     sdesc(v_addr + kk * 16 * ROW, BK * ROW, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(o);
    hold(pa);
    mbar_arrive(&bar_free[s]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float denom = fmaxf(sum, 1e-30f);
    const int row = row0 + 8 * i;
    if (row >= Lq) continue;
    // The row's natural log-sum-exp, (m + log2 l) . ln 2 (m in log2 units;
    // -inf for a row with no visible key), for the backward.
    if (lse != nullptr && lane % 4 == 0)
      lse[((long long)b * H + h) * Lq + row] = (m[i] + log2f(sum)) * kLn2;
    __nv_bfloat16* orow = out + (((long long)b * Lq + row) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < NO / 4; ++jj)
      *reinterpret_cast<uint32_t*>(orow + 8 * jj + col0) =
          pack_bf16(o[4 * jj + 2 * i] / denom, o[4 * jj + 2 * i + 1] / denom);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Lq, int Lk, int H, int KVH, float scale,
           int causal, int kv_offset, cudaStream_t stream) {
  constexpr int BK = block_keys<D>();
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, B, Lq, H, D, BQ);
  if (!err) err = encode(&tk, k, B, Lk, KVH, D, BK);
  if (!err) err = encode(&tv, v, B, Lk, KVH, D, BK);
  if (err) return err;
  auto kernel = flash_prefill_kernel<D>;
  const size_t smem = 1024 + (size_t)BQ * boxes<D>() * ROW +
                      2 * STAGES * (size_t)BK * boxes<D>() * ROW +
                      (1 + 3 * STAGES) * sizeof(uint64_t);
  static bool allowed[64] = {};
  err = allow_smem(kernel, smem, allowed);
  if (err) return err;
  const long long ctas = (long long)((Lq + BQ - 1) / BQ) * H * B;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)ctas, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, Lq, Lk, H, KVH, B,
      scale, causal, kv_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes): bf16 q (B, Lq, H, D), k and v (B, Lk,
// KVH, D), out like q, contiguous and 16-byte aligned, D 64, 80, 96, 128
// or 192; lse a float32 (B, H, Lq) output of each row's natural log-sum-exp,
// or null (nothing written: the serving prefill). Returns a cudaError_t
// (0 is success), or 10000 + a CUresult of the tensor-map encoding.
extern "C" int flash_prefill_wgmma_launch(const void* q, const void* k,
                                          const void* v, void* out,
                                          void* lse, int B, int Lq, int Lk,
                                          int H, int KVH, int D, float scale,
                                          int causal, int kv_offset,
                                          void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || KVH < 1 || H < 1 || H % KVH ||
      kv_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (D == 64)
    return launch<64>(q, k, v, out, l, B, Lq, Lk, H, KVH, scale, causal,
                      kv_offset, s);
  if (D == 80)
    return launch<80>(q, k, v, out, l, B, Lq, Lk, H, KVH, scale, causal,
                      kv_offset, s);
  if (D == 96)
    return launch<96>(q, k, v, out, l, B, Lq, Lk, H, KVH, scale, causal,
                      kv_offset, s);
  if (D == 128)
    return launch<128>(q, k, v, out, l, B, Lq, Lk, H, KVH, scale, causal,
                       kv_offset, s);
  if (D == 192)
    return launch<192>(q, k, v, out, l, B, Lq, Lk, H, KVH, scale, causal,
                       kv_offset, s);
  return (int)cudaErrorInvalidValue;
}

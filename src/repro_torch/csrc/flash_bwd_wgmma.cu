// Gradient of flash attention for Hopper: bf16 q, k, v, o and do with head
// dim 64, 80, 96, 128 or 192, tensor-core products (wgmma) on tiles that TMA
// copies into shared memory, reading the log-sum-exp that the forward
// (flash_prefill_wgmma.cu) wrote.
//
// Replaces no TPU kernel: the reference differentiates its jnp blocked
// scan (repro/models/attention.py, _run_q_blocks), and its Pallas kernel
// repro/kernels/flash_attention.py::flash_attention has no VJP. It is the
// `wgmma` route of the backward (`kernels/flash_attention.py::route_bwd`:
// bf16, L > 1, D in {64, 80, 96, 128, 192}); csrc/flash_attention_bwd.cu (the
// `simt` route) takes float32 and the other head dims. Per head, with
// lse the forward's natural log-sum-exp of each query row:
//
//   s   = (q . k^T) * scale in float32; under `causal` a key after its
//         query takes no part
//   P   = exp(s - lse)
//   dv  = P^T . do
//   dP  = do . v^T,  Delta = rowsum(do o o)
//   dS  = P o (dP - Delta)
//   dq  = scale * dS . k,  dk = scale * dS^T . q
//
// with a batch axis (q, o, do (B, L, H, D), k/v (B, L, KVH, D)) and query
// head h reading KV head h / (H / KVH); dk and dv sum over the H/KVH query
// heads of each KV head. P and dS are rounded to bf16 as the register-A
// operands of their products (the plain version rounds them the same way:
// kernels/ref.py::flash_attention_bwd_ref with `lse`); every product
// accumulates in float32; dq, dk and dv are stored in bf16.
//
// Bound on this card. At the training shape (B 1, L 4096, H 24, KVH 8,
// D 128, causal) the gradient's five products of the visible (query, key)
// pairs, L(L+1)/2 . D each a head, are 258 GFLOP, 0.261 ms at the 989
// TFLOP/s bf16 tensor-core peak, against 134 MB of q, k, v, o, do, dq, dk
// and dv (0.040 ms at 3.35 TB/s): operations bound it, and only wgmma
// reaches that rate. This design does seven products (s and dP in both
// launches), 0.365 ms at the peak. nemotron-4-340b's attention (B 1, L
// 4096, H 96, KVH 8, D 192, causal) is 1.546 TFLOP, 1.563 ms at the peak;
// its three launches do eight products, 2.50 ms at the peak.
//
// Design. Two launches on one stream, no atomics, so every run gives the
// same bits. Each CTA is two consumer warpgroups and one producer
// warpgroup (384 threads); the producer gives its registers back
// (setmaxnreg to 24) and the consumers take them (240), since dk and dv
// live in registers. One producer thread issues every TMA copy (4-D maps
// over (D, heads, L, B), 64-column boxes, 128-byte swizzle, zero fill past
// L and past D, as in the forward) into a two-stage ring of mbarriers;
// consumers arrive on a stage's free barrier when done with it, and wait
// for every stage's full barriers even when they skip its products, so a
// warpgroup never runs a phase ahead.
//   flash_bwd_dq_kernel, one CTA per (128 query rows, head, batch), a
//     warpgroup per 64 rows. Q and dO of the rows are loaded once; K and V
//     blocks of 64 keys stream through the ring. Each row's Delta is
//     summed from o and do in global memory first (the four lanes that
//     hold a row in wgmma's layout share its columns) and written to a
//     float32 (B, H, L) scratch for the second launch. Per key block:
//     S = Q . K^T and dP = dO . V^T (wgmma from shared memory, K-major),
//     P = exp2(s * scale * log2 e - lse * log2 e) (no pass over the keys
//     for the max), dS = P o (dP - Delta) packed to bf16 in registers, and
//     dQ += dS . K with dS as the register-A operand and K read MN-major
//     (the transpose bit). Query blocks run longest first.
//   flash_bwd_dkdv_kernel, one CTA per (128 keys, KV head, batch), a
//     warpgroup per 64 keys. K and V of the block are loaded once; the CTA
//     loops over the group's query heads and over the query blocks of 64
//     rows that can see its keys (from its own block on, under `causal`),
//     streaming Q and dO through the ring by TMA, and the rows' lse and
//     Delta by a second producer warp (plain loads and shared stores: a
//     row of L floats need not start on the 16 bytes TMA wants). Per
//     block: S^T = K . Q^T and dP^T = V . dO^T, P^T and dS^T as above,
//     then dV += P^T . dO and dK += dS^T . Q, both bf16 register-A
//     operands against MN-major Q and dO. dK and dV stay in float32
//     registers (D / 2 floats each a thread) for the whole loop: the GQA
//     sum stays inside the CTA. Key blocks run longest first.
//   At D 192 dK and dV are 96 floats each a thread; with S^T and dP^T
//     (32 each) and the bf16 P^T and dS^T they pass the 240 registers a
//     consumer can take. So D 192 splits the second launch in two of the
//     same kernel, each keeping one accumulator: a dv launch (S^T, P^T,
//     dV += P^T . dO; V is not loaded) and then a dk launch (S^T, dP^T,
//     dS^T, dK += dS^T . Q). Eight products where the fused launch does
//     seven, and Q and dO are streamed twice, but still no atomics and the
//     same bits every run; the alternative, dK in shared memory, would
//     take 48 KiB of the 227 beside the 192 that the tiles of 128 keys and
//     the ring already hold, and a read-modify-write of it per block.
// Causal: a block wholly after a warpgroup's rows is skipped; only the
// diagonal blocks (and a ragged last block) are masked. Rows past L are
// not stored; queries and keys past L read zeros from TMA and are masked.
// Left for later: overlap of one block's elementwise work with the next
// block's products (a second set of S and dP registers), a deeper ring, a
// persistent grid.
#include "hopper.cuh"

namespace {

constexpr int CONSUMERS = 256;             // two warpgroups
constexpr int THREADS = CONSUMERS + 128;   // and a producer warpgroup
constexpr int STAGES = 2;                  // ring depth
constexpr int DQ_ROWS = 128;               // dq: query rows a CTA
constexpr int DQ_KEYS = 64;                // dq: keys a block
constexpr int KV_ROWS = 128;               // dk/dv: keys a CTA
constexpr int KV_QUERIES = 64;             // dk/dv: query rows a block
constexpr int VEC_BYTES = KV_QUERIES * 4;  // a block's float32 lse or Delta
constexpr int NS = 32;                     // registers of a 64 x 64 tile
// What a dk/dv launch computes: both (D up to 128), or at D 192 one of
// them (design above).
constexpr int DKDV = 0, DV_ONLY = 1, DK_ONLY = 2;

__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Stores a 64 x D float32 accumulator's two rows of this thread, times
// `scale`, as bf16 into rows of `ld` elements (rows at or past L skipped).
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long ld,
                                           int row0, int col0, int L,
                                           const float (&acc)[D / 2],
                                           float scale) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= L) continue;
    __nv_bfloat16* p = base + row * ld;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<uint32_t*>(p + 8 * jj + col0) =
          pack_bf16(acc[4 * jj + 2 * i] * scale,
                    acc[4 * jj + 2 * i + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __nv_bfloat16* __restrict__ o,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        __nv_bfloat16* __restrict__ dq,
                        float* __restrict__ delta, int L, int H, int KVH,
                        int B, float scale, int causal) {
  constexpr int BOXES = boxes<D>();
  constexpr int Q_BYTES = DQ_ROWS * BOXES * ROW;
  constexpr int KV_BYTES = DQ_KEYS * BOXES * ROW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);
  uint8_t* sdo = sq + Q_BYTES;
  uint8_t* sk = sdo + Q_BYTES;
  uint8_t* sv = sk + STAGES * KV_BYTES;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sv + STAGES * KV_BYTES);
  uint64_t* bar_k = bar_q + 1;
  uint64_t* bar_v = bar_k + STAGES;
  uint64_t* bar_free = bar_v + STAGES;

  // Heaviest query block first: the grid's first H*B CTAs take the last
  // block of every (head, batch).
  const int nq = (L + DQ_ROWS - 1) / DQ_ROWS;
  const int hb = H * B;
  const int qblk = nq - 1 - (int)(blockIdx.x / hb);
  const int h = (int)(blockIdx.x % hb) % H;
  const int b = (int)(blockIdx.x % hb) / H;
  const int kvh = h / (H / KVH);
  const int q0 = qblk * DQ_ROWS;
  const int n_keys = causal ? min(L, q0 + DQ_ROWS) : L;
  const int n_blocks = (n_keys + DQ_KEYS - 1) / DQ_KEYS;

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
    producer_registers();
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(bar_q, 2 * Q_BYTES);
      for (int x = 0; x < BOXES; ++x) {
        tma_load(sq + x * DQ_ROWS * ROW, &tm_q, bar_q, 64 * x, h, q0, b);
        tma_load(sdo + x * DQ_ROWS * ROW, &tm_do, bar_q, 64 * x, h, q0, b);
      }
      for (int j = 0; j < n_blocks; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&bar_free[s], ((j / STAGES) - 1) & 1);
        mbar_expect_tx(&bar_k[s], KV_BYTES);
        for (int x = 0; x < BOXES; ++x)
          tma_load(sk + s * KV_BYTES + x * DQ_KEYS * ROW, &tm_k, &bar_k[s],
                   64 * x, kvh, j * DQ_KEYS, b);
        mbar_expect_tx(&bar_v[s], KV_BYTES);
        for (int x = 0; x < BOXES; ++x)
          tma_load(sv + s * KV_BYTES + x * DQ_KEYS * ROW, &tm_v, &bar_v[s],
                   64 * x, kvh, j * DQ_KEYS, b);
      }
    }
    return;
  }
  consumer_registers();

  // Warpgroup wg owns rows q0 + 64 wg .. + 63; this thread rows row0 and
  // row0 + 8 (hopper.cuh's accumulator layout).
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int wg_row0 = q0 + 64 * wg;
  const int row0 = wg_row0 + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  const float c2 = scale * kLog2e;
  const long long bh = (long long)b * H + h;

  // Each row's Delta (columns col0 + 8 m of this lane, summed over the
  // row's four lanes) and lse in log2 units.
  float dlt[2], lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    float sum = 0.f;
    if (row < L) {
      const long long off = (((long long)b * L + row) * H + h) * D;
#pragma unroll
      for (int c = col0; c < D; c += 8) {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(o + off + c));
        const float2 d = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dout + off + c));
        sum += a.x * d.x + a.y * d.y;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dlt[i] = sum;
    lse2[i] = row < L ? lse[bh * L + row] * kLog2e : 0.f;
    if (row < L && lane % 4 == 0) delta[bh * L + row] = sum;
  }

  float acc[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;
  const uint32_t q_addr = smem_u32(sq) + wg * 64 * ROW;
  const uint32_t do_addr = smem_u32(sdo) + wg * 64 * ROW;
  mbar_wait(bar_q, 0);

  for (int j = 0; j < n_blocks; ++j) {
    const int s = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    const uint32_t k_addr = smem_u32(sk + s * KV_BYTES);
    const uint32_t v_addr = smem_u32(sv + s * KV_BYTES);
    const int k0 = j * DQ_KEYS;
    mbar_wait(&bar_k[s], parity);
    mbar_wait(&bar_v[s], parity);
    if (!causal || k0 <= wg_row0 + 63) {
      // S = Q . K^T and dP = dO . V^T, 64 x 64 each, in flight together.
      float sc[NS], dp[NS];
      __syncwarp();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss_n64(sc, sdesc(q_addr + (kk / 4) * DQ_ROWS * ROW + off, 16,
                               1024),
                     sdesc(k_addr + (kk / 4) * DQ_KEYS * ROW + off, 16, 1024),
                     kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss_n64(dp, sdesc(do_addr + (kk / 4) * DQ_ROWS * ROW + off, 16,
                               1024),
                     sdesc(v_addr + (kk / 4) * DQ_KEYS * ROW + off, 16, 1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      hold(sc);
      // Register x holds key k0 + col0 + 8 (x / 4) + x % 2: of row i it
      // keeps keys below L and, under `causal`, at or before the row,
      // i.e. 8 (x / 4) + x % 2 < lim[i].
      if ((causal && k0 + DQ_KEYS - 1 > wg_row0) || k0 + DQ_KEYS > L) {
        int lim[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          lim[i] = causal ? min(L, row0 + 8 * i + 1) - k0 - col0
                          : L - k0 - col0;
#pragma unroll
        for (int x = 0; x < NS; ++x)
          sc[x] = 8 * (x / 4) + x % 2 < lim[(x / 2) % 2]
                      ? exp2_approx(sc[x] * c2 - lse2[(x / 2) % 2])
                      : 0.f;
      } else {
#pragma unroll
        for (int x = 0; x < NS; ++x)
          sc[x] = exp2_approx(sc[x] * c2 - lse2[(x / 2) % 2]);
      }
      wgmma_wait<0>();
      hold(dp);
      // dS = P o (dP - Delta) in bf16: wgmma's A fragment of keys
      // 16 kk .. 16 kk + 15 is registers 8 kk .. 8 kk + 7.
      uint32_t da[DQ_KEYS / 16][4];
#pragma unroll
      for (int kk = 0; kk < DQ_KEYS / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int x = 8 * kk + 2 * r;
          da[kk][r] = pack_bf16(sc[x] * (dp[x] - dlt[r % 2]),
                                sc[x + 1] * (dp[x + 1] - dlt[r % 2]));
        }
      // dQ += dS . K, K (keys x D) read as an MN-major B.
      hold(acc);
      hold(da);
      __syncwarp();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_KEYS / 16; ++kk)
        wgmma_rs_nd<D>(acc, da[kk],
                       sdesc(k_addr + kk * 16 * ROW, DQ_KEYS * ROW, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      hold(acc);
      hold(da);
    }
    mbar_arrive(&bar_free[s]);
  }
  store_rows<D>(dq + ((long long)b * L * H + h) * D, (long long)H * D, row0,
                col0, L, acc, scale);
}

template <int D, int PART>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int L, int H,
                          int KVH, int B, float scale, int causal) {
  constexpr int BOXES = boxes<D>();
  constexpr int KV_BYTES = KV_ROWS * BOXES * ROW;
  constexpr int QB_BYTES = KV_QUERIES * BOXES * ROW;
  constexpr bool WANT_DV = PART != DK_ONLY, WANT_DK = PART != DV_ONLY;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = align1024(smem_raw);
  uint8_t* sv = sk + KV_BYTES;
  uint8_t* sq = sv + KV_BYTES;
  uint8_t* sdo = sq + STAGES * QB_BYTES;
  float* slse = reinterpret_cast<float*>(sdo + STAGES * QB_BYTES);
  float* sdelta = slse + STAGES * KV_QUERIES;
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(sdelta + STAGES * KV_QUERIES);
  uint64_t* bar_q = bar_kv + 1;
  uint64_t* bar_do = bar_q + STAGES;
  uint64_t* bar_free = bar_do + STAGES;

  // Heaviest key block first: under `causal` the first keys are seen by
  // the most query blocks.
  const int kvb = KVH * B;
  const int kblk = (int)(blockIdx.x / kvb);
  const int kvh = (int)(blockIdx.x % kvb) % KVH;
  const int b = (int)(blockIdx.x % kvb) / KVH;
  const int G = H / KVH;
  const int k0 = kblk * KV_ROWS;
  const int nqb = (L + KV_QUERIES - 1) / KV_QUERIES;
  const int qb0 = causal ? k0 / KV_QUERIES : 0;
  const int per_head = nqb - qb0;
  const int n_iter = G * per_head;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      // The TMA thread's expect_tx and the copy warp's 32 lanes.
      mbar_init(&bar_q[s], 1 + 32);
      mbar_init(&bar_do[s], 1 + 32);
      mbar_init(&bar_free[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    producer_registers();
    if (threadIdx.x == CONSUMERS) {
      // V only where dP^T is taken (not in a dv launch).
      mbar_expect_tx(bar_kv, (WANT_DK ? 2 : 1) * KV_BYTES);
      for (int x = 0; x < BOXES; ++x) {
        tma_load(sk + x * KV_ROWS * ROW, &tm_k, bar_kv, 64 * x, kvh, k0, b);
        if (WANT_DK)
          tma_load(sv + x * KV_ROWS * ROW, &tm_v, bar_kv, 64 * x, kvh, k0,
                   b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int h = kvh * G + it / per_head;
        const int q0 = (qb0 + it % per_head) * KV_QUERIES;
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&bar_free[s], ((it / STAGES) - 1) & 1);
        mbar_expect_tx(&bar_q[s], QB_BYTES);
        for (int x = 0; x < BOXES; ++x)
          tma_load(sq + s * QB_BYTES + x * KV_QUERIES * ROW, &tm_q,
                   &bar_q[s], 64 * x, h, q0, b);
        mbar_expect_tx(&bar_do[s], QB_BYTES);
        for (int x = 0; x < BOXES; ++x)
          tma_load(sdo + s * QB_BYTES + x * KV_QUERIES * ROW, &tm_do,
                   &bar_do[s], 64 * x, h, q0, b);
      }
    } else if (threadIdx.x / 32 == CONSUMERS / 32 + 1) {
      // The copy warp: each block's lse and Delta (rows past L as 0) into
      // the stage, each lane arriving on the stage's barrier after its
      // stores (an arrive releases them to the consumers that wait).
      const int lane = threadIdx.x % 32;
      for (int it = 0; it < n_iter; ++it) {
        const int h = kvh * G + it / per_head;
        const int q0 = (qb0 + it % per_head) * KV_QUERIES;
        const int s = it % STAGES;
        const long long row = ((long long)b * H + h) * L;
        if (it >= STAGES) mbar_wait(&bar_free[s], ((it / STAGES) - 1) & 1);
        for (int t = lane; t < KV_QUERIES; t += 32)
          slse[s * KV_QUERIES + t] = q0 + t < L ? lse[row + q0 + t] : 0.f;
        mbar_arrive(&bar_q[s]);
        for (int t = lane; t < KV_QUERIES; t += 32)
          sdelta[s * KV_QUERIES + t] = q0 + t < L ? delta[row + q0 + t] : 0.f;
        mbar_arrive(&bar_do[s]);
      }
    }
    return;
  }
  consumer_registers();

  // Warpgroup wg owns keys k0 + 64 wg .. + 63; this thread keys krow0 and
  // krow0 + 8, and query columns 8 j + col0 + {0, 1} of each block.
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int wk0 = k0 + 64 * wg;
  const int krow0 = wk0 + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  const float c2 = scale * kLog2e;

  // One accumulator of a split launch is a single unused register.
  float dka[WANT_DK ? D / 2 : 1], dva[WANT_DV ? D / 2 : 1];
#pragma unroll
  for (int x = 0; x < (WANT_DK ? D / 2 : 1); ++x) dka[x] = 0.f;
#pragma unroll
  for (int x = 0; x < (WANT_DV ? D / 2 : 1); ++x) dva[x] = 0.f;
  const uint32_t k_addr = smem_u32(sk) + wg * 64 * ROW;
  const uint32_t v_addr = smem_u32(sv) + wg * 64 * ROW;
  mbar_wait(bar_kv, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int q0 = (qb0 + it % per_head) * KV_QUERIES;
    const int s = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    const uint32_t q_addr = smem_u32(sq + s * QB_BYTES);
    const uint32_t do_addr = smem_u32(sdo + s * QB_BYTES);
    const float* ls = slse + s * KV_QUERIES;
    const float* dl = sdelta + s * KV_QUERIES;
    mbar_wait(&bar_q[s], parity);
    mbar_wait(&bar_do[s], parity);
    if (wk0 < L && (!causal || wk0 <= q0 + KV_QUERIES - 1)) {
      // S^T = K . Q^T and dP^T = V . dO^T, 64 keys x 64 queries each.
      float st[NS], dpt[NS];
      __syncwarp();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss_n64(st, sdesc(k_addr + (kk / 4) * KV_ROWS * ROW + off, 16,
                               1024),
                     sdesc(q_addr + (kk / 4) * KV_QUERIES * ROW + off, 16,
                           1024),
                     kk > 0);
      }
      wgmma_commit();
      if constexpr (WANT_DK) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss_n64(dpt, sdesc(v_addr + (kk / 4) * KV_ROWS * ROW + off,
                                  16, 1024),
                       sdesc(do_addr + (kk / 4) * KV_QUERIES * ROW + off, 16,
                             1024),
                       kk > 0);
        }
        wgmma_commit();
      }
      wgmma_wait<0>();
      hold(st);
      if constexpr (WANT_DK) hold(dpt);
      // Register x holds query q0 + col0 + 8 (x / 4) + x % 2 of key row
      // r % 2: kept when below L and, under `causal`, at or after the key,
      // i.e. lo[r % 2] <= 8 (x / 4) + x % 2 < hi (all kept off the
      // diagonal and the ragged end).
      const bool edge = (causal && wk0 + 63 > q0) || q0 + KV_QUERIES > L;
      const int hi = edge ? L - q0 - col0 : KV_QUERIES;
      int lo[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        lo[i] = edge && causal ? krow0 + 8 * i - q0 - col0 : 0;
      // P^T and dS^T in bf16, in wgmma's A fragment order (queries
      // 16 kk .. 16 kk + 15 are registers 8 kk .. 8 kk + 7).
      uint32_t pa[KV_QUERIES / 16][4], sa[KV_QUERIES / 16][4];
#pragma unroll
      for (int kk = 0; kk < KV_QUERIES / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int x = 8 * kk + 2 * r;
          const int off = 8 * (x / 4);
          const float2 lv = *reinterpret_cast<const float2*>(ls + off +
                                                              col0);
          const float2 dlv = *reinterpret_cast<const float2*>(dl + off +
                                                               col0);
          const float p0 = off >= lo[r % 2] && off < hi
                               ? exp2_approx(st[x] * c2 - lv.x * kLog2e)
                               : 0.f;
          const float p1 = off + 1 >= lo[r % 2] && off + 1 < hi
                               ? exp2_approx(st[x + 1] * c2 - lv.y * kLog2e)
                               : 0.f;
          if constexpr (WANT_DV) pa[kk][r] = pack_bf16(p0, p1);
          if constexpr (WANT_DK)
            sa[kk][r] = pack_bf16(p0 * (dpt[x] - dlv.x),
                                  p1 * (dpt[x + 1] - dlv.y));
        }
      // dV += P^T . dO and dK += dS^T . Q, dO and Q (queries x D) read as
      // MN-major B operands.
      if constexpr (WANT_DK) {
        hold(dka);
        hold(sa);
      }
      if constexpr (WANT_DV) {
        hold(dva);
        hold(pa);
      }
      __syncwarp();
      wgmma_fence();
      if constexpr (WANT_DV) {
#pragma unroll
        for (int kk = 0; kk < KV_QUERIES / 16; ++kk)
          wgmma_rs_nd<D>(dva, pa[kk], sdesc(do_addr + kk * 16 * ROW,
                                            KV_QUERIES * ROW, 1024));
      }
      if constexpr (WANT_DK) {
#pragma unroll
        for (int kk = 0; kk < KV_QUERIES / 16; ++kk)
          wgmma_rs_nd<D>(dka, sa[kk], sdesc(q_addr + kk * 16 * ROW,
                                            KV_QUERIES * ROW, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      if constexpr (WANT_DK) {
        hold(dka);
        hold(sa);
      }
      if constexpr (WANT_DV) {
        hold(dva);
        hold(pa);
      }
    }
    mbar_arrive(&bar_free[s]);
  }
  const long long base = ((long long)b * L * KVH + kvh) * D;
  if constexpr (WANT_DK)
    store_rows<D>(dk + base, (long long)KVH * D, krow0, col0, L, dka, scale);
  if constexpr (WANT_DV)
    store_rows<D>(dv + base, (long long)KVH * D, krow0, col0, L, dva, 1.f);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* dq, void* delta,
              int B, int L, int H, int KVH, float scale, int causal,
              cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv;
  int err = encode(&tq, q, B, L, H, D, DQ_ROWS);
  if (!err) err = encode(&tdo, dout, B, L, H, D, DQ_ROWS);
  if (!err) err = encode(&tk, k, B, L, KVH, D, DQ_KEYS);
  if (!err) err = encode(&tv, v, B, L, KVH, D, DQ_KEYS);
  if (err) return err;
  auto kernel = flash_bwd_dq_kernel<D>;
  const size_t smem = 1024 + 2 * (size_t)DQ_ROWS * boxes<D>() * ROW +
                      2 * STAGES * (size_t)DQ_KEYS * boxes<D>() * ROW +
                      (1 + 3 * STAGES) * sizeof(uint64_t);
  static bool allowed[64] = {};
  err = allow_smem(kernel, smem, allowed);
  if (err) return err;
  const long long ctas = (long long)((L + DQ_ROWS - 1) / DQ_ROWS) * H * B;
  kernel<<<(unsigned)ctas, THREADS, smem, stream>>>(
      tq, tdo, tk, tv, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<__nv_bfloat16*>(dq),
      static_cast<float*>(delta), L, H, KVH, B, scale, causal);
  return (int)cudaGetLastError();
}

template <int D, int PART>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, int B, int L, int H, int KVH,
                float scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv;
  int err = encode(&tq, q, B, L, H, D, KV_QUERIES);
  if (!err) err = encode(&tdo, dout, B, L, H, D, KV_QUERIES);
  if (!err) err = encode(&tk, k, B, L, KVH, D, KV_ROWS);
  if (!err) err = encode(&tv, v, B, L, KVH, D, KV_ROWS);
  if (err) return err;
  auto kernel = flash_bwd_dkdv_kernel<D, PART>;
  const size_t smem = 1024 + 2 * (size_t)KV_ROWS * boxes<D>() * ROW +
                      2 * STAGES * (size_t)KV_QUERIES * boxes<D>() * ROW +
                      2 * STAGES * VEC_BYTES +
                      (1 + 3 * STAGES) * sizeof(uint64_t);
  static bool allowed[64] = {};
  err = allow_smem(kernel, smem, allowed);
  if (err) return err;
  const long long ctas = (long long)((L + KV_ROWS - 1) / KV_ROWS) * KVH * B;
  kernel<<<(unsigned)ctas, THREADS, smem, stream>>>(
      tq, tdo, tk, tv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), L, H, KVH, B, scale, causal);
  return (int)cudaGetLastError();
}

bool valid(int B, int L, int H, int KVH, int D) {
  return B >= 1 && L >= 1 && KVH >= 1 && H >= KVH && H % KVH == 0 &&
         (D == 64 || D == 80 || D == 96 || D == 128 || D == 192);
}

}  // namespace

// C interface (bound with ctypes), bf16 q, o and do (B, L, H, D), k and v
// (B, L, KVH, D), contiguous and 16-byte aligned, D 64, 80, 96, 128 or
// 192; lse the forward's float32 (B, H, L) natural log-sum-exp. The first
// launch writes dq (like q) and Delta (float32 (B, H, L)); the second,
// after it on the same stream, reads Delta and writes dk and dv (like k):
// `part` 0 both (D up to 128), or at D 192 part 1 dv alone, then part 2 dk
// alone (the other pointer is not touched). Each returns a cudaError_t (0
// is success), or 10000 + a CUresult of the tensor-map encoding.
extern "C" int flash_bwd_wgmma_dq_launch(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* dout, const void* lse,
                                         void* dq, void* delta, int B, int L,
                                         int H, int KVH, int D, float scale,
                                         int causal, void* stream) {
  if (!valid(B, L, H, KVH, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dq<64>(q, k, v, o, dout, lse, dq, delta, B, L, H, KVH,
                           scale, causal, s);
    case 80:
      return launch_dq<80>(q, k, v, o, dout, lse, dq, delta, B, L, H, KVH,
                           scale, causal, s);
    case 96:
      return launch_dq<96>(q, k, v, o, dout, lse, dq, delta, B, L, H, KVH,
                           scale, causal, s);
    case 128:
      return launch_dq<128>(q, k, v, o, dout, lse, dq, delta, B, L, H, KVH,
                            scale, causal, s);
    default:
      return launch_dq<192>(q, k, v, o, dout, lse, dq, delta, B, L, H, KVH,
                            scale, causal, s);
  }
}

extern "C" int flash_bwd_wgmma_dkdv_launch(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse,
                                           const void* delta, void* dk,
                                           void* dv, int B, int L, int H,
                                           int KVH, int D, float scale,
                                           int causal, int part,
                                           void* stream) {
  if (!valid(B, L, H, KVH, D) ||
      (D == 192 ? part != DV_ONLY && part != DK_ONLY : part != DKDV))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dkdv<64, DKDV>(q, k, v, dout, lse, delta, dk, dv, B, L,
                                   H, KVH, scale, causal, s);
    case 80:
      return launch_dkdv<80, DKDV>(q, k, v, dout, lse, delta, dk, dv, B, L,
                                   H, KVH, scale, causal, s);
    case 96:
      return launch_dkdv<96, DKDV>(q, k, v, dout, lse, delta, dk, dv, B, L,
                                   H, KVH, scale, causal, s);
    case 128:
      return launch_dkdv<128, DKDV>(q, k, v, dout, lse, delta, dk, dv, B,
                                    L, H, KVH, scale, causal, s);
    default:
      return part == DV_ONLY
                 ? launch_dkdv<192, DV_ONLY>(q, k, v, dout, lse, delta, dk,
                                             dv, B, L, H, KVH, scale,
                                             causal, s)
                 : launch_dkdv<192, DK_ONLY>(q, k, v, dout, lse, delta, dk,
                                             dv, B, L, H, KVH, scale,
                                             causal, s);
  }
}

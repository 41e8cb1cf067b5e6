// flash_attention — attention forward with an online softmax (LM prefill).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py:84
//   ::flash_attention (_kernel; pallas_call at :107),
// with the GQA front of its ops.py.  For q (B, H, Sq, d) and k, v
// (B, KV, Sk, d), H % KV == 0, it writes o = softmax(q kᵀ · scale) v per
// head, query head h reading KV head h / (H / KV) (the mapping of
// jnp.repeat in ops.py, without the repeat).  scale = 1/√d, masked
// scores are -1e30, and key j is visible to query i iff j < Sk, j <= i
// if causal, j > i - window if windowed — the Pallas kernel's `vis`
// rule.  The reference computes in fp32: scores, p = exp(s - m), the
// P·V product, and o = acc / max(l, 1e-30) rounded once to q's type.
//
// Two Hopper routes share that function, one for each input type.
//
// ---- fp32 inputs (BERT4Rec's encoder): namespace sm90_f32 ----
//
//   Bound on the H100: operations, at 24·d flops per visible (row, key)
//   pair on the bf16 tensor cores — six split products for Q·Kᵀ and six
//   for P·V, 2·d flops each.  At BERT4Rec's serving shape (512 x 2
//   heads, S 200, d 32, non-causal: 40,960,000 pairs) that is 3.15e10
//   flops, 0.0318 ms at 989 TFLOP/s, against 104,857,600 bytes of q, k,
//   v and o (0.0313 ms at 3.35 TB/s); the function's 4·d flops at the
//   fp32 rate would take 0.078 ms.  At the LM check shape (4 x 24 heads,
//   8 KV heads, S 2,048, d 128, causal: 201,424,896 pairs) 6.19e11
//   flops, 0.626 ms, against 268 MB (0.080 ms).  The exp and the split
//   of every computed score run on the CUDA cores beside it.
//
//   Why three-term bf16 splits keep fp32.  Each fp32 value x of q, k, v
//   and p is split into hi + mid + lo, three bf16 terms (sm90.cuh's
//   note): both subtractions are exact, so hi + mid + lo == x for every
//   |x| >= ~2^-110.  A product of two bf16 terms is exact in fp32, and
//   the products dropped (mid·lo, lo·mid, lo·lo) are below 2^-24 of the
//   product, so the six kept — hi·hi into one fp32 accumulator, hi·mid,
//   mid·hi, hi·lo, mid·mid and lo·hi into a second, the two added once
//   at the end — give the fp32 dot product up to the order of its sums.
//   p in [0, 1] is split in registers from the S accumulators.  The
//   caveat: a p below ~2^-110 has a subnormal lo that may round, or be
//   flushed by the tensor cores, and the exp (ex2.approx.ftz of the
//   score times scale·log2(e)) flushes a p below 2^-126 to zero; either
//   is far below 2^-24 of the row sum, which holds a 1 (the row's max).
//
//   Design.  A persistent grid walks the items (128 query rows of one
//   batch·head; the heaviest causal rows first, item i + gridDim.x
//   next).  Two consumer warpgroups own 64 rows each; a producer
//   warpgroup fills their operands, setmaxnreg moving registers to the
//   consumers.  One producer thread streams fp32 units of Q, K and V (32
//   or 64 rows) by TMA into a ring of fp32 staging slots (3-D tensor maps
//   (d, S, B·H), out-of-bounds rows and columns zero-filled, so the tails
//   need no code); all 128 producer threads then split each unit into
//   three bf16 planes (Q times scale·log2(e) first), stored in the wgmma
//   layout: rows of DP bf16 as 64-column panels swizzled 128B, or at DP
//   32 one 64-byte row swizzled 64B (a 64-column panel would double the
//   Q·Kᵀ depth with zeros).  No pre-pass scratch in device memory, which
//   would move 4 + 6 + 6 bytes a value against 4.  A consumer warpgroup
//   runs Q·Kᵀ as 6 wgmma m64n{BK}k16 a k16 step into two S accumulators,
//   masks only tiles crossing the diagonal, the window's edge or Sk,
//   takes the online softmax in base 2, splits p three ways in the
//   A-fragment layout, and runs P·V as 6 wgmma m64n{DP}k16 a 16-key step
//   (A from registers, V MN-major) into two O accumulators.  K and V have
//   their own full and empty barriers, so the producer refills K while
//   the consumers run the softmax and P·V.  Rows past Sq are computed and
//   never stored; a warpgroup whose 64 rows all lie past Sq only releases
//   its tiles.
//
//   What bounds it at d 32 (BERT4Rec): the consumer warpgroups' chain a
//   tile — a wgmma group and its drain, the softmax and split of p on the
//   CUDA cores, a second group and drain — not the tensor cores' rate
//   and not the producer.  Two blocks share an SM there, so four consumer
//   warpgroups interleave their chains; that takes 32-key tiles, whose
//   accumulators fit the 96 registers a consumer gets.
//
//   Tiles (BQ 128 query rows; 1 KB = 1,024 bytes):
//     DP   BK  blocks/SM  Q planes  K+V a stage  stages  staging     total
//     32   32  2          24 KB     12 KB        2       4 x 4 KB    64 KB
//     64   64  1          48 KB     48 KB        2       4 x 16 KB   208 KB
//     128  64  1          96 KB     96 KB        1       2 x 16 KB   224 KB
//   each plus its barriers and 1 KB of alignment, under the 227 KB a
//   block may take (and at DP 32 two blocks' 130 KB under the SM's).  At
//   d 128, two stages of K and V (192 KB) do not fit beside Q; one stage
//   works because K and V are released apart.  Registers: a consumer
//   thread holds two S accumulators (2 x BK/2), two O accumulators (2 x
//   DP/2) and p's three terms (3 x BK/4 words, live after S): setmaxnreg
//   40 / 96 at DP 32 (80 a thread at entry, two blocks an SM), 56 / 224
//   at DP 64 and 40 / 232 at DP 128 (168 at entry); ptxas spills nothing.
//   S 200 is 6 x 32 + 8: the last key tile and the last query warpgroup
//   have 8 live keys and rows, 1.43x the pairs.
//
// ---- bf16 inputs (every launch of the LM path): namespace sm90 ----
//
//   Bound on the H100: operations.  At minitron-4b's prefill (4 x 24
//   heads, 8 KV heads, S 2,048, d 128, causal) a layer has 2,098,176
//   visible (row, key) pairs per head.  The kernel does 6·d flops per
//   pair on the bf16 tensor cores — Q·Kᵀ, P_hi·V and P_lo·V, 2·d each —
//   1.55e11 flops, 0.156 ms at 989 TFLOP/s, against 134 MB of q, k, v
//   and o (0.040 ms at 3.35 TB/s).  The exp of every visible score runs
//   on the CUDA cores beside it.
//
//   Why P·V may run on bf16 tensor cores.  V is bf16, so it is exact in
//   bf16.  p in [0, 1] is fp32; write p = p_hi + p_lo + r with p_hi =
//   bf16(p) and p_lo = bf16(p - p_hi): |r| <= 2^-9 |p - p_hi| <= 2^-17 p.
//   The products p_hi·v and p_lo·v are exact in fp32 and are summed in
//   the fp32 accumulator, so P·V is computed to about 2^-17 relative,
//   far inside the one bf16 rounding of the output (2^-9).  Q·Kᵀ takes
//   bf16 q and k, whose products are exact in fp32 as well.  l sums the
//   fp32 p, as the reference does.
//
//   Design.  One block owns 128 query rows of one (batch·head), as two
//   consumer warpgroups of 64 rows, plus a producer warpgroup; setmaxnreg
//   moves registers from the producer (24) to the consumers (240).  One
//   producer thread issues TMA loads (cp.async.bulk.tensor) through 3-D
//   tensor maps (d, S, B·H): Q once, then K and V tiles of BK = 128 keys
//   into a ring of two stages, each with its own full barrier for K and
//   for V and one empty barrier that the eight consumer warps release.
//   A tile row of d bf16 is stored as 64-column panels of 128 bytes,
//   swizzled 128B (d <= 64: one panel; 64 < d <= 128: two).  TMA's
//   out-of-bounds zero fill covers the Sk and Sq tails and the columns
//   past a d that is a multiple of 8 but not of the 16-deep wgmma; the
//   3-D map keeps a tile from reading the next head's rows.  A consumer
//   warpgroup computes its 64 x 128 S with wgmma m64n128k16 (Q and K
//   K-major from shared memory, fp32 accumulators), masks only tiles
//   that cross the diagonal, the window's edge or Sk, takes row max and
//   sum with quad shuffles, rescales its 64 x d O accumulator, splits p
//   into p_hi and p_lo in registers — the S accumulator's layout is the
//   A fragment's, so p never goes through shared memory — and issues
//   two wgmma m64n{d}k16 with A from registers and V from shared memory
//   (MN-major) into O.  Rows past Sq are computed and never stored.
//
//   Tile skipping (both routes).  A K tile that holds no column visible
//   to any row of the query tile (wholly above the causal diagonal, or
//   wholly left of the window) is not loaded, and a warpgroup also
//   skips a loaded tile that none of its own 64 rows sees.  That is the
//   same function: before a row's first visible tile, a wholly masked
//   tile gives it m = -1e30 and p = exp(0) = 1 for every column, which
//   the next visible tile wipes with alpha = exp(-1e30 - m_new) = 0 (the
//   Pallas _init does the same); after it, such a tile gives p = 0 and
//   alpha = 1.  Every row must see at least one key (with causal masking
//   each row sees its own diagonal); the wrapper raises where a window
//   leaves a row nothing.  The heaviest causal query tiles (the last
//   rows) are dispatched first.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

// ---- bf16 inputs: the Hopper kernel ----

namespace sm90 {

constexpr int BQ = 128;       // query rows per block: two warpgroups of 64
constexpr int BK = 128;       // keys per K/V tile
constexpr int STAGES = 2;     // K/V ring depth
constexpr int PANEL = 64;     // bf16 columns in one 128-byte swizzled row
constexpr int NT = 384;       // consumer warpgroups 0 and 1, producer 2
constexpr int CONSUMER_WARPS = 8;
constexpr float NEG = -1e30f;

__device__ __forceinline__ bool visible(int row, int col, int Sk, int causal,
                                        int window) {
  return col < Sk && (!causal || col <= row) &&
         (window <= 0 || col > row - window);
}

// Shared memory, from a 1,024-byte aligned base: Q (BQ x DP), then
// STAGES K tiles and STAGES V tiles (BK x DP), each tile as DP / 64
// panels of rows x 128 bytes; then the barriers.
template <int DP>
struct Layout {
  static constexpr uint32_t Q_BYTES = BQ * DP * 2;
  static constexpr uint32_t KV_BYTES = BK * DP * 2;
  static constexpr uint32_t K = Q_BYTES;
  static constexpr uint32_t V = K + STAGES * KV_BYTES;
  static constexpr uint32_t BARS = V + STAGES * KV_BYTES;
  // q_full, then k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr uint32_t BYTES = BARS + 8 * (1 + 3 * STAGES);
  static constexpr uint32_t DYNAMIC = BYTES + 1024;   // alignment slack
};

// One consumer warpgroup (wg 0 or 1): rows q0 + 64 wg ... + 63.  Thread
// (warp w, lane) owns rows r = 16 w + lane / 4 and r + 8 of them; column
// c = 8 i + 2 (lane % 4) + e of S and O sits in register 4 i + e (row r)
// and 4 i + 2 + e (row r + 8), the wgmma accumulator layout.
template <int DP>
__device__ __forceinline__ void consume(
    uint32_t base, int wg, int q0, int t_begin, int n_tiles, int bh,
    __nv_bfloat16* __restrict__ o, int Sq, int Sk, int d, int causal,
    int window, float scale) {
  using L = Layout<DP>;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int qw = q0 + 64 * wg;
  const int r0 = qw + 16 * warp + lane / 4, r1 = r0 + 8;
  const int cl = 2 * (lane % 4);
  const int hi_w = causal ? min(Sk, qw + 64) : Sk;
  const int lo_w = window > 0 ? max(0, qw - window + 1) : 0;
  const uint32_t bars = base + L::BARS;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(bars, 0);                                   // Q
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    const uint32_t k_full = bars + 8 + 8 * s;
    const uint32_t v_full = bars + 8 + 8 * (STAGES + s);
    const int k0 = (t_begin + it) * BK;
    if (k0 >= hi_w || k0 + BK <= lo_w) {                // none of my rows
      mbar_wait(k_full, parity);
      mbar_wait(v_full, parity);
    } else {
      // S = Q Kᵀ: DP / 16 steps of k16, 32 bytes apart inside a panel
      mbar_wait(k_full, parity);
      float sc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.f;
      const uint32_t kt = base + L::K + s * L::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss_n128(
            sc,
            smem_desc(base + (kk / 4) * BQ * 128 + wg * 64 * 128 + off, 16,
                      1024),
            smem_desc(kt + (kk / 4) * BK * 128 + off, 16, 1024));
      }
      wgmma_commit_and_wait();
      fence_regs(sc);

      // scale, and mask only where the tile crosses the diagonal, the
      // window's edge or Sk
      const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > qw) ||
                        (window > 0 && k0 <= qw + 63 - window);
      float mx0 = NEG, mx1 = NEG;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x0 = sc[4 * i + e] * scale, x1 = sc[4 * i + 2 + e] * scale;
          if (edge) {
            const int col = k0 + 8 * i + cl + e;
            if (!visible(r0, col, Sk, causal, window)) x0 = NEG;
            if (!visible(r1, col, Sk, causal, window)) x1 = NEG;
          }
          sc[4 * i + e] = x0;
          sc[4 * i + 2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
      // online softmax: m' = max(m, rowmax s), l' = l·α + Σ exp(s - m'),
      // acc' = acc·α + exp(s - m')·V, α = exp(m - m')
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
      uint32_t ph[32], pl[32];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float p00 = expf(sc[4 * i] - mn0);
        const float p01 = expf(sc[4 * i + 1] - mn0);
        const float p10 = expf(sc[4 * i + 2] - mn1);
        const float p11 = expf(sc[4 * i + 3] - mn1);
        sum0 += p00 + p01;
        sum1 += p10 + p11;
        split(p00, p01, ph[2 * i], pl[2 * i]);
        split(p10, p11, ph[2 * i + 1], pl[2 * i + 1]);
      }
      l0 = l0 * alpha0 + quad_sum(sum0);
      l1 = l1 * alpha1 + quad_sum(sum1);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[4 * j] *= alpha0;
        acc[4 * j + 1] *= alpha0;
        acc[4 * j + 2] *= alpha1;
        acc[4 * j + 3] *= alpha1;
      }

      // O += P_hi V + P_lo V: keys 16 kk ... + 15 are A registers
      // 4 kk ... 4 kk + 3, and 16 rows of the V tile (2,048 bytes)
      mbar_wait(v_full, parity);
      const uint32_t vt = base + L::V + s * L::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t b = smem_desc(vt + kk * 2048, BK * 128, 1024);
        if constexpr (DP == 128) {
          wgmma_rs_n128(acc, ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2],
                        ph[4 * kk + 3], b);
          wgmma_rs_n128(acc, pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
                        pl[4 * kk + 3], b);
        } else {
          wgmma_rs_n64(acc, ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2],
                       ph[4 * kk + 3], b);
          wgmma_rs_n64(acc, pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
                       pl[4 * kk + 3], b);
        }
      }
      wgmma_commit_and_wait();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 + 8 * (2 * STAGES + s));
  }

  // o = acc / max(l, 1e-30), rounded once to bf16; rows past Sq and
  // columns past d are not stored
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* out = o + (size_t)bh * Sq * d;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + cl;
    if (col >= d) continue;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r0 * d + col) =
          __floats2bfloat162_rn(acc[4 * j] / den0, acc[4 * j + 1] / den0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r1 * d + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] / den1,
                                acc[4 * j + 3] / den1);
  }
}

template <int DP>
__global__ void __launch_bounds__(NT, 1)
flash_attention_sm90(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     __nv_bfloat16* __restrict__ o, int H, int KV, int Sq,
                     int Sk, int d, int causal, int window, float scale) {
  using L = Layout<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::BARS;

  const int bh = blockIdx.x;     // b * H + h
  const int kvh = (bh / H) * KV + (bh % H) / (H / KV);
  // heaviest causal tiles (the last rows) are dispatched first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  // key columns any row of this block can see: [lo, hi)
  const int hi = causal ? min(Sk, q0 + BQ) : Sk;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = lo / BK;
  const int n_tiles = (hi + BK - 1) / BK - t_begin;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 + 8 * s, 1);
      mbar_init(bars + 8 + 8 * (STAGES + s), 1);
      mbar_init(bars + 8 + 8 * (2 * STAGES + s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 256) {
      mbar_expect_tx(bars, L::Q_BYTES);
      for (int p = 0; p < DP / PANEL; ++p)
        tma_load_3d(base + p * BQ * 128, &tq, bars, p * PANEL, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        const uint32_t parity = ((it / STAGES) & 1) ^ 1;
        const uint32_t k_full = bars + 8 + 8 * s;
        const uint32_t v_full = bars + 8 + 8 * (STAGES + s);
        const int k0 = (t_begin + it) * BK;
        mbar_wait(bars + 8 + 8 * (2 * STAGES + s), parity);
        mbar_expect_tx(k_full, L::KV_BYTES);
        for (int p = 0; p < DP / PANEL; ++p)
          tma_load_3d(base + L::K + s * L::KV_BYTES + p * BK * 128, &tk,
                      k_full, p * PANEL, k0, kvh);
        mbar_expect_tx(v_full, L::KV_BYTES);
        for (int p = 0; p < DP / PANEL; ++p)
          tma_load_3d(base + L::V + s * L::KV_BYTES + p * BK * 128, &tv,
                      v_full, p * PANEL, k0, kvh);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    consume<DP>(base, wg, q0, t_begin, n_tiles, bh, o, Sq, Sk, d, causal,
                window, scale);
  }
}

// A (d, S, n) tensor map of a contiguous (n, S, d) bf16 tensor, boxes of
// 64 columns x rows x 1, swizzled 128B, zero fill out of bounds.
bool encode(CUtensorMap* map, const void* ptr, int d, int S, int n,
            int rows) {
  cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)n};
  cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)S * d * 2};
  cuuint32_t box[3] = {PANEL, (cuuint32_t)rows, 1};
  cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int Sq, int Sk, int d, int causal, int window,
           float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, d, Sq, B * H, BQ) ||
      !encode(&tk, k, d, Sk, B * KV, BK) ||
      !encode(&tv, v, d, Sk, B * KV, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = Layout<DP>::DYNAMIC;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_sm90<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_attention_sm90<DP><<<grid, NT, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, KV, Sq, Sk, d, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90

// ---- fp32 inputs: the split-bf16 Hopper kernel ----

namespace sm90_f32 {

using namespace sm90;   // sm90.cuh's helpers and visible()

constexpr int BQ = 128;             // query rows of an item: two warpgroups
constexpr int NT = 384;             // consumer warpgroups 0 and 1, producer 2
constexpr int PRODUCERS = 128;
constexpr int CONSUMER_WARPS = 8;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// The geometry at padded head dim DP (32, 64 or 128), as the note above
// tabulates: BK keys a K/V tile, BLOCKS blocks an SM.  A plane row of DP
// bf16 is stored as DP / PC panels of RB bytes a row: 128 (swizzled
// 128B) or, at DP 32, 64 (swizzled 64B).  Shared memory from a 1,024-byte
// aligned base: Q's three planes (BQ rows), STAGES K tiles and STAGES V
// tiles (three planes of BK rows each), NS fp32 staging slots of UROWS
// rows, then the barriers.
template <int DP>
struct Cfg {
  static constexpr int BK = DP == 32 ? 32 : 64;
  static constexpr int BLOCKS = DP == 32 ? 2 : 1;
  static constexpr int RB = DP < 64 ? 2 * DP : 128;
  static constexpr int PC = RB / 2;                 // bf16 columns a panel
  static constexpr uint32_t SWIZZLE = RB == 128 ? 1 : 2;   // B128, B64
  static constexpr int C8 = DP / 8;                 // 8-column chunks a row
  static constexpr int STAGES = DP == 128 ? 1 : 2;
  static constexpr int UROWS = DP == 64 ? 64 : 32;
  static constexpr int NS = DP == 128 ? 2 : 4;
  static constexpr int QU = BQ / UROWS, KU = BK / UROWS;   // units a tile
  static constexpr uint32_t Q_PLANE = BQ * DP * 2, K_PLANE = BK * DP * 2;
  static constexpr uint32_t UNIT_BYTES = UROWS * DP * 4;
  static constexpr uint32_t K = 3 * Q_PLANE;
  static constexpr uint32_t V = K + STAGES * 3 * K_PLANE;
  static constexpr uint32_t STAGING = V + STAGES * 3 * K_PLANE;
  static constexpr uint32_t BARS = STAGING + NS * UNIT_BYTES;
  // q_full, q_empty, then k_full[STAGES], k_empty[STAGES], v_full[STAGES],
  // v_empty[STAGES], staged[NS]
  static constexpr uint32_t BYTES = BARS + 8 * (2 + 4 * STAGES + NS);
  static constexpr uint32_t DYNAMIC = BYTES + 1024;   // alignment slack
  __device__ static uint32_t k_full(uint32_t b, int s) {
    return b + 16 + 8 * s;
  }
  __device__ static uint32_t k_empty(uint32_t b, int s) {
    return b + 16 + 8 * (STAGES + s);
  }
  __device__ static uint32_t v_full(uint32_t b, int s) {
    return b + 16 + 8 * (2 * STAGES + s);
  }
  __device__ static uint32_t v_empty(uint32_t b, int s) {
    return b + 16 + 8 * (3 * STAGES + s);
  }
  __device__ static uint32_t staged(uint32_t b, int i) {
    return b + 16 + 8 * (4 * STAGES + i);
  }
};

struct Params {
  float* o;
  int H, KV, Sq, Sk, d, causal, window;
  float c;                  // scale · log2(e)
  int BH, n_qt, n_items;    // B·H, query tiles a head, BH · n_qt
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf2(float a, float b) {   // a low
  const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// Two neighbouring values x = hi + mid + lo (sm90.cuh's split3), packed
// two a word, the first value in the low half: the A fragment's order.
__device__ __forceinline__ void split3x2(float a, float b, uint32_t& hi,
                                         uint32_t& mid, uint32_t& lo) {
  hi = bf2(a, b);
  const float ra = a - __uint_as_float(hi << 16);
  const float rb = b - __uint_as_float(hi & 0xFFFF0000u);
  mid = bf2(ra, rb);
  lo = bf2(ra - __uint_as_float(mid << 16),
           rb - __uint_as_float(mid & 0xFFFF0000u));
}

// One work item: 128 query rows of batch·head bh and the key tiles
// [t_begin, t_begin + n_tiles) that any of its rows can see.
struct Item {
  int bh, kvh, q0, t_begin, n_tiles;
};

__device__ __forceinline__ Item item_of(const Params& a, int i, int bk) {
  Item it;
  it.bh = i % a.BH;
  it.kvh = (it.bh / a.H) * a.KV + (it.bh % a.H) / (a.H / a.KV);
  it.q0 = (a.n_qt - 1 - i / a.BH) * BQ;   // the heaviest (last) rows first
  const int hi = a.causal ? min(a.Sk, it.q0 + BQ) : a.Sk;
  const int lo = a.window > 0 ? max(0, it.q0 - a.window + 1) : 0;
  it.t_begin = lo / bk;
  it.n_tiles = (hi + bk - 1) / bk - it.t_begin;
  return it;
}

// The producer's walk over its block's units: an item's QU units of Q,
// then per key tile KU units of K and KU of V.
template <int DP>
struct Cursor {
  using C = Cfg<DP>;
  int i, u;                 // item, unit within it
  Item it;
  __device__ void start(const Params& a, int item) {
    i = item;
    u = 0;
    if (i < a.n_items) it = item_of(a, i, C::BK);
  }
  __device__ int units() const { return C::QU + 2 * C::KU * it.n_tiles; }
  __device__ void next(const Params& a) {
    if (++u == units()) start(a, i + gridDim.x);
  }
  // tile t of the item, K (0) or V (1), part of the tile; u >= QU
  __device__ void kv(int& t, int& kind, int& part) const {
    const int j = u - C::QU;
    t = j / (2 * C::KU);
    kind = j % (2 * C::KU) / C::KU;
    part = j % C::KU;
  }
};

// One thread's part of a unit: fp32 rows [0, UROWS) of the staging slot
// at `slot`, times `mul`, into rows row0 + r of the three planes of the
// tile at `dst` (tr rows a plane).  Thread p takes chunk p % C8 (8
// columns) of rows p / C8 + j · (128 / C8).
template <int DP>
__device__ __forceinline__ void split_unit(uint32_t slot, uint32_t dst,
                                           int tr, int row0, float mul,
                                           int p) {
  using C = Cfg<DP>;
  constexpr int STEP = PRODUCERS / C::C8;
  const int c = p % C::C8, cc = c % (C::PC / 8);
  const uint32_t plane = tr * DP * 2;
  const uint32_t panel = dst + (c / (C::PC / 8)) * tr * C::RB;
#pragma unroll
  for (int j = 0; j < C::UROWS / STEP; ++j) {
    const int r = p / C::C8 + j * STEP;
    const uint32_t src = slot + (r * DP + 8 * c) * 4;
    const float4 x0 = ld_shared_f4(src), x1 = ld_shared_f4(src + 16);
    uint32_t h[4], m[4], l[4];
    split3x2(x0.x * mul, x0.y * mul, h[0], m[0], l[0]);
    split3x2(x0.z * mul, x0.w * mul, h[1], m[1], l[1]);
    split3x2(x1.x * mul, x1.y * mul, h[2], m[2], l[2]);
    split3x2(x1.z * mul, x1.w * mul, h[3], m[3], l[3]);
    // the swizzle XORs the 16-byte chunk with address bits 7 and up
    const int R = row0 + r;
    const uint32_t at =
        panel + R * C::RB +
        ((cc ^ (((R * C::RB) >> 7) & (C::RB / 16 - 1))) * 16);
    st_shared_v4(at, h[0], h[1], h[2], h[3]);
    st_shared_v4(at + plane, m[0], m[1], m[2], m[3]);
    st_shared_v4(at + 2 * plane, l[0], l[1], l[2], l[3]);
  }
}

template <int DP>
__device__ __forceinline__ void produce(uint32_t base, const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv,
                                        const Params& a) {
  using C = Cfg<DP>;
  const int p = threadIdx.x - 2 * 128;
  const uint32_t bars = base + C::BARS;
  Cursor<DP> cur, ahead;
  cur.start(a, blockIdx.x);
  ahead = cur;
  // thread 0 loads unit n + NS - 1 while unit n is split
  const auto load = [&](int n) {
    const uint32_t slot = base + C::STAGING + (n % C::NS) * C::UNIT_BYTES;
    const uint32_t bar = C::staged(bars, n % C::NS);
    mbar_expect_tx(bar, C::UNIT_BYTES);
    if (ahead.u < C::QU) {
      tma_load_3d(slot, tq, bar, 0, ahead.it.q0 + ahead.u * C::UROWS,
                  ahead.it.bh);
    } else {
      int t, kind, part;
      ahead.kv(t, kind, part);
      tma_load_3d(slot, kind ? tv : tk, bar, 0,
                  (ahead.it.t_begin + t) * C::BK + part * C::UROWS,
                  ahead.it.kvh);
    }
    ahead.next(a);
  };
  if (p == 0)
    for (int n = 0; n < C::NS - 1 && ahead.i < a.n_items; ++n) load(n);

  int local = 0, g = 0;     // items and key tiles done
  for (int n = 0; cur.i < a.n_items; ++n) {
    if (p == 0 && ahead.i < a.n_items) load(n + C::NS - 1);
    uint32_t dst, full;
    int tr, row0;
    float mul = 1.f;
    bool last;
    if (cur.u < C::QU) {
      if (cur.u == 0) mbar_wait(bars + 8, (local & 1) ^ 1);    // q_empty
      dst = base;
      full = bars;
      tr = BQ;
      mul = a.c;                  // q · scale · log2(e)
      row0 = cur.u * C::UROWS;
      last = cur.u == C::QU - 1;
    } else {
      int t, kind, part;
      cur.kv(t, kind, part);
      const int s = (g + t) % C::STAGES;
      const uint32_t parity = (((g + t) / C::STAGES) & 1) ^ 1;
      if (part == 0)
        mbar_wait(kind ? C::v_empty(bars, s) : C::k_empty(bars, s), parity);
      dst = base + (kind ? C::V : C::K) + s * 3 * C::K_PLANE;
      full = kind ? C::v_full(bars, s) : C::k_full(bars, s);
      tr = C::BK;
      row0 = part * C::UROWS;
      last = part == C::KU - 1;
    }
    mbar_wait(C::staged(bars, n % C::NS), (n / C::NS) & 1);
    split_unit<DP>(base + C::STAGING + (n % C::NS) * C::UNIT_BYTES, dst, tr,
                   row0, mul, p);
    if (last) {
      fence_proxy_async();
      mbar_arrive(full);
    }
    bar_sync(1, PRODUCERS);       // every thread is done with the slot
    if (cur.u + 1 == cur.units()) {
      ++local;
      g += cur.it.n_tiles;
    }
    cur.next(a);
  }
}

// S = Q Kᵀ of one warpgroup's 64 rows and a BK-key tile: hi·hi into s1,
// the five smaller products into s2.  qa: the warpgroup's rows of Q's hi
// plane; kt: the K tile's hi plane.
template <int DP>
__device__ __forceinline__ void qk(float (&s1)[Cfg<DP>::BK / 2],
                                   float (&s2)[Cfg<DP>::BK / 2], uint32_t qa,
                                   uint32_t kt) {
  using C = Cfg<DP>;
  constexpr int STEPS = C::PC / 16;               // k16 steps a panel
  // each wgmma adds a constant offset / 16 to one descriptor an operand
  const uint64_t qd = smem_desc(qa, 16, 8 * C::RB, C::SWIZZLE);
  const uint64_t kd = smem_desc(kt, 16, 8 * C::RB, C::SWIZZLE);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk % STEPS) * 32;
    const uint32_t qs = (kk / STEPS) * BQ * C::RB + off;
    const uint32_t ks = (kk / STEPS) * C::BK * C::RB + off;
    const auto A = [&](int t) { return qd + (qs + t * C::Q_PLANE) / 16; };
    const auto B = [&](int t) { return kd + (ks + t * C::K_PLANE) / 16; };
    const auto mma = [&](float (&d)[C::BK / 2], uint64_t x, uint64_t y,
                         int acc) {
      if constexpr (C::BK == 64)
        wgmma_ss_n64(d, x, y, acc);
      else
        wgmma_ss_n32(d, x, y, acc);
    };
    mma(s1, A(0), B(0), kk > 0);
    mma(s2, A(1), B(0), kk > 0);
    mma(s2, A(0), B(1), 1);
    mma(s2, A(2), B(0), 1);
    mma(s2, A(1), B(1), 1);
    mma(s2, A(0), B(2), 1);
  }
  wgmma_commit_and_wait();
  fence_regs(s1);
  fence_regs(s2);
}

template <int DP>
__device__ __forceinline__ void mma_pv(float (&o)[DP / 2],
                                       const uint32_t (&p)[Cfg<DP>::BK / 4],
                                       int kk, uint64_t b) {
  if constexpr (DP == 128)
    wgmma_rs_n128(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                  b);
  else if constexpr (DP == 64)
    wgmma_rs_n64(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                 b);
  else
    wgmma_rs_n32(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                 b);
}

// O += P V over a BK-key tile: p_hi·v_hi into o1, the five smaller
// products into o2.  Keys 16 kk ... + 15 are A registers 4 kk ... 4 kk
// + 3; vt: the V tile's hi plane.
template <int DP>
__device__ __forceinline__ void pv(float (&o1)[DP / 2], float (&o2)[DP / 2],
                                   const uint32_t (&ph)[Cfg<DP>::BK / 4],
                                   const uint32_t (&pm)[Cfg<DP>::BK / 4],
                                   const uint32_t (&pl)[Cfg<DP>::BK / 4],
                                   uint32_t vt) {
  using C = Cfg<DP>;
  const uint64_t vd = smem_desc(vt, C::BK * C::RB, 8 * C::RB, C::SWIZZLE);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk) {
    const auto B = [&](int t) {
      return vd + (kk * 16 * C::RB + t * C::K_PLANE) / 16;
    };
    mma_pv<DP>(o1, ph, kk, B(0));
    mma_pv<DP>(o2, ph, kk, B(1));
    mma_pv<DP>(o2, pm, kk, B(0));
    mma_pv<DP>(o2, ph, kk, B(2));
    mma_pv<DP>(o2, pm, kk, B(1));
    mma_pv<DP>(o2, pl, kk, B(0));
  }
  wgmma_commit_and_wait();
  fence_regs(o1);
  fence_regs(o2);
}

// One consumer warpgroup (wg 0 or 1): rows q0 + 64 wg ... + 63 of each
// item.  Thread (warp w, lane) owns rows r = 16 w + lane / 4 and r + 8;
// column c = 8 i + 2 (lane % 4) + e of S and O sits in register 4 i + e
// (row r) and 4 i + 2 + e (row r + 8), the wgmma accumulator layout.
template <int DP>
__device__ __forceinline__ void consume(uint32_t base, int wg,
                                        const Params& a) {
  using C = Cfg<DP>;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int cl = 2 * (lane % 4);
  const uint32_t bars = base + C::BARS;
  const auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  int local = 0, g = 0;     // items and key tiles done
  for (int i = blockIdx.x; i < a.n_items; i += gridDim.x, ++local) {
    const Item it = item_of(a, i, C::BK);
    const int qw = it.q0 + 64 * wg;
    const int r0 = qw + 16 * warp + lane / 4, r1 = r0 + 8;
    const int hi_w = a.causal ? min(a.Sk, qw + 64) : a.Sk;
    const int lo_w = a.window > 0 ? max(0, qw - a.window + 1) : 0;
    const bool live = qw < a.Sq;
    float o1[DP / 2], o2[DP / 2];
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) o1[j] = o2[j] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    mbar_wait(bars, local & 1);                           // q_full
    for (int t = 0; t < it.n_tiles; ++t, ++g) {
      const int s = g % C::STAGES;
      const uint32_t parity = (g / C::STAGES) & 1;
      const int k0 = (it.t_begin + t) * C::BK;
      const bool last = t == it.n_tiles - 1;
      mbar_wait(C::k_full(bars, s), parity);
      if (!live || k0 >= hi_w || k0 + C::BK <= lo_w) {  // none of my rows
        release(C::k_empty(bars, s));
        if (last) release(bars + 8);                      // q_empty
        mbar_wait(C::v_full(bars, s), parity);
        release(C::v_empty(bars, s));
        continue;
      }
      float s1[C::BK / 2], s2[C::BK / 2];
      qk<DP>(s1, s2, base + wg * 64 * C::RB,
             base + C::K + s * 3 * C::K_PLANE);
      release(C::k_empty(bars, s));
      if (last) release(bars + 8);

      // x = S (Q carries scale · log2(e)), masked only where the tile
      // crosses the diagonal, the window's edge or Sk; online softmax in
      // base 2: m' = max(m, rowmax x), l' = l·α + Σ 2^(x - m'),
      // O' = O·α + P V, α = 2^(m - m')
      const bool edge = k0 + C::BK > a.Sk ||
                        (a.causal && k0 + C::BK - 1 > qw) ||
                        (a.window > 0 && k0 <= qw + 63 - a.window);
      float mx0 = NEG, mx1 = NEG;
#pragma unroll
      for (int i8 = 0; i8 < C::BK / 8; ++i8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x0 = s1[4 * i8 + e] + s2[4 * i8 + e];
          float x1 = s1[4 * i8 + 2 + e] + s2[4 * i8 + 2 + e];
          if (edge) {
            const int col = k0 + 8 * i8 + cl + e;
            if (!visible(r0, col, a.Sk, a.causal, a.window)) x0 = NEG;
            if (!visible(r1, col, a.Sk, a.causal, a.window)) x1 = NEG;
          }
          s1[4 * i8 + e] = x0;
          s1[4 * i8 + 2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float alpha0 = ex2(m0 - mn0), alpha1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
      uint32_t ph[C::BK / 4], pm[C::BK / 4], pl[C::BK / 4];
#pragma unroll
      for (int i8 = 0; i8 < C::BK / 8; ++i8) {
        const float p00 = ex2(s1[4 * i8] - mn0);
        const float p01 = ex2(s1[4 * i8 + 1] - mn0);
        const float p10 = ex2(s1[4 * i8 + 2] - mn1);
        const float p11 = ex2(s1[4 * i8 + 3] - mn1);
        sum0 += p00 + p01;
        sum1 += p10 + p11;
        split3x2(p00, p01, ph[2 * i8], pm[2 * i8], pl[2 * i8]);
        split3x2(p10, p11, ph[2 * i8 + 1], pm[2 * i8 + 1], pl[2 * i8 + 1]);
      }
      l0 = l0 * alpha0 + quad_sum(sum0);
      l1 = l1 * alpha1 + quad_sum(sum1);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o1[4 * j] *= alpha0;
        o1[4 * j + 1] *= alpha0;
        o1[4 * j + 2] *= alpha1;
        o1[4 * j + 3] *= alpha1;
        o2[4 * j] *= alpha0;
        o2[4 * j + 1] *= alpha0;
        o2[4 * j + 2] *= alpha1;
        o2[4 * j + 3] *= alpha1;
      }

      mbar_wait(C::v_full(bars, s), parity);
      pv<DP>(o1, o2, ph, pm, pl, base + C::V + s * 3 * C::K_PLANE);
      release(C::v_empty(bars, s));
    }
    if (!live) continue;

    // o = (o1 + o2) / max(l, 1e-30); rows past Sq and columns past d are
    // not stored
    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
    float* out = a.o + (size_t)it.bh * a.Sq * a.d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + cl;
      if (col >= a.d) continue;
      if (r0 < a.Sq)
        *reinterpret_cast<float2*>(out + (size_t)r0 * a.d + col) =
            make_float2((o1[4 * j] + o2[4 * j]) / den0,
                        (o1[4 * j + 1] + o2[4 * j + 1]) / den0);
      if (r1 < a.Sq)
        *reinterpret_cast<float2*>(out + (size_t)r1 * a.d + col) =
            make_float2((o1[4 * j + 2] + o2[4 * j + 2]) / den1,
                        (o1[4 * j + 3] + o2[4 * j + 3]) / den1);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(NT, Cfg<DP>::BLOCKS)
flash_attention_f32(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ Params a) {
  using C = Cfg<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + C::BARS;
  if (threadIdx.x == 0) {
    mbar_init(bars, PRODUCERS);                           // q_full
    mbar_init(bars + 8, CONSUMER_WARPS);                  // q_empty
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(C::k_full(bars, s), PRODUCERS);
      mbar_init(C::k_empty(bars, s), CONSUMER_WARPS);
      mbar_init(C::v_full(bars, s), PRODUCERS);
      mbar_init(C::v_empty(bars, s), CONSUMER_WARPS);
    }
    for (int n = 0; n < C::NS; ++n) mbar_init(C::staged(bars, n), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = uniform(threadIdx.x / 128);
  if (wg == 2) {
    if constexpr (DP == 64)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 56;");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    produce<DP>(base, &tq, &tk, &tv, a);
  } else {
    if constexpr (DP == 128)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    else if constexpr (DP == 64)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 224;");
    else      // two blocks an SM: 80 registers a thread at entry
      asm volatile("setmaxnreg.inc.sync.aligned.u32 96;");
    consume<DP>(base, wg, a);
  }
}

// A (d, S, n) tensor map of a contiguous (n, S, d) fp32 tensor, boxes of
// DP columns x rows x 1, unswizzled (the staging slots are read by
// threads), zero fill out of bounds.
bool encode(CUtensorMap* map, const void* ptr, int d, int S, int n, int dp,
            int rows) {
  cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)n};
  cuuint64_t strides[2] = {(cuuint64_t)d * 4, (cuuint64_t)S * d * 4};
  cuuint32_t box[3] = {(cuuint32_t)dp, (cuuint32_t)rows, 1};
  cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int Sq, int Sk, int d, int causal, int window,
           float scale, cudaStream_t stream) {
  using C = Cfg<DP>;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, d, Sq, B * H, DP, C::UROWS) ||
      !encode(&tk, k, d, Sk, B * KV, DP, C::UROWS) ||
      !encode(&tv, v, d, Sk, B * KV, DP, C::UROWS))
    return static_cast<int>(cudaErrorInvalidValue);
  Params a{static_cast<float*>(o), H, KV, Sq, Sk, d, causal, window,
           scale * LOG2E, B * H, (Sq + BQ - 1) / BQ, 0};
  a.n_items = a.BH * a.n_qt;
  const int smem = C::DYNAMIC;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slots = C::BLOCKS * sm_count();
  const int grid = a.n_items < slots ? a.n_items : slots;
  flash_attention_f32<DP><<<grid, NT, smem, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90_f32

}  // namespace

// dtype: 0 fp32 (the sm90_f32 kernel), 1 bf16 (the sm90 kernel); q, k,
// v and o share it.  window <= 0 means no window.  Returns a cudaError_t
// code.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int KV, int Sq, int Sk, int d,
                                      int causal, int window, float scale,
                                      int dtype, void* stream) {
  if (d < 8 || d > 128 || d % 8 || KV < 1 || H < KV || H % KV || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || Sq < 1) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return d <= 32   ? sm90_f32::launch<32>(q, k, v, o, B, H, KV, Sq, Sk,
                                              d, causal, window, scale, s)
             : d <= 64 ? sm90_f32::launch<64>(q, k, v, o, B, H, KV, Sq, Sk,
                                              d, causal, window, scale, s)
                       : sm90_f32::launch<128>(q, k, v, o, B, H, KV, Sq,
                                               Sk, d, causal, window, scale,
                                               s);
    case 1:
      return d <= 64 ? sm90::launch<64>(q, k, v, o, B, H, KV, Sq, Sk, d,
                                        causal, window, scale, s)
                     : sm90::launch<128>(q, k, v, o, B, H, KV, Sq, Sk, d,
                                         causal, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of one sm90 block at head dim d (bf16 route).
extern "C" int flash_attention_sm90_smem(int d) {
  return d <= 64 ? sm90::Layout<64>::DYNAMIC : sm90::Layout<128>::DYNAMIC;
}

// Dynamic shared memory of one sm90_f32 block at head dim d (fp32 route).
extern "C" int flash_attention_fp32_smem(int d) {
  return d <= 32   ? sm90_f32::Cfg<32>::DYNAMIC
         : d <= 64 ? sm90_f32::Cfg<64>::DYNAMIC
                   : sm90_f32::Cfg<128>::DYNAMIC;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

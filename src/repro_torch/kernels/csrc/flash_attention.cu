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
// Two routes share that function.
//
// fp32 inputs: a CUDA-core kernel (namespace fp32).  One block owns one
// (batch·head, 64-row query tile) and loops over 64-key tiles, widened
// to fp32 in shared memory; both products are IEEE fmaf.  It is the
// port's first design, kept for fp32 callers.
//
// bf16 inputs (every launch of the LM path): a Hopper kernel (namespace
// sm90), below.
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
//   wholly left of the window) is not loaded; in the sm90 kernel a
//   warpgroup also skips a loaded tile that none of its own 64 rows
//   sees.  That is the same function: before a row's first visible
//   tile, a wholly masked tile gives it m = -1e30 and p = exp(0) = 1 for
//   every column, which the next visible tile wipes with alpha =
//   exp(-1e30 - m_new) = 0 (the Pallas _init does the same); after it,
//   such a tile gives p = 0 and alpha = 1.  Every row must see at least
//   one key (with causal masking each row sees its own diagonal); the
//   wrapper raises where a window leaves a row nothing.  The heaviest
//   causal query tiles (the last rows) are dispatched first.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

// ---- fp32 inputs: the CUDA-core kernel ----

namespace fp32 {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // key columns per K/V tile
constexpr int NT = 256;      // threads per block, 16 x 16
constexpr int LD = BQ + 1;   // padded row of the transposed tiles
constexpr float NEG = -1e30f;

static_assert(BQ == BK, "the transposed Q and K tiles share LD");

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Rows [r0, r0 + 64) of a row-major (S, d) matrix as fp32, 0 past S:
// transposed, dst[k * LD + r] (Q and K), or row-major, dst[r * d + k]
// (V).  Eight consecutive elements per thread and step (16-byte loads).
template <bool TRANSPOSE, class T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int r0,
                                          int S, int d,
                                          float* __restrict__ dst) {
  const int n8 = d / 8;
  for (int e = threadIdx.x; e < BQ * n8; e += NT) {
    const int r = e / n8, k = (e % n8) * 8;
    float x[8];
    if (r0 + r < S) {
      load8(src + (size_t)(r0 + r) * d + k, x);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = 0.f;
    }
    if (TRANSPOSE) {
#pragma unroll
      for (int u = 0; u < 8; ++u) dst[(k + u) * LD + r] = x[u];
    } else {
      float4* p = reinterpret_cast<float4*>(dst + r * d + k);
      p[0] = make_float4(x[0], x[1], x[2], x[3]);
      p[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
  }
}

// Reductions over the 16 lanes of a half-warp: the 16 threads that
// share a row (thread = ty * 16 + tx, rows by ty).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Thread (ty, tx) owns query rows ty + 16 i (i < 4), score columns
// tx + 16 j (j < 4) and output columns tx + 16 j (j < 8, < d): strided
// so that a half-warp reads 16 consecutive shared-memory words.
template <class T>
__global__ void __launch_bounds__(NT, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int KV, int Sq, int Sk, int d, int causal,
                       int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;              // [d][LD]  Q tile, transposed
  float* kv = qs + d * LD;       // [d][LD]  K tile, transposed; then
                                 // [BK][d] V tile, row-major
  float* ps = kv + d * LD;       // [BQ][LD] P tile

  const int bh = blockIdx.x;     // b * H + h
  const int kvh = (bh / H) * KV + (bh % H) / (H / KV);
  // heaviest causal tiles (the last rows) are dispatched first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const T* qp = q + (size_t)bh * Sq * d;
  const T* kp = k + (size_t)kvh * Sk * d;
  const T* vp = v + (size_t)kvh * Sk * d;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  // Key columns any row of this tile can see: [lo, hi).
  const int hi = causal ? min(Sk, q0 + BQ) : Sk;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;

  load_tile<true>(qp, q0, Sq, d, qs);

  float acc[4][8], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    load_tile<true>(kp, k0, Sk, d, kv);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < d; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[kk * LD + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = kv[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
    __syncthreads();             // every thread is done with the K tile
    load_tile<false>(vp, k0, Sk, d, kv);

    // online softmax: m' = max(m, rowmax s), l' = l·α + Σ exp(s - m'),
    // acc' = acc·α + exp(s - m')·V, α = exp(m - m')
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mt = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool vis = col < Sk && (!causal || col <= row) &&
                         (window <= 0 || col > row - window);
        s[i][j] = vis ? s[i][j] * scale : NEG;
        mt = fmaxf(mt, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max(mt));
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        ps[(ty + 16 * i) * LD + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();             // P and V tiles are in shared memory

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4], w[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        w[j] = tx + 16 * j < d ? kv[c * d + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
    __syncthreads();             // the next tile overwrites K/V and P
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    T* out = o + ((size_t)bh * Sq + row) * d;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      if (col < d) store(out + col, acc[i][j] / den);
    }
  }
}

template <class T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int Sq, int Sk, int d, int causal, int window,
           float scale, cudaStream_t stream) {
  const int smem = (2 * d * LD + BQ * LD) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_attention_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, Sq, Sk, d, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fp32

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

}  // namespace

// dtype: 0 fp32 (the CUDA-core kernel), 1 bf16 (the sm90 kernel); q, k,
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
      return fp32::launch<float>(q, k, v, o, B, H, KV, Sq, Sk, d, causal,
                                 window, scale, s);
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

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

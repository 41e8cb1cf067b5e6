// colbert_maxsim — exact ColBERT MaxSim scoring for serving.
//
// Replaces four Pallas TPU kernels of
//   src/repro/kernels/colbert_maxsim/colbert_maxsim.py:
//   * colbert_maxsim_multi (_kernel_multi): a query batch (n_q, l, dim)
//     against a doc array (n_docs, m, dim) -> (n_q, n_docs);
//   * colbert_maxsim (_kernel), which ops.colbert_maxsim_rerank_op vmaps
//     over per-query candidate blocks: queries (n_q, l, dim) against
//     their own docs (n_q, n_cand, m, dim) -> (n_q, n_cand), in one
//     launch;
//   * colbert_maxsim_residual_multi (_kernel_residual_multi): the multi
//     sweep over one residual-codec bucket — codes (n_docs, m) int8,
//     packed residuals (n_docs, m, dim*bits/8) uint8, per-token scales
//     (n_docs, m) f32 and one codebook (C, dim) f32;
//   * colbert_maxsim_residual_rerank (_kernel_residual_rerank): the
//     rerank over gathered residual candidates, each row decoding
//     against its own bucket's codebook, looked up in the
//     (n_buckets, C, dim) table through bucket_of (n_q, n_cand) — the
//     same function as the reference's per-candidate codebook gather,
//     without materializing it.
// score(q, d) = sum over live query tokens of the max over live doc
// tokens of q.d; masked doc tokens score -1e30 and masked query tokens
// contribute 0, so an all-masked doc scores the finite l x -1e30
// sentinel the streaming pad audits rely on (never -inf or NaN).
// Queries are fp32; dense docs are fp32 or bf16 (widened exactly).
//
// Every route is a Hopper kernel on split-bf16 wgmma, below:
// colbert_maxsim_multi on bf16 docs (namespace multi_bf16), on fp32 docs
// and colbert_maxsim_residual_multi (B5) — one kernel, a TMA or a
// decoding producer (multi_sm90) — colbert_maxsim_residual_rerank (B6,
// rerank_sm90) and the dense rerank (B4, rerank_dense); the last four
// share one consumer warpgroup (namespace sweep).

#include "sm90.cuh"

constexpr float NEG = -1e30f;     // a masked doc token's score

// ---- colbert_maxsim_multi on bf16 docs: the Hopper kernel ----
//
// Replaces, for bf16 docs, the Pallas TPU kernel
//   src/repro/kernels/colbert_maxsim/colbert_maxsim.py:125
//   ::colbert_maxsim_multi (_kernel_multi; pallas_call at :149).
//
// Bound on the H100: operations.  The docs are bf16 (one term); the
// queries are fp32, split into hi + mid + lo (sm90.cuh).  On the main
// path they are the bf16 encoder's output widened, so their flag is 0
// and a score costs one bf16 product: 2·n_q·l·n_docs·m·dim flops, 0.251
// ms for 64 queries x 32 tokens against 3,695 docs x 128 tokens (989
// TFLOP/s), against 0.036 ms of bytes.  General fp32 queries add
// q_mid·d and q_lo·d: exact products, fp32 sums — the plain version's
// function within its 1e-5 gate.
//
// Design.  Queries are stationary: a block holds 2 x qpw whole queries
// (qpw = floor(64 / l) to a warpgroup, so no query straddles two), as
// three bf16 planes of 128 rows loaded once by TMA from the pre-pass's
// output, with one flag a warpgroup.  One producer warp streams the
// block's docs through a three-stage ring of 128-row tiles from a 3-D
// tensor map over (dim, m, n_docs): a tile is G = 128 / m_pad docs of
// m_pad = pow2(m) <= 128 rows (rows past m zero-filled), or one 128-row
// slice of a doc with m > 128.  A consumer warpgroup computes its
// 64 x 128 scores as two 64 x 64 halves with wgmma m64n64k16 (both
// operands K-major from shared memory), each k16 step in a fresh
// accumulator and the steps added in fp32 round to nearest
// (sm90::split_mma_n64_rn): summed in one tensor-core accumulator, the
// eight steps, added with truncation, put the scores of docs of norm
// ~11 up to 1.4e-5 from a float64 MaxSim (tests/test_torch_score_sm90.py
// on the H100).
// The two warpgroups issue their steps as they go, so one's adds and
// epilogue run under the other's products.  It releases the stage, masks
// the columns (doc mask bits by ballot; columns past m or n_docs are
// dead), and takes each row's max over each doc's columns with quad
// shuffles — the docs of a tile sit on whole groups of 8 columns, so the
// doc of a register is static for a given G.  A doc longer than 128
// carries its rows' maxima across its tiles in registers.  The row
// maxima go to shared memory, 0 for a masked query token; after a named
// barrier of the warpgroup, one warp per (query, doc) adds a query's
// maxima in double, rounded once, so the sum does not depend on an
// order.  The grid is query blocks x doc groups, query
// blocks fastest, so the blocks that read the same docs run together in
// the 50 MB L2.

namespace multi_bf16 {

using namespace sm90;

constexpr int QROWS = 128;    // query rows a block: two warpgroups of 64
constexpr int TN = 128;       // doc rows a tile (wgmma N)
constexpr int STAGES = 3;
constexpr int NT = 288;       // consumer warps 0-7, producer warp 8
constexpr int CONSUMER_WARPS = 8;
constexpr int MAX_G = 16;     // docs a tile: m_pad 8

constexpr uint32_t PLANE_Q = QROWS * PLANE_DP * 2;
constexpr uint32_t STAGE_D = TN * PLANE_DP * 2;
constexpr uint32_t OFF_D = 3 * PLANE_Q;
constexpr uint32_t OFF_RM = OFF_D + STAGES * STAGE_D;
constexpr uint32_t RM_BUF = MAX_G * QROWS * 4;       // [g][row] floats
constexpr uint32_t OFF_BARS = OFF_RM + 2 * RM_BUF;
// q_full, then full[STAGES], empty[STAGES]
constexpr uint32_t SMEM_BYTES = OFF_BARS + 8 * (1 + 2 * STAGES);
constexpr uint32_t SMEM_DYNAMIC = SMEM_BYTES + 1024;

struct Args {
  const int* qflags;
  const uint8_t* qmask;     // (n_q, l)
  const uint8_t* dmask;     // (n_docs, m)
  int n_q, l, qpw, n_docs, m, m_pad, tiles_per_doc, docs_per_block;
  float* out;               // (n_q, n_docs)
};

// One 64 x 128 score tile of a warpgroup as two 64 x 64 halves, acc[h]
// the tile's rows 64 h .. 64 h + 63: q_hi·d and, for a flagged query
// group (QF), q_mid·d + q_lo·d, summed step by step.  K-major operands:
// 64-column panels of 128-byte rows, 32 bytes a k16 step.
template <bool QF>
__device__ __forceinline__ void tile_mma(float (&acc)[2][32], uint32_t q_hi,
                                         uint32_t tile) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
    split_mma_n64_rn<QF, false, QROWS, TN>(acc[h], q_hi, tile + h * 64 * 128);
}

// Each row's max over each of the tile's G docs, masked columns at NEG.
template <int G>
__device__ __forceinline__ void row_max(const float (&acc)[2][32],
                                        const uint32_t (&w)[4], float (&g0)[G],
                                        float (&g1)[G]) {
  constexpr int I_PER_DOC = 16 / G;     // 8-column groups a doc
#pragma unroll
  for (int g = 0; g < G; ++g) g0[g] = g1[g] = NEG;
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool live = (w[i / 4] >> (8 * (i % 4) + e)) & 1u;
      const int g = i / I_PER_DOC;
      g0[g] = fmaxf(g0[g], live ? acc[i / 8][4 * (i % 8) + e] : NEG);
      g1[g] = fmaxf(g1[g], live ? acc[i / 8][4 * (i % 8) + 2 + e] : NEG);
    }
}

// One consumer warpgroup.  Thread (warp w, lane) owns local rows
// r0 = 16 w + lane / 4 and r1 = r0 + 8; column 8 i + 2 (lane % 4) + e of
// the tile sits in register 4 (i % 8) + e (r0) and 4 (i % 8) + 2 + e (r1)
// of half i / 8.
template <int G>
__device__ __forceinline__ void consume(uint32_t base, uint8_t* smem, int wg,
                                        int n_tiles, int d_begin,
                                        int d_end, const Args& a) {
  const int tid = threadIdx.x % 128, warp = uniform(tid / 32), lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, r1 = r0 + 8;
  const int cl = 2 * (lane % 4);
  const int qg = 2 * blockIdx.x + wg;
  const int q_first = qg * a.qpw;
  const int n_groups = (a.n_q + a.qpw - 1) / a.qpw;
  const bool qf = uniform(qg < n_groups && a.qflags[qg]);
  const uint32_t bars = base + OFF_BARS;
  const uint32_t q_hi = base + wg * 64 * 128;
  float* rm = reinterpret_cast<float*>(smem + OFF_RM);
  // whether local rows r0 and r1 are live tokens of this warpgroup's
  // queries: a masked row's maxima go to shared memory as 0, so the sum
  // adds every row of a query
  const auto row_live = [&](int r) {
    const int qi = q_first + r / a.l;
    return r < a.qpw * a.l && qi < a.n_q &&
           a.qmask[(size_t)qi * a.l + r % a.l];
  };
  const bool live0 = row_live(r0), live1 = row_live(r1);
  int buf = 0;
  float run0 = -INFINITY, run1 = -INFINITY;

  mbar_wait(bars, 0);                                   // query planes
  for (int it = 0; it < n_tiles; ++it) {
    // the tile's docs and token rows
    const int t = G == 1 ? it % a.tiles_per_doc : 0;
    const int doc0 = G == 1 ? d_begin + it / a.tiles_per_doc
                            : d_begin + it * G;
    // live bytes of columns 32 j + lane, loaded before the wait
    bool live[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 32 * j + lane;
      const int doc = doc0 + (G == 1 ? 0 : c / a.m_pad);
      const int tok = G == 1 ? t * TN + c : c % a.m_pad;
      live[j] = doc < d_end && tok < a.m &&
                a.dmask[(size_t)doc * a.m + tok];
    }
    const int s = it % STAGES;
    const uint32_t tile = base + OFF_D + s * STAGE_D;
    float acc[2][32];
    mbar_wait(bars + 8 + 8 * s, (it / STAGES) & 1);
    if (qf)
      tile_mma<true>(acc, q_hi, tile);
    else
      tile_mma<false>(acc, q_hi, tile);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 + 8 * (STAGES + s));

    // bit 8 (i % 4) + e of w[i / 4] is this thread's column 8 i + cl + e
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = __ballot_sync(0xffffffffu, live[j]) >> cl;

    float g0[G], g1[G];
    row_max<G>(acc, w, g0, g1);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      g0[g] = quad_max(g0[g]);
      g1[g] = quad_max(g1[g]);
    }
    float* rb = rm + buf * (RM_BUF / 4) + 64 * wg;
    if (G == 1) {
      run0 = t == 0 ? g0[0] : fmaxf(run0, g0[0]);
      run1 = t == 0 ? g1[0] : fmaxf(run1, g1[0]);
      if (t + 1 < a.tiles_per_doc) continue;          // doc not done
      if (lane % 4 == 0) {
        rb[r0] = live0 ? run0 : 0.f;
        rb[r1] = live1 ? run1 : 0.f;
      }
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (lane % 4 == g % 4) {
          rb[g * QROWS + r0] = live0 ? g0[g] : 0.f;
          rb[g * QROWS + r1] = live1 ? g1[g] : 0.f;
        }
    }
    bar_sync(1 + wg, 128);
    // one warp a (query, doc): the live tokens' maxima summed in double
    for (int p0 = 0; p0 < a.qpw * G; p0 += 4) {
      const int p = p0 + warp;
      const int qi = q_first + p / G, g = p % G;
      const int doc = doc0 + g;
      if (p >= a.qpw * G || qi >= a.n_q || doc >= d_end) continue;
      double sum = 0.0;
      for (int tk = lane; tk < a.l; tk += 32)
        sum += (double)rb[g * QROWS + (p / G) * a.l + tk];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) a.out[(size_t)qi * a.n_docs + doc] = (float)sum;
    }
    buf ^= 1;
  }
}

template <int G>
__global__ void __launch_bounds__(NT, 1)
kernel(const __grid_constant__ CUtensorMap tq,
       const __grid_constant__ CUtensorMap td, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bars = base + OFF_BARS;
  const int d_begin = blockIdx.y * a.docs_per_block;
  const int d_end = min(a.n_docs, d_begin + a.docs_per_block);
  const int n_tiles = G == 1 ? (d_end - d_begin) * a.tiles_per_doc
                             : (d_end - d_begin + G - 1) / G;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 + 8 * s, 1);
      mbar_init(bars + 8 + 8 * (STAGES + s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = uniform(threadIdx.x / 32);
  if (warp == CONSUMER_WARPS) {
    // producer: one thread keeps the ring full
    if (threadIdx.x % 32 == 0) {
      // each warpgroup's 64 rows start at its first query; a warpgroup
      // past the last query loads nothing
      const int q0 = 2 * blockIdx.x * a.qpw;
      const int groups = q0 + a.qpw < a.n_q ? 2 : 1;
      mbar_expect_tx(bars, 3 * groups * PLANE_Q / 2);
      for (int pl = 0; pl < 3; ++pl)
        for (int p = 0; p < PLANE_DP / 64; ++p)
          for (int h = 0; h < groups; ++h)
            tma_load_3d(base + pl * PLANE_Q + p * QROWS * 128 + h * 64 * 128,
                        &tq, bars, p * 64, (q0 + h * a.qpw) * a.l, pl);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        const uint32_t full = bars + 8 + 8 * s;
        const int t = G == 1 ? it % a.tiles_per_doc : 0;
        const int doc0 = G == 1 ? d_begin + it / a.tiles_per_doc
                                : d_begin + it * G;
        mbar_wait(bars + 8 + 8 * (STAGES + s), ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full, STAGE_D);
        for (int p = 0; p < PLANE_DP / 64; ++p)
          tma_load_3d(base + OFF_D + s * STAGE_D + p * TN * 128, &td, full,
                      p * 64, t * TN, doc0);
      }
    }
  } else {
    consume<G>(base, smem, warp / 4, n_tiles, d_begin, d_end, a);
  }
}

template <int G>
int run(const CUtensorMap& tq, const CUtensorMap& td, const Args& a,
        int gx, int gy, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DYNAMIC);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<G><<<dim3(gx, gy), NT, SMEM_DYNAMIC, stream>>>(tq, td, a);
  return static_cast<int>(cudaGetLastError());
}

int launch(const float* q, const uint8_t* qmask, const void* docs,
           const uint8_t* dmask, int n_q, int l, int n_docs, int m, int dim,
           void* q_planes, int* q_flags, float* out, int docs_per_block,
           cudaStream_t stream) {
  if (l < 1 || l > 64 || m < 1 || dim % 8 ||
      reinterpret_cast<uintptr_t>(docs) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_q < 1 || n_docs < 1) return static_cast<int>(cudaGetLastError());
  Args a{q_flags, qmask, dmask, n_q, l, 64 / l, n_docs, m, 0, 1, 0, out};
  auto* qp = static_cast<__nv_bfloat16*>(q_planes);
  int err = split_planes(q, n_q * l, dim, a.qpw * l, qp, q_flags, stream);
  if (err) return err;
  int m_pad = 8;
  while (m_pad < m) m_pad *= 2;
  const int G = m_pad >= TN ? 1 : TN / m_pad;
  a.m_pad = G == 1 ? TN : m_pad;
  a.tiles_per_doc = G == 1 ? (m + TN - 1) / TN : 1;
  CUtensorMap tq, td;
  const uint64_t row = PLANE_DP * 2;
  if (!encode_3d(&tq, qp, PLANE_DP, (uint64_t)n_q * l, 3, row,
                 row * n_q * l, 64, 1) ||
      !encode_3d(&td, docs, dim, m, n_docs, dim * 2ull, dim * 2ull * m,
                 a.m_pad, G))
    return static_cast<int>(cudaErrorInvalidValue);
  // query blocks fastest; a doc group is the caller's doc block rounded
  // up to a whole number of tiles
  const int gx = (n_q + 2 * a.qpw - 1) / (2 * a.qpw);
  a.docs_per_block = whole_groups(docs_per_block, G);
  const int gy = (n_docs + a.docs_per_block - 1) / a.docs_per_block;
  switch (G) {
    case 1: return run<1>(tq, td, a, gx, gy, stream);
    case 2: return run<2>(tq, td, a, gx, gy, stream);
    case 4: return run<4>(tq, td, a, gx, gy, stream);
    case 8: return run<8>(tq, td, a, gx, gy, stream);
    default: return run<16>(tq, td, a, gx, gy, stream);
  }
}

}  // namespace multi_bf16

// ---- the split-bf16 sweep of one consumer warpgroup ----
//
// Shared by the four Hopper kernels on 64-token doc tiles: B3 on fp32
// docs and B5 (multi_sm90), B6 (rerank_sm90) and B4 (rerank_dense).  A
// tile is G = 64 /
// m_pad docs of m_pad = pow2(m) <= 64 rows, or one 64-row slice of a doc
// with m > 64, so the doc of a register is static for a given G.  A
// consumer warpgroup holds qpw whole queries in its 64 rows of the query
// planes (three bf16 terms, sm90.cuh) and, per tile of three doc planes
// (one for bf16 docs), computes its 64 x 64 scores with wgmma m64n64k16
// (sm90::split_mma_n64_rn): the products of the terms the flags ask for
// one k16 step at a time, each step in a fresh accumulator, the steps
// added in fp32 round to nearest.  The docs are the caller's, so they
// may be far from unit norm: with centroids of norm ~11 (scores up to
// ~90) eight steps into one tensor-core accumulator, which adds with
// truncation, put B5's scores up to 1.97e-5 below a float64 MaxSim;
// step by step they stay within 7.8e-6 of it, where the fp32 plain
// version is within 1.38e-5 (score_check.py on the H100).  The
// warpgroup then releases the stage, masks the columns (doc mask bits by
// ballot; columns past m or the block's last doc are dead), takes each
// row's max over each doc's columns with quad shuffles, carries a doc
// longer than 64 across its tiles in registers, and writes the row
// maxima to shared memory, 0 for a masked query token; after a named
// barrier of the warpgroup, one warp per (query, doc) adds a query's
// maxima in double, rounded once, so the sum does not depend on an
// order.  Two warpgroups of a block take turns issuing their wgmmas
// (named barriers 3 and 4), so one's epilogue runs under the other's
// products.

namespace sweep {

using namespace sm90;

constexpr int TN = 64;        // doc rows a tile (wgmma N)
constexpr int MAX_G = 8;      // docs a tile: m_pad 8
constexpr uint32_t PLANE_D = TN * PLANE_DP * 2;
constexpr uint32_t STAGE_D = 3 * PLANE_D;
static_assert(PLANE_D == SPLIT_B_PLANE, "split_mma_n64's plane strides");

// The doc terms of a consumer's tiles: three (hi + mid + lo, a stage of
// STAGE_D), as many as the tile group's zero-term flag asks for (three
// planes a stage), or one exact bf16 term (a stage of PLANE_D).
enum DocTerms { THREE, FLAGGED, ONE };

// A launch's docs and scores.  Rows of the query planes: a warpgroup's
// 64 start at its first query.
struct Sweep {
  const uint8_t* qmask;     // (n_q, l)
  const uint8_t* dmask;     // (n_docs, m); B6 (n_q, n_docs, m)
  const int* dflags;        // fp32 docs: a zero-term flag a tile group
  float* out;               // (n_q, n_docs)
  int n_q, l, qpw, n_docs, m, m_pad, tiles_per_doc;
};

// The tiles of m tokens a doc: sets m_pad and tiles_per_doc, returns G.
inline int geometry(Sweep& s) {
  int m_pad = 8;
  while (m_pad < s.m) m_pad *= 2;
  const int G = m_pad >= TN ? 1 : TN / m_pad;
  s.m_pad = G == 1 ? TN : m_pad;
  s.tiles_per_doc = G == 1 ? (s.m + TN - 1) / TN : 1;
  return G;
}

// Docs a block, a whole number of tile groups, for about four blocks an
// SM over gx blocks along the other axis: B4's and B6's grid (one query
// a block, gx = n_q).  B3 and B5 take their doc block from the caller
// (core/tuning.py, whose heuristic is this rule; chip_smoke.py holds the
// two equal through colbert_maxsim_docs_per_block).
inline int docs_per_block(int n_docs, int G, int gx) {
  const int units = (n_docs + G - 1) / G;
  const int groups = max(1, min(units, (4 * sm_count() + gx - 1) / gx));
  return (units + groups - 1) / groups * G;
}

// The first doc and the token slice of tile `it` of a block.
template <int G>
__device__ __forceinline__ void tile_of(const Sweep& a, int d_begin, int it,
                                        int& doc0, int& t) {
  t = G == 1 ? it % a.tiles_per_doc : 0;
  doc0 = G == 1 ? d_begin + it / a.tiles_per_doc : d_begin + it * G;
}

// Each row's max over each of the tile's G docs, masked columns at NEG.
template <int G>
__device__ __forceinline__ void row_max(const float (&acc)[32],
                                        const uint32_t (&w)[2], float (&g0)[G],
                                        float (&g1)[G]) {
  constexpr int I_PER_DOC = 8 / G;      // 8-column groups a doc
#pragma unroll
  for (int g = 0; g < G; ++g) g0[g] = g1[g] = NEG;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool live = (w[i / 4] >> (8 * (i % 4) + e)) & 1u;
      const int g = i / I_PER_DOC;
      g0[g] = fmaxf(g0[g], live ? acc[4 * i + e] : NEG);
      g1[g] = fmaxf(g1[g], live ? acc[4 * i + 2 + e] : NEG);
    }
}

// One consumer warpgroup `wg` of WGS: the qpw queries from q_first (query
// flag qf) in its 64 rows of the QROWS-row query planes at q_hi, against
// the docs [d_begin, d_end) of `dmask` in n_tiles tiles of a ring of
// STAGES at `ring`; barriers at `bars`: the query planes', full[STAGES],
// empty[STAGES]; the tiles' doc terms TERMS.  rm: two buffers of MAX_G x
// QROWS row maxima.
// Thread (warp w, lane) owns local rows r0 = 16 w + lane / 4 and r1 =
// r0 + 8; column 8 i + 2 (lane % 4) + e of the tile sits in register
// 4 i + e (r0) and 4 i + 2 + e (r1).
template <int G, int QROWS, int WGS, int STAGES, DocTerms TERMS>
__device__ __forceinline__ void consume(uint32_t q_hi, uint32_t ring,
                                        uint32_t bars, float* rm, int wg,
                                        int q_first, bool qf, int n_tiles,
                                        int d_begin, int d_end,
                                        const uint8_t* dmask, const Sweep& a) {
  const int tid = threadIdx.x % 128, warp = uniform(tid / 32), lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, r1 = r0 + 8;
  const int cl = 2 * (lane % 4);
  // whether local rows r0 and r1 are live tokens of this warpgroup's
  // queries: a masked row's maxima go to shared memory as 0, so the sum
  // adds every row of a query
  const auto row_live = [&](int r) {
    const int qi = q_first + r / a.l;
    return r < a.qpw * a.l && qi < a.n_q &&
           a.qmask[(size_t)qi * a.l + r % a.l];
  };
  const bool live0 = row_live(r0), live1 = row_live(r1);
  int buf = 0;
  float run0 = -INFINITY, run1 = -INFINITY;
  // Ping-pong on named barriers 3 and 4; warpgroup 0 goes first.
  if (WGS == 2 && wg == 1 && n_tiles > 0) bar_arrive(3, 256);

  mbar_wait(bars, 0);                                   // query planes
  for (int it = 0; it < n_tiles; ++it) {
    int doc0, t;
    tile_of<G>(a, d_begin, it, doc0, t);
    // live bytes of columns 32 j + lane, loaded before the wait
    bool live[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = 32 * j + lane;
      const int doc = doc0 + (G == 1 ? 0 : c / a.m_pad);
      const int tok = G == 1 ? t * TN + c : c % a.m_pad;
      live[j] = doc < d_end && tok < a.m && dmask[(size_t)doc * a.m + tok];
    }
    const bool df = TERMS == THREE ||
                    (TERMS == FLAGGED && uniform(a.dflags[doc0 / G]));
    const int s = it % STAGES;
    const uint32_t tile = ring + s * (TERMS == ONE ? PLANE_D : STAGE_D);
    float acc[32];
    mbar_wait(bars + 8 + 8 * s, (it / STAGES) & 1);
    if (WGS == 2) bar_sync(3 + wg, 256);                // my turn
    if (qf) {
      if (df)
        split_mma_n64_rn<true, true, QROWS>(acc, q_hi, tile);
      else
        split_mma_n64_rn<true, false, QROWS>(acc, q_hi, tile);
    } else {
      if (df)
        split_mma_n64_rn<false, true, QROWS>(acc, q_hi, tile);
      else
        split_mma_n64_rn<false, false, QROWS>(acc, q_hi, tile);
    }
    if (WGS == 2 && (wg == 0 || it + 1 < n_tiles))
      bar_arrive(4 - wg, 256);                          // yours
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 + 8 * (STAGES + s));

    // bit 8 (i % 4) + e of w[i / 4] is this thread's column 8 i + cl + e
    uint32_t w[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      w[j] = __ballot_sync(0xffffffffu, live[j]) >> cl;

    float g0[G], g1[G];
    row_max<G>(acc, w, g0, g1);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      g0[g] = quad_max(g0[g]);
      g1[g] = quad_max(g1[g]);
    }
    float* rb = rm + buf * MAX_G * QROWS + 64 * wg;
    if (G == 1) {
      run0 = t == 0 ? g0[0] : fmaxf(run0, g0[0]);
      run1 = t == 0 ? g1[0] : fmaxf(run1, g1[0]);
      if (t + 1 < a.tiles_per_doc) continue;          // doc not done
      if (lane % 4 == 0) {
        rb[r0] = live0 ? run0 : 0.f;
        rb[r1] = live1 ? run1 : 0.f;
      }
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (lane % 4 == g % 4) {
          rb[g * QROWS + r0] = live0 ? g0[g] : 0.f;
          rb[g * QROWS + r1] = live1 ? g1[g] : 0.f;
        }
    }
    bar_sync(1 + wg, 128);
    // one warp a (query, doc): the live tokens' maxima summed in double
    for (int p0 = 0; p0 < a.qpw * G; p0 += 4) {
      const int p = p0 + warp;
      const int qi = q_first + p / G, g = p % G;
      const int doc = doc0 + g;
      if (p >= a.qpw * G || qi >= a.n_q || doc >= d_end) continue;
      double sum = 0.0;
      for (int tk = lane; tk < a.l; tk += 32)
        sum += (double)rb[g * QROWS + (p / G) * a.l + tk];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) a.out[(size_t)qi * a.n_docs + doc] = (float)sum;
    }
    buf ^= 1;
  }
}

// Eight values split into hi + mid + lo and packed two a word.
__device__ __forceinline__ void split_chunk(const float (&x)[8],
                                            uint32_t (&h)[4],
                                            uint32_t (&md)[4],
                                            uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat16 th[2], tm[2], tl[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) split3(x[2 * i + e], th[e], tm[e], tl[e]);
    h[i] = pack_bf16(th[0], th[1]);
    md[i] = pack_bf16(tm[0], tm[1]);
    lo[i] = pack_bf16(tl[0], tl[1]);
  }
}

// The residual decode of one 8-value chunk, value i at bit BITS · i of
// u, against its centroid values: the product and the sum rounded apart
// (__fmul_rn, __fadd_rn: no fma contraction) — the eager decode's
// arithmetic, so a tile equals dequantize_residual bit for bit — each
// value split into hi + mid + lo and packed two a word.
template <int BITS>
__device__ __forceinline__ void decode_chunk(uint32_t u,
                                             const float (&cent)[8],
                                             float sc, uint32_t (&h)[4],
                                             uint32_t (&md)[4],
                                             uint32_t (&lo)[4]) {
  constexpr int HALF = 1 << (BITS - 1);
  float x[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int v = (u >> (BITS * i)) & ((1 << BITS) - 1);
    x[i] = __fadd_rn(cent[i], __fmul_rn((float)(v - HALF), sc));
  }
  split_chunk(x, h, md, lo);
}

// A chunk's three terms into the tile's three planes at `dst`.
__device__ __forceinline__ void store_chunk(uint32_t dst,
                                            const uint32_t (&h)[4],
                                            const uint32_t (&md)[4],
                                            const uint32_t (&lo)[4]) {
  st_shared_v4(dst, h[0], h[1], h[2], h[3]);
  st_shared_v4(dst + PLANE_D, md[0], md[1], md[2], md[3]);
  st_shared_v4(dst + 2 * PLANE_D, lo[0], lo[1], lo[2], lo[3]);
}

// Split the queries into the caller's planes (3, n_q·l, 128) bf16 and
// flags (one a group of `group` queries), and encode the planes' tensor
// map (boxes of 64 rows).  Returns a cudaError_t code.
inline int query_side(const float* q, int n_q, int l, int dim, int group,
                      void* q_planes, int* q_flags, CUtensorMap* tq,
                      cudaStream_t stream) {
  auto* qp = static_cast<__nv_bfloat16*>(q_planes);
  const int err = split_planes(q, n_q * l, dim, group * l, qp, q_flags,
                               stream);
  if (err) return err;
  const uint64_t row = PLANE_DP * 2;
  return encode_3d(tq, qp, PLANE_DP, (uint64_t)n_q * l, 3, row,
                   row * n_q * l, 64, 1)
             ? 0
             : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace sweep

// ---- the multi sweeps on fp32 docs and on a residual bucket ----
//
// Replace the Pallas TPU kernels
//   src/repro/kernels/colbert_maxsim/colbert_maxsim.py:125
//   ::colbert_maxsim_multi for fp32 docs (_kernel_multi; pallas_call at
//   :149), and :217 ::colbert_maxsim_residual_multi
//   (_kernel_residual_multi; pallas_call at :246).
//
// Bound on the H100: operations.  Docs that are not bf16-exact take
// three bf16 terms: a decoded residual token (B5), or an int8 token
// times its fp32 scale (fp32 B3 on the int8 path).  The queries on the
// serving path are the encoder's bf16 output widened (one term), so a
// score costs three bf16 products: 3 · 2·n_q·l·n_docs·m·dim flops,
// 0.752 ms for 64 queries x 32 tokens against 3,695 docs x 128 (989
// TFLOP/s), against 0.072 ms of fp32 docs (B3) or 0.010 ms of codes,
// residuals, scales and masks (B5; 3.35 TB/s).  General fp32 queries
// take the six products of the split rule; bf16-exact docs on the fp32
// route (the bf16 index widened) one product per query term.
//
// Design.  One kernel, kernel<BITS, G>, with the producer its doc format
// asks for.  Queries are stationary: a block holds 2 x qpw whole queries
// in two consumer warpgroups (qpw = floor(64 / l)), their three bf16
// planes loaded once by TMA from the pre-pass's output, with one flag a
// warpgroup.  Shared memory decides the tile: three query planes of 128
// rows take 96 KB and a three-plane doc tile of 128 rows another 96 KB,
// so a ring of two does not fit in 227 KB; 64-token tiles (48 KB a
// stage) do, and keep 128-row query blocks, which halve the doc traffic
// (and B5's decode) against 64-row ones: every query block reads every
// doc tile.  The grid is query blocks x doc groups, query blocks
// fastest, so the blocks that read the same docs run together in the
// 50 MB L2.  The two consumer warpgroups run the sweep above.
//
// BITS = 0, fp32 docs: the split pre-pass (sm90.cuh) writes the docs'
// three planes (3, n_docs·m, 128) bf16 into the caller's scratch, with
// one flag a tile group (G docs, a tile's worth), as B2's pre-pass
// splits its tokens; one thread of the producer warpgroup streams the
// hi plane of a tile, and mid and lo where its group's flag is set, by
// TMA from a 3-D tensor map over (128, m, 3·n_docs) — box 64 x m_pad x
// G, rows past m zero-filled — into a ring of two stages.  The scratch
// is 6 bytes a doc value (363 MB at the timed bucket); the pre-pass
// reads the docs once and writes it once.  Splitting in the producer
// instead would repeat the split for every query block (16 at the
// timed shape).
//
// BITS = 2 or 4, a residual bucket (B5), decoded in the kernel: token c
// is codebook[code] + (u - 2^(BITS-1)) · scale, u the BITS-bit value of
// its packed row.  As the Pallas kernel decodes into VMEM, this one
// decodes into shared memory: a decoded bucket never sits in device
// memory.  The producer warpgroup decodes the block's docs into the
// ring: each thread takes one 8-value chunk of eight rows of a tile,
// reads the token's code and scale, its packed residual bits (one 4- or
// 2-byte load) and the codebook row's 8 values (two 16-byte loads
// through the read-only cache: the codebook, up to 127 x 128 fp32, stays
// in L1/L2), decodes (sweep::decode_chunk); codes outside [0, C) are
// clamped, as XLA's gather clamps; and stores the three planes as
// 16-byte chunks in the 128B-swizzled layout the wgmma descriptors read
// (chunk index XOR row mod 8, the pattern TMA writes).  Each producer
// thread then fences the generic proxy against the async one (the
// tensor cores read through it) and arrives on the stage's full
// barrier.  Rows past m or past the block's last doc are written as
// zeros and masked.

namespace multi_sm90 {

using namespace sm90;
using namespace sweep;

constexpr int QROWS = 128;    // query rows a block: two warpgroups of 64
constexpr int STAGES = 2;
constexpr int NT = 384;       // consumer warps 0-7, producer warps 8-11
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCERS = 128;

constexpr uint32_t PLANE_Q = QROWS * PLANE_DP * 2;
constexpr uint32_t OFF_D = 3 * PLANE_Q;
constexpr uint32_t OFF_RM = OFF_D + STAGES * STAGE_D;
constexpr uint32_t RM_BUF = MAX_G * QROWS * 4;       // [g][row] floats
constexpr uint32_t OFF_BARS = OFF_RM + 2 * RM_BUF;
// q_full, then full[STAGES], empty[STAGES]
constexpr uint32_t SMEM_BYTES = OFF_BARS + 8 * (1 + 2 * STAGES);
constexpr uint32_t SMEM_DYNAMIC = SMEM_BYTES + 1024;
static_assert(PLANE_Q == SPLIT_A_PLANE, "split_mma_n64's plane strides");

struct Args {
  Sweep s;
  const int* qflags;        // a flag a warpgroup of qpw queries
  int docs_per_block;
  // BITS > 0: the bucket's codes (n_docs, m), residuals (n_docs, m,
  // dim * BITS / 8), scales (n_docs, m) and codebook (n_centroids, dim)
  const int8_t* codes;
  const uint8_t* resq;
  const float* scale;
  const float* codebook;
  int dim, n_centroids;
};

// Producer thread p of 128: chunk c = p % 16 (values 8c .. 8c + 7) of
// rows p / 16 + 8 j of the tile at `tile`, decoded, split and stored in
// the three planes.  Every row of a thread has the same row mod 8, so
// one swizzled chunk offset serves all eight.
template <int BITS, int G>
__device__ __forceinline__ void decode_tile(const Args& a, uint32_t tile,
                                            int doc0, int t, int d_end,
                                            int p) {
  const int c = p % 16, rr = p / 16;
  const uint32_t chunk = tile + (c / 8) * TN * 128 + ((c % 8) ^ rr) * 16;
  const bool col_ok = 8 * c < a.dim;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const int r = rr + 8 * j;
    const int doc = G == 1 ? doc0 : doc0 + r / a.s.m_pad;
    const int tok = G == 1 ? t * TN + r : r % a.s.m_pad;
    uint32_t h[4] = {0, 0, 0, 0}, md[4] = {0, 0, 0, 0}, lo[4] = {0, 0, 0, 0};
    if (col_ok && doc < d_end && tok < a.s.m) {
      const size_t k = (size_t)doc * a.s.m + tok;
      const int code = min(max((int)a.codes[k], 0), a.n_centroids - 1);
      const float sc = a.scale[k];
      // the chunk's 8 values are BITS bytes, value i at bit BITS · i
      const uint8_t* rq = a.resq + k * (a.dim * BITS / 8) + c * BITS;
      const uint32_t u = BITS == 4 ? *reinterpret_cast<const uint32_t*>(rq)
                                   : *reinterpret_cast<const uint16_t*>(rq);
      const float4* cb = reinterpret_cast<const float4*>(
          a.codebook + (size_t)code * a.dim + 8 * c);
      const float4 c0 = __ldg(cb), c1 = __ldg(cb + 1);
      const float cent[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      decode_chunk<BITS>(u, cent, sc, h, md, lo);
    }
    store_chunk(chunk + r * 128, h, md, lo);
  }
}

template <int BITS, int G>
__global__ void __launch_bounds__(NT, 1)
kernel(const __grid_constant__ CUtensorMap tq,
       const __grid_constant__ CUtensorMap td,
       const __grid_constant__ Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bars = base + OFF_BARS;
  const int d_begin = blockIdx.y * a.docs_per_block;
  const int d_end = min(a.s.n_docs, d_begin + a.docs_per_block);
  const int n_tiles = G == 1 ? (d_end - d_begin) * a.s.tiles_per_doc
                             : (d_end - d_begin + G - 1) / G;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 + 8 * s, BITS ? PRODUCERS : 1);
      mbar_init(bars + 8 + 8 * (STAGES + s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = uniform(threadIdx.x / 32);
  if (warp >= CONSUMER_WARPS) {
    // producer warpgroup: one thread loads the query planes (and, for
    // fp32 docs, streams the doc tiles); for a residual bucket all 128
    // decode them
    const int p = threadIdx.x - CONSUMER_WARPS * 32;
    if (p == 0) {
      // each warpgroup's 64 rows start at its first query; a warpgroup
      // past the last query loads nothing
      const int q0 = 2 * blockIdx.x * a.s.qpw;
      const int groups = q0 + a.s.qpw < a.s.n_q ? 2 : 1;
      mbar_expect_tx(bars, 3 * groups * PLANE_Q / 2);
      for (int pl = 0; pl < 3; ++pl)
        for (int pn = 0; pn < PLANE_DP / 64; ++pn)
          for (int h = 0; h < groups; ++h)
            tma_load_3d(base + pl * PLANE_Q + pn * QROWS * 128 +
                            h * 64 * 128,
                        &tq, bars, pn * 64, (q0 + h * a.s.qpw) * a.s.l, pl);
    }
    if (BITS == 0 && p != 0) return;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      const uint32_t full = bars + 8 + 8 * s;
      const uint32_t tile = base + OFF_D + s * STAGE_D;
      int doc0, t;
      tile_of<G>(a.s, d_begin, it, doc0, t);
      mbar_wait(bars + 8 + 8 * (STAGES + s), ((it / STAGES) & 1) ^ 1);
      if constexpr (BITS == 0) {
        const int n_pl = a.s.dflags[doc0 / G] ? 3 : 1;
        mbar_expect_tx(full, n_pl * PLANE_D);
        for (int pl = 0; pl < n_pl; ++pl)
          for (int pn = 0; pn < PLANE_DP / 64; ++pn)
            tma_load_3d(tile + pl * PLANE_D + pn * TN * 128, &td, full,
                        pn * 64, t * TN, pl * a.s.n_docs + doc0);
      } else {
        decode_tile<BITS, G>(a, tile, doc0, t, d_end, p);
        fence_proxy_async();
        mbar_arrive(full);
      }
    }
  } else {
    const int wg = warp / 4, qg = 2 * blockIdx.x + wg;
    const int n_groups = (a.s.n_q + a.s.qpw - 1) / a.s.qpw;
    const bool qf = uniform(qg < n_groups && a.qflags[qg]);
    consume<G, QROWS, 2, STAGES, BITS == 0 ? FLAGGED : THREE>(
        base + wg * 64 * 128, base + OFF_D, bars,
        reinterpret_cast<float*>(smem + OFF_RM), wg, qg * a.s.qpw, qf,
        n_tiles, d_begin, d_end, a.s.dmask, a.s);
  }
}

template <int BITS, int G>
int run(const CUtensorMap& tq, const CUtensorMap& td, const Args& a, dim3 grid,
        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel<BITS, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_DYNAMIC);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<BITS, G><<<grid, NT, SMEM_DYNAMIC, stream>>>(tq, td, a);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS>
int run_g(int G, const CUtensorMap& tq, const CUtensorMap& td, Args& a,
          int docs_per_block, cudaStream_t stream) {
  // query blocks fastest; a doc group is the caller's doc block rounded
  // up to a whole number of tiles
  const int gx = (a.s.n_q + 2 * a.s.qpw - 1) / (2 * a.s.qpw);
  a.docs_per_block = whole_groups(docs_per_block, G);
  const dim3 grid(gx, (a.s.n_docs + a.docs_per_block - 1) / a.docs_per_block);
  switch (G) {
    case 1: return run<BITS, 1>(tq, td, a, grid, stream);
    case 2: return run<BITS, 2>(tq, td, a, grid, stream);
    case 4: return run<BITS, 4>(tq, td, a, grid, stream);
    default: return run<BITS, 8>(tq, td, a, grid, stream);
  }
}

// fp32 docs, with the caller's scratch for the doc planes, (3, n_docs·m,
// 128) bf16, and flags, (n_docs,) int32 (one a tile group is used).
int launch_f32(const float* q, const uint8_t* qmask, const float* docs,
               const uint8_t* dmask, int n_q, int l, int n_docs, int m,
               int dim, void* q_planes, int* q_flags, void* d_planes,
               int* d_flags, float* out, int docs_per_block,
               cudaStream_t stream) {
  if (l < 1 || l > 64 || m < 1 || dim < 8 || dim % 8 || dim > PLANE_DP)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_q < 1 || n_docs < 1) return static_cast<int>(cudaGetLastError());
  Args a{};
  a.s = Sweep{qmask, dmask, d_flags, out, n_q, l, 64 / l, n_docs, m, 0, 1};
  a.qflags = q_flags;
  CUtensorMap tq, td;
  int err = query_side(q, n_q, l, dim, a.s.qpw, q_planes, q_flags, &tq,
                       stream);
  if (err) return err;
  const int G = geometry(a.s);
  auto* dp = static_cast<__nv_bfloat16*>(d_planes);
  err = split_planes(docs, n_docs * m, dim, G * m, dp, d_flags, stream);
  if (err) return err;
  const uint64_t row = PLANE_DP * 2;
  if (!encode_3d(&td, dp, PLANE_DP, m, 3ull * n_docs, row, row * m,
                 a.s.m_pad, G))
    return static_cast<int>(cudaErrorInvalidValue);
  return run_g<0>(G, tq, td, a, docs_per_block, stream);
}

int launch_resid(const float* q, const uint8_t* qmask, const int8_t* codes,
                 const uint8_t* resq, const float* scale,
                 const float* codebook, const uint8_t* dmask, int n_q, int l,
                 int n_docs, int m, int dim, int n_centroids, int bits,
                 void* q_planes, int* q_flags, float* out,
                 int docs_per_block, cudaStream_t stream) {
  // 16-byte codebook loads; a chunk's residual bits load as one 4-byte
  // (4-bit) or 2-byte (2-bit) word
  if (l < 1 || l > 64 || m < 1 || dim < 8 || dim % 8 || dim > PLANE_DP ||
      (bits != 2 && bits != 4) || n_centroids < 1 ||
      reinterpret_cast<uintptr_t>(codebook) % 16 ||
      reinterpret_cast<uintptr_t>(resq) % bits)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_q < 1 || n_docs < 1) return static_cast<int>(cudaGetLastError());
  Args a{};
  a.s = Sweep{qmask, dmask, nullptr, out, n_q, l, 64 / l, n_docs, m, 0, 1};
  a.qflags = q_flags;
  a.codes = codes;
  a.resq = resq;
  a.scale = scale;
  a.codebook = codebook;
  a.dim = dim;
  a.n_centroids = n_centroids;
  CUtensorMap tq;
  const int err = query_side(q, n_q, l, dim, a.s.qpw, q_planes, q_flags,
                             &tq, stream);
  if (err) return err;
  const int G = geometry(a.s);
  return bits == 2 ? run_g<2>(G, tq, tq, a, docs_per_block, stream)
                   : run_g<4>(G, tq, tq, a, docs_per_block, stream);
}

}  // namespace multi_sm90

// ---- colbert_maxsim_residual_rerank (B6): the Hopper kernel ----
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/colbert_maxsim/colbert_maxsim.py:294
//   ::colbert_maxsim_residual_rerank (_kernel_residual_rerank;
//   pallas_call at :326).
// B5's function for each query against its own candidates, candidate
// (i, j) decoding against codebook clamp(bucket_of[i, j]) of the
// (n_tables, C, dim) table.
//
// Bound on the H100: operations, three bf16 products a score (decoded
// docs take three terms, the path's queries one): 3 · 2·n_q·l·n_cand·m·
// dim flops, 0.013 ms for 64 queries x 32 tokens against 64 candidates
// x 128 each, against 0.011 ms of codes, residuals, scales and masks.
//
// Design.  A decoded tile serves one query only (each query has its own
// candidates), so there is no repeated decode to save, as B5 saves it
// with 128-row query blocks; what matters is filling the card.  A block
// is one query and a group of its candidates: one consumer warpgroup
// and a producer warpgroup, 256 threads, with the groups sized for
// about four blocks an SM in the grid (64 queries alone are fewer than
// the 132 SMs).  wgmma's M is 64 and a query has l <= 64 rows: the
// query's rows are padded to 64 (rows past l dead; at l = 32 half the
// products are spent on them), so the sweep's consumer, its row maxima
// and its sums serve unchanged; putting doc tokens on M and the query
// on N (m64n32k16) would spend no product on padding but needs a max
// down the columns, across the four warps.  The query's three planes
// (64 rows, 48 KB) load once by TMA; the producer warpgroup decodes the
// candidates into one 64-token three-plane tile (48 KB), each thread one
// 8-value chunk of eight rows, with B5's arithmetic (sweep::decode_chunk)
// and two additions: the codebook of the row's candidate, and every load
// of a tile issued before the first shared store (the stores carry a
// memory clobber, so loads after them wait for them: B5 takes two
// dependent round trips a row, this decode two a tile).  One stage
// keeps a block at ~100 KB, so two blocks share an SM and one's decode
// runs under the other's products; a ring of two in one block an SM
// measured slower on the H100.

namespace rerank_sm90 {

using namespace sm90;
using namespace sweep;

constexpr int QROWS = 64;     // one query's rows, padded
constexpr int STAGES = 1;      // and two blocks an SM
constexpr int NT = 256;       // consumer warps 0-3, producer warps 4-7
constexpr int CONSUMER_WARPS = 4;
constexpr int PRODUCERS = 128;

constexpr uint32_t PLANE_Q = QROWS * PLANE_DP * 2;
constexpr uint32_t OFF_D = 3 * PLANE_Q;
constexpr uint32_t OFF_RM = OFF_D + STAGES * STAGE_D;
constexpr uint32_t RM_BUF = MAX_G * QROWS * 4;       // [g][row] floats
constexpr uint32_t OFF_BARS = OFF_RM + 2 * RM_BUF;
// q_full, then full[STAGES], empty[STAGES]
constexpr uint32_t SMEM_BYTES = OFF_BARS + 8 * (1 + 2 * STAGES);
constexpr uint32_t SMEM_DYNAMIC = SMEM_BYTES + 1024;
static_assert(OFF_D % 1024 == 0, "128B-swizzled tiles are 1,024-aligned");

struct Args {
  Sweep s;                  // qpw 1; n_docs the candidates a query
  const int* qflags;        // a flag a query
  const int8_t* codes;      // (n_q, n_cand, m)
  const uint8_t* resq;      // (n_q, n_cand, m, dim * BITS / 8)
  const float* scale;       // (n_q, n_cand, m)
  const float* codebooks;   // (n_tables, n_centroids, dim)
  const int* bucket_of;     // (n_q, n_cand)
  int n_tables, docs_per_block, dim, n_centroids;
};

// Producer thread p of 128: chunk c = p % 16 of rows p / 16 + 8 j of
// query qi's tile at `tile`, as multi_sm90::decode_tile, with every
// load first.
template <int BITS, int G>
__device__ __forceinline__ void decode_tile(const Args& a, int qi,
                                            uint32_t tile, int doc0, int t,
                                            int d_end, int p) {
  constexpr int J = TN / 8;     // rows a thread
  const int c = p % 16, rr = p / 16;
  const uint32_t chunk = tile + (c / 8) * TN * 128 + ((c % 8) ^ rr) * 16;
  const bool col_ok = 8 * c < a.dim;
  const size_t cand0 = (size_t)qi * a.s.n_docs;
  bool ok[J];
  float sc[J];
  uint32_t u[J];
  const float4* cb[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int r = rr + 8 * j;
    const int doc = G == 1 ? doc0 : doc0 + r / a.s.m_pad;
    const int tok = G == 1 ? t * TN + r : r % a.s.m_pad;
    ok[j] = col_ok && doc < d_end && tok < a.s.m;
    sc[j] = 0.f;
    u[j] = 0;
    cb[j] = nullptr;
    if (ok[j]) {
      const size_t k = (cand0 + doc) * a.s.m + tok;
      const int code = min(max((int)a.codes[k], 0), a.n_centroids - 1);
      const int tab = min(max(a.bucket_of[cand0 + doc], 0), a.n_tables - 1);
      sc[j] = a.scale[k];
      const uint8_t* rq = a.resq + k * (a.dim * BITS / 8) + c * BITS;
      u[j] = BITS == 4 ? *reinterpret_cast<const uint32_t*>(rq)
                       : *reinterpret_cast<const uint16_t*>(rq);
      cb[j] = reinterpret_cast<const float4*>(
          a.codebooks + ((size_t)tab * a.n_centroids + code) * a.dim + 8 * c);
    }
  }
  float4 c0[J], c1[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    c0[j] = c1[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok[j]) {
      c0[j] = __ldg(cb[j]);
      c1[j] = __ldg(cb[j] + 1);
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    uint32_t h[4] = {0, 0, 0, 0}, md[4] = {0, 0, 0, 0}, lo[4] = {0, 0, 0, 0};
    if (ok[j]) {
      const float cent[8] = {c0[j].x, c0[j].y, c0[j].z, c0[j].w,
                             c1[j].x, c1[j].y, c1[j].z, c1[j].w};
      decode_chunk<BITS>(u[j], cent, sc[j], h, md, lo);
    }
    store_chunk(chunk + (rr + 8 * j) * 128, h, md, lo);
  }
}

// Block (query blockIdx.x, candidate group blockIdx.y).
template <int BITS, int G>
__global__ void __launch_bounds__(NT, 2)
kernel(const __grid_constant__ CUtensorMap tq,
       const __grid_constant__ Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bars = base + OFF_BARS;
  const int qi = blockIdx.x;
  const int d_begin = blockIdx.y * a.docs_per_block;
  const int d_end = min(a.s.n_docs, d_begin + a.docs_per_block);
  const int n_tiles = G == 1 ? (d_end - d_begin) * a.s.tiles_per_doc
                             : (d_end - d_begin + G - 1) / G;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 + 8 * s, PRODUCERS);
      mbar_init(bars + 8 + 8 * (STAGES + s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = uniform(threadIdx.x / 32);
  if (warp >= CONSUMER_WARPS) {
    const int p = threadIdx.x - CONSUMER_WARPS * 32;
    if (p == 0) {
      // the query's rows and the next 64 - l, which are dead
      mbar_expect_tx(bars, 3 * PLANE_Q);
      for (int pl = 0; pl < 3; ++pl)
        for (int pn = 0; pn < PLANE_DP / 64; ++pn)
          tma_load_3d(base + pl * PLANE_Q + pn * QROWS * 128, &tq, bars,
                      pn * 64, qi * a.s.l, pl);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      int doc0, t;
      tile_of<G>(a.s, d_begin, it, doc0, t);
      mbar_wait(bars + 8 + 8 * (STAGES + s), ((it / STAGES) & 1) ^ 1);
      decode_tile<BITS, G>(a, qi, base + OFF_D + s * STAGE_D, doc0, t,
                           d_end, p);
      fence_proxy_async();
      mbar_arrive(bars + 8 + 8 * s);
    }
  } else {
    consume<G, QROWS, 1, STAGES, THREE>(
        base, base + OFF_D, bars, reinterpret_cast<float*>(smem + OFF_RM),
        0, qi, uniform(a.qflags[qi]), n_tiles, d_begin, d_end,
        a.s.dmask + (size_t)qi * a.s.n_docs * a.s.m, a.s);
  }
}

template <int BITS, int G>
int run(const CUtensorMap& tq, const Args& a, dim3 grid,
        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel<BITS, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_DYNAMIC);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<BITS, G><<<grid, NT, SMEM_DYNAMIC, stream>>>(tq, a);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS>
int run_g(int G, const CUtensorMap& tq, const Args& a, dim3 grid,
          cudaStream_t stream) {
  switch (G) {
    case 1: return run<BITS, 1>(tq, a, grid, stream);
    case 2: return run<BITS, 2>(tq, a, grid, stream);
    case 4: return run<BITS, 4>(tq, a, grid, stream);
    default: return run<BITS, 8>(tq, a, grid, stream);
  }
}

int launch(const float* q, const uint8_t* qmask, const int8_t* codes,
           const uint8_t* resq, const float* scale, const float* codebooks,
           const int* bucket_of, int n_tables, const uint8_t* dmask, int n_q,
           int l, int n_cand, int m, int dim, int n_centroids, int bits,
           void* q_planes, int* q_flags, float* out, cudaStream_t stream) {
  if (l < 1 || l > 64 || m < 1 || dim < 8 || dim % 8 || dim > PLANE_DP ||
      (bits != 2 && bits != 4) || n_centroids < 1 || n_tables < 1 ||
      reinterpret_cast<uintptr_t>(codebooks) % 16 ||
      reinterpret_cast<uintptr_t>(resq) % bits)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_q < 1 || n_cand < 1) return static_cast<int>(cudaGetLastError());
  Args a{};
  a.s = Sweep{qmask, dmask, nullptr, out, n_q, l, 1, n_cand, m, 0, 1};
  a.qflags = q_flags;
  a.codes = codes;
  a.resq = resq;
  a.scale = scale;
  a.codebooks = codebooks;
  a.bucket_of = bucket_of;
  a.n_tables = n_tables;
  a.dim = dim;
  a.n_centroids = n_centroids;
  CUtensorMap tq;
  const int err = query_side(q, n_q, l, dim, 1, q_planes, q_flags, &tq,
                             stream);
  if (err) return err;
  const int G = geometry(a.s);
  a.docs_per_block = docs_per_block(n_cand, G, n_q);
  const dim3 grid(n_q, (n_cand + a.docs_per_block - 1) / a.docs_per_block);
  return bits == 2 ? run_g<2>(G, tq, a, grid, stream)
                   : run_g<4>(G, tq, a, grid, stream);
}

}  // namespace rerank_sm90

// ---- colbert_maxsim rerank (B4): the Hopper kernel ----
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/colbert_maxsim/colbert_maxsim.py:69
//   ::colbert_maxsim (_kernel; pallas_call at :90), which
//   ops.colbert_maxsim_rerank_op vmaps over per-query candidate blocks:
//   queries (n_q, l, dim) against their own candidates (n_q, n_cand, m,
//   dim), fp32 or bf16 -> (n_q, n_cand); colbert_maxsim itself is the
//   n_q = 1 case.
//
// Bound on the H100: bytes, each candidate read once: 0.080 ms for 64
// queries x 64 candidates x 128 tokens x 128 in fp32 (4 bytes a value),
// 0.040 ms in bf16, against 0.013 ms of products at three terms
// (3.35 TB/s; 989 TFLOP/s).
//
// Design.  B6 without the decode: one query a block, its rows padded to
// wgmma's M of 64 (rows past l dead), a group of its candidates sized
// for about four blocks an SM (sweep::docs_per_block, so one query
// alone still fills the card), the query's three planes from the split
// pre-pass loaded once by TMA with one flag a query, and one consumer
// warpgroup running the sweep.  Only the producer differs, by the
// candidates' dtype:
//  * fp32: the producer warpgroup loads the tiles itself, each thread
//    one 8-value chunk (two 16-byte loads) of eight rows; it splits each
//    value into hi + mid + lo (sweep::split_chunk), stores the three
//    128B-swizzled planes (sweep::store_chunk), fences the generic proxy
//    against the async one, arrives, and then issues every load of the
//    next tile, which run under this tile's products (there is one
//    stage), as B6 issues a tile's loads before its stores.  No pre-pass
//    scratch, as fp32 B3 needs for its 16 query blocks reading every
//    doc tile: here each candidate tile is read by one block, and a
//    scratch would move 4 + 6 + 6 bytes a value against a bound of 4.
//    The docs always take three terms, as in B6: products are not the
//    bound.  One stage, about 100 KB, so two blocks share an SM.
//  * bf16: one exact term.  One producer thread streams the hi plane by
//    TMA from a 3-D tensor map over the candidates (dim, m, n_q·n_cand),
//    box 64 x m_pad x G, rows past m zero-filled, as multi_bf16 maps its
//    docs, into a ring of BF16_STAGES, and the consumer issues the
//    products of one doc term (sweep::ONE).

namespace rerank_dense {

using namespace sm90;
using namespace sweep;

// B6's block: one query's 64 rows, a consumer and a producer warpgroup
using rerank_sm90::CONSUMER_WARPS;
using rerank_sm90::NT;
using rerank_sm90::OFF_D;
using rerank_sm90::PLANE_Q;
using rerank_sm90::PRODUCERS;
using rerank_sm90::QROWS;
using rerank_sm90::RM_BUF;
// bf16: 85 KB a block, two blocks an SM; a ring of 1, 3 or 4 (4: one
// block an SM) measured slower on the H100
constexpr int BF16_STAGES = 2;

// A block's shared memory on bf16 (BF16) or fp32 candidates: the query
// planes, the ring, two row-max buffers, then the barriers q_full,
// full[STAGES], empty[STAGES].
template <bool BF16>
struct Layout {
  static constexpr int STAGES = BF16 ? BF16_STAGES : 1;
  static constexpr uint32_t OFF_RM = OFF_D + STAGES * (BF16 ? PLANE_D
                                                             : STAGE_D);
  static constexpr uint32_t OFF_BARS = OFF_RM + 2 * RM_BUF;
  static constexpr uint32_t SMEM_DYNAMIC =
      OFF_BARS + 8 * (1 + 2 * STAGES) + 1024;
};

struct Args {
  Sweep s;                  // qpw 1; n_docs the candidates a query
  const int* qflags;        // a flag a query
  const float* docs;        // fp32 candidates (n_q, n_cand, m, dim)
  int dim, docs_per_block;
};

// A producer thread's share of a tile: chunk c = p % 16 (values 8c ..
// 8c + 7) of rows p / 16 + 8 j, j < 8.
struct Chunks {
  float4 x0[TN / 8], x1[TN / 8];
};

// Thread p's chunks of tile `it` of query qi's block, every load issued
// before any is used; rows past m or the block's last candidate, and
// chunks past dim, as zeros.
template <int G>
__device__ __forceinline__ void load_tile(const Args& a, int qi, int d_begin,
                                          int d_end, int it, int p,
                                          Chunks& x) {
  const int c = p % 16, rr = p / 16;
  const bool col_ok = 8 * c < a.dim;
  const size_t cand0 = (size_t)qi * a.s.n_docs;
  int doc0, t;
  tile_of<G>(a.s, d_begin, it, doc0, t);
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const int r = rr + 8 * j;
    const int doc = G == 1 ? doc0 : doc0 + r / a.s.m_pad;
    const int tok = G == 1 ? t * TN + r : r % a.s.m_pad;
    x.x0[j] = x.x1[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (col_ok && doc < d_end && tok < a.s.m) {
      const float4* src = reinterpret_cast<const float4*>(
          a.docs + ((cand0 + doc) * a.s.m + tok) * a.dim + 8 * c);
      x.x0[j] = __ldg(src);
      x.x1[j] = __ldg(src + 1);
    }
  }
}

// Thread p's chunks split into hi + mid + lo, stored in the three
// 128B-swizzled planes of the tile at `tile`.  Every row of a thread has
// the same row mod 8, so one swizzled chunk offset serves all eight.
__device__ __forceinline__ void store_tile(uint32_t tile, int p,
                                           const Chunks& x) {
  const int c = p % 16, rr = p / 16;
  const uint32_t chunk = tile + (c / 8) * TN * 128 + ((c % 8) ^ rr) * 16;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const float v[8] = {x.x0[j].x, x.x0[j].y, x.x0[j].z, x.x0[j].w,
                        x.x1[j].x, x.x1[j].y, x.x1[j].z, x.x1[j].w};
    uint32_t h[4], md[4], lo[4];
    split_chunk(v, h, md, lo);
    store_chunk(chunk + (rr + 8 * j) * 128, h, md, lo);
  }
}

// Block (query blockIdx.x, candidate group blockIdx.y); td maps the
// bf16 candidates (unused on fp32).
template <bool BF16, int G>
__global__ void __launch_bounds__(NT, 2)
kernel(const __grid_constant__ CUtensorMap tq,
       const __grid_constant__ CUtensorMap td,
       const __grid_constant__ Args a) {
  using L = Layout<BF16>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bars = base + L::OFF_BARS;
  const int qi = blockIdx.x;
  const int d_begin = blockIdx.y * a.docs_per_block;
  const int d_end = min(a.s.n_docs, d_begin + a.docs_per_block);
  const int n_tiles = G == 1 ? (d_end - d_begin) * a.s.tiles_per_doc
                             : (d_end - d_begin + G - 1) / G;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 + 8 * s, BF16 ? 1 : PRODUCERS);
      mbar_init(bars + 8 + 8 * (STAGES + s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = uniform(threadIdx.x / 32);
  if (warp >= CONSUMER_WARPS) {
    const int p = threadIdx.x - CONSUMER_WARPS * 32;
    if (p == 0) {
      // the query's rows and the next 64 - l, which are dead
      mbar_expect_tx(bars, 3 * PLANE_Q);
      for (int pl = 0; pl < 3; ++pl)
        for (int pn = 0; pn < PLANE_DP / 64; ++pn)
          tma_load_3d(base + pl * PLANE_Q + pn * QROWS * 128, &tq, bars,
                      pn * 64, qi * a.s.l, pl);
    }
    if (BF16 && p != 0) return;
    Chunks x;                   // fp32: the next tile's chunks
    if (!BF16 && n_tiles > 0) load_tile<G>(a, qi, d_begin, d_end, 0, p, x);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      const uint32_t full = bars + 8 + 8 * s;
      const uint32_t tile = base + OFF_D + s * (BF16 ? PLANE_D : STAGE_D);
      int doc0, t;
      tile_of<G>(a.s, d_begin, it, doc0, t);
      mbar_wait(bars + 8 + 8 * (STAGES + s), ((it / STAGES) & 1) ^ 1);
      if constexpr (BF16) {
        mbar_expect_tx(full, PLANE_D);
        for (int pn = 0; pn < PLANE_DP / 64; ++pn)
          tma_load_3d(tile + pn * TN * 128, &td, full, pn * 64, t * TN,
                      qi * a.s.n_docs + doc0);
      } else {
        store_tile(tile, p, x);
        fence_proxy_async();
        mbar_arrive(full);
        // the next tile's loads run under this one's products
        if (it + 1 < n_tiles)
          load_tile<G>(a, qi, d_begin, d_end, it + 1, p, x);
      }
    }
  } else {
    consume<G, QROWS, 1, STAGES, BF16 ? ONE : THREE>(
        base, base + OFF_D, bars, reinterpret_cast<float*>(smem + L::OFF_RM),
        0, qi, uniform(a.qflags[qi]), n_tiles, d_begin, d_end,
        a.s.dmask + (size_t)qi * a.s.n_docs * a.s.m, a.s);
  }
}

template <bool BF16, int G>
int run(const CUtensorMap& tq, const CUtensorMap& td, const Args& a,
        dim3 grid, cudaStream_t stream) {
  constexpr uint32_t smem = Layout<BF16>::SMEM_DYNAMIC;
  cudaError_t err = cudaFuncSetAttribute(
      kernel<BF16, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<BF16, G><<<grid, NT, smem, stream>>>(tq, td, a);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16>
int run_g(int G, const CUtensorMap& tq, const CUtensorMap& td,
          const Args& a, dim3 grid, cudaStream_t stream) {
  switch (G) {
    case 1: return run<BF16, 1>(tq, td, a, grid, stream);
    case 2: return run<BF16, 2>(tq, td, a, grid, stream);
    case 4: return run<BF16, 4>(tq, td, a, grid, stream);
    default: return run<BF16, 8>(tq, td, a, grid, stream);
  }
}

int launch(const float* q, const uint8_t* qmask, const void* docs,
           const uint8_t* dmask, int n_q, int l, int n_cand, int m, int dim,
           int bf16, void* q_planes, int* q_flags, float* out,
           cudaStream_t stream) {
  // 16-byte loads of fp32 chunks; 16-byte rows of the bf16 tensor map
  if (l < 1 || l > 64 || m < 1 || dim < 8 || dim % 8 || dim > PLANE_DP ||
      reinterpret_cast<uintptr_t>(docs) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_q < 1 || n_cand < 1) return static_cast<int>(cudaGetLastError());
  Args a{};
  a.s = Sweep{qmask, dmask, nullptr, out, n_q, l, 1, n_cand, m, 0, 1};
  a.qflags = q_flags;
  a.docs = static_cast<const float*>(docs);
  a.dim = dim;
  CUtensorMap tq, td;
  const int err = query_side(q, n_q, l, dim, 1, q_planes, q_flags, &tq,
                             stream);
  if (err) return err;
  const int G = geometry(a.s);
  a.docs_per_block = docs_per_block(n_cand, G, n_q);
  const dim3 grid(n_q, (n_cand + a.docs_per_block - 1) / a.docs_per_block);
  if (!bf16) return run_g<false>(G, tq, tq, a, grid, stream);
  if (!encode_3d(&td, docs, dim, m, (uint64_t)n_q * n_cand, dim * 2ull,
                 dim * 2ull * m, a.s.m_pad, G))
    return static_cast<int>(cudaErrorInvalidValue);
  return run_g<true>(G, tq, td, a, grid, stream);
}

}  // namespace rerank_dense

// The caller's scratch: the query planes, (3, n_q·l, 128) bf16, and
// flags, (ceil(n_q / floor(64 / l)),) int32; for fp32 docs also the doc
// planes, (3, n_docs·m, 128) bf16, and flags, (n_docs,) int32 (null for
// bf16 docs).  A block takes docs_per_block docs, rounded up to a whole
// number of tile groups.
extern "C" int colbert_maxsim_multi_launch(
    const float* q, const uint8_t* qmask, const void* docs,
    const uint8_t* dmask, int n_q, int l, int n_docs, int m, int dim,
    int bf16, void* q_planes, int* q_flags, void* d_planes, int* d_flags,
    float* out, int docs_per_block, void* stream) {
  if (bf16)
    return multi_bf16::launch(q, qmask, docs, dmask, n_q, l, n_docs, m, dim,
                              q_planes, q_flags, out, docs_per_block,
                              static_cast<cudaStream_t>(stream));
  return multi_sm90::launch_f32(q, qmask, static_cast<const float*>(docs),
                                dmask, n_q, l, n_docs, m, dim, q_planes,
                                q_flags, d_planes, d_flags, out,
                                docs_per_block,
                                static_cast<cudaStream_t>(stream));
}

// The caller's scratch: the query planes, (3, n_q·l, 128) bf16, and
// flags, (n_q,) int32.
extern "C" int colbert_maxsim_rerank_launch(
    const float* q, const uint8_t* qmask, const void* docs,
    const uint8_t* dmask, int n_q, int l, int n_cand, int m, int dim,
    int bf16, void* q_planes, int* q_flags, float* out, void* stream) {
  return rerank_dense::launch(q, qmask, docs, dmask, n_q, l, n_cand, m, dim,
                              bf16, q_planes, q_flags, out,
                              static_cast<cudaStream_t>(stream));
}

// The caller's scratch: the query planes, (3, n_q·l, 128) bf16, and
// flags, (ceil(n_q / floor(64 / l)),) int32.  A block takes
// docs_per_block docs, rounded up to a whole number of tile groups.
extern "C" int colbert_maxsim_residual_multi_launch(
    const float* q, const uint8_t* qmask, const int8_t* codes,
    const uint8_t* resq, const float* scale, const float* codebook,
    const uint8_t* dmask, int n_q, int l, int n_docs, int m, int dim,
    int n_centroids, int bits, void* q_planes, int* q_flags, float* out,
    int docs_per_block, void* stream) {
  return multi_sm90::launch_resid(q, qmask, codes, resq, scale, codebook,
                                  dmask, n_q, l, n_docs, m, dim, n_centroids,
                                  bits, q_planes, q_flags, out,
                                  docs_per_block,
                                  static_cast<cudaStream_t>(stream));
}

// The caller's scratch: the query planes, (3, n_q·l, 128) bf16, and
// flags, (n_q,) int32.
extern "C" int colbert_maxsim_residual_rerank_launch(
    const float* q, const uint8_t* qmask, const int8_t* codes,
    const uint8_t* resq, const float* scale, const float* codebooks,
    const int* bucket_of, int n_buckets, const uint8_t* dmask, int n_q,
    int l, int n_cand, int m, int dim, int n_centroids, int bits,
    void* q_planes, int* q_flags, float* out, void* stream) {
  return rerank_sm90::launch(q, qmask, codes, resq, scale, codebooks,
                             bucket_of, n_buckets, dmask, n_q, l, n_cand, m,
                             dim, n_centroids, bits, q_planes, q_flags, out,
                             static_cast<cudaStream_t>(stream));
}

// The split pre-pass alone (sm90::split_planes), for timing it apart
// from the fp32 sweep it precedes.
extern "C" int colbert_maxsim_split_planes(const float* x, int rows, int dim,
                                           int group_rows, void* planes,
                                           int* flags, void* stream) {
  return sm90::split_planes(x, rows, dim, group_rows,
                            static_cast<__nv_bfloat16*>(planes), flags,
                            static_cast<cudaStream_t>(stream));
}

// sweep::docs_per_block on the current card (B4's and B6's grid rule),
// for holding core/tuning.py's heuristic to it.
extern "C" int colbert_maxsim_docs_per_block(int n_docs, int G, int gx) {
  return sweep::docs_per_block(n_docs, G, gx);
}

// Dynamic shared memory of one block of the multi sweep: bf16 docs
// (multi_bf16), else fp32 or residual docs (multi_sm90).
extern "C" int colbert_maxsim_multi_smem(int bf16) {
  return bf16 ? multi_bf16::SMEM_DYNAMIC : multi_sm90::SMEM_DYNAMIC;
}

extern "C" const char* colbert_maxsim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// maxsim_topk — the shortlist-rescan hot path, batched over documents.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/maxsim_topk/maxsim_topk.py:104
//   ::maxsim_topk (_kernel; pallas_call at :133).
// For samples (N, dim) and a bucket tokens (B, m, dim) with alive (B, m),
// writes per (document, sample) the k largest scores of
// where(alive, samples . tokens^T, -1e30) sorted descending and their
// token indices — equal to lax.top_k of the masked matrix, ties to the
// lowest index, dead tokens included at -1e30.  k <= 32, k <= m.
//
// Bound on the H100: operations.  Samples and tokens are fp32; both are
// split into bf16 terms (sm90.cuh: hi + mid + lo == x) and the products
// of terms above 2^-24 relative run on the bf16 tensor cores.  On the
// pruning path the tokens are the bf16 encoder's output widened (one
// term) and the sphere samples are genuine fp32 (three), so a score
// costs three bf16 products: 3 · 2·B·N·m·dim flops, 0.832 ms at the
// colbert bucket of 2,908 docs x 180 tokens, N 2,048, dim 128 (989
// TFLOP/s), against 0.080 ms of tokens and 0.228 ms of (B, N, k) output
// (3.35 TB/s).  Two general fp32 operands cost six products
// (hi·hi; hi·mid, mid·hi, hi·lo, lo·hi, mid·mid).
//
// Exactness.  Each product of two bf16 terms is exact in fp32; hi·hi
// accumulates in one fp32 accumulator and the smaller products in a
// second, added once at the end, so the tensor core never aligns a term
// 2^-8 or 2^-16 smaller against the large sum.  The result is the fp32
// dot product up to the order of its sums (and the dropped terms below
// 2^-24), the plain version's function within its 1e-5 gate.
//
// Design.  A pre-pass (sm90.cuh) writes the three bf16 planes of the
// samples (flag per 64 rows) and of the tokens (flag per document).  A
// block owns 128 samples — two consumer warpgroups of 64 rows — whose
// planes it loads once by TMA (96 KB, 128B-swizzled panels), and a
// group of documents; one thread of a producer warpgroup (setmaxnreg
// gives its registers to the consumers: 24 against 240) streams the
// documents' tokens through a two-stage ring of 64-token tiles (the hi
// plane, plus mid and lo for a document whose flag is set).  Per tile
// a warpgroup computes its 64 x 64 scores with wgmma m64n64k16, both
// operands K-major from shared memory, hi·hi into one accumulator and
// the flagged small terms into the other; it releases the stage, then
// runs the epilogue in registers.  The two warpgroups take turns
// issuing their wgmmas (two named barriers), so one's epilogue runs
// under the other's products.  Blocks of one document group are
// adjacent in launch order, so the 16 sample blocks that read the same
// tokens run together in the 50 MB L2.
// What bounds it in practice is the epilogue on the CUDA cores: the
// same scores kept in 4-entry lists take about 40 % of the 16-entry
// time (chip_smoke.py logs both).
//
// Epilogue and the tie contract.  A row of the accumulator is spread
// over the four threads of a quad: thread q holds columns 8i + 2q + e.
// Each thread keeps, per row, a register list of K_CAP >= k entries
// (templated, fully unrolled, static indices) sorted on (value desc,
// index asc), seeded with (-inf, INT_MAX) sentinels that every real
// token beats.  A thread meets its own columns in ascending index order
// (tile by tile, i then e), so inside a thread an entry moves ahead of
// another only on a strictly larger value and a threshold test against
// the last entry skips the rest.  Every real column enters — dead ones
// at -1e30 with their own index — and columns past m never do.  At a
// document's end the quad merges its lists in two steps, one row a lane
// (lanes 0 and 2 row r0, 1 and 3 row r1): with lane xor 1, then xor 2, a
// list and its partner's reversed give, entry by entry, the better of
// the two under the explicit (value desc, index asc) order — a bitonic
// sequence holding the top K_CAP of both — which a bitonic network
// sorts.  Columns interleave across the threads, so this merge is the
// one place where the index compare is needed.  The two lanes of a row
// write its first k entries.  An all-dead document outputs its first k
// tokens at -1e30, indices 0..k-1.

#include "sm90.cuh"

using namespace sm90;

namespace {

constexpr int ROWS = 128;     // samples per block: two warpgroups of 64
constexpr int TILE = 64;      // tokens per tile (wgmma N)
constexpr int STAGES = 2;     // token ring depth
constexpr int NT = 384;       // consumer warpgroups 0 and 1, producer 2
constexpr int CONSUMER_WARPS = 8;
constexpr int KMAX = 32;
constexpr float NEG = -1e30f;

constexpr uint32_t PLANE_A = ROWS * PLANE_DP * 2;     // one sample plane
constexpr uint32_t PLANE_T = TILE * PLANE_DP * 2;     // one token plane
constexpr uint32_t STAGE_T = 3 * PLANE_T;
constexpr uint32_t OFF_T = 3 * PLANE_A;
constexpr uint32_t OFF_BARS = OFF_T + STAGES * STAGE_T;
// a_full, then full[STAGES], empty[STAGES]
constexpr uint32_t SMEM_BYTES = OFF_BARS + 8 * (1 + 2 * STAGES);
constexpr uint32_t SMEM_DYNAMIC = SMEM_BYTES + 1024;   // alignment slack

__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Insert (v, j) into the thread's list, which holds only lower indices:
// strict > keeps the earlier of two equal values ahead.
template <int K>
__device__ __forceinline__ void insert(float (&kv)[K], int (&ki)[K], float v,
                                       int j) {
  if (!(v > kv[K - 1])) return;
  bool b[K];
#pragma unroll
  for (int p = 0; p < K; ++p) b[p] = v > kv[p];
#pragma unroll
  for (int p = K - 1; p > 0; --p) {
    kv[p] = b[p - 1] ? kv[p - 1] : (b[p] ? v : kv[p]);
    ki[p] = b[p - 1] ? ki[p - 1] : (b[p] ? j : ki[p]);
  }
  kv[0] = b[0] ? v : kv[0];
  ki[0] = b[0] ? j : ki[0];
}

// Merge the partner lane's list (ov, oi) of the same row into (kv, ki):
// entry by entry the better of a list and the other reversed — a bitonic
// sequence holding the top K of both — then a bitonic sort, all under
// the explicit (value desc, index asc) order.
template <int K>
__device__ __forceinline__ void merge_with(float (&kv)[K], int (&ki)[K],
                                           const float (&ov)[K],
                                           const int (&oi)[K]) {
#pragma unroll
  for (int p = 0; p < K; ++p)
    if (before(ov[K - 1 - p], oi[K - 1 - p], kv[p], ki[p])) {
      kv[p] = ov[K - 1 - p];
      ki[p] = oi[K - 1 - p];
    }
#pragma unroll
  for (int j = K / 2; j > 0; j >>= 1)
#pragma unroll
    for (int p = 0; p < K; ++p)
      if ((p & j) == 0 && before(kv[p + j], ki[p + j], kv[p], ki[p])) {
        const float tv = kv[p];
        const int ti = ki[p];
        kv[p] = kv[p + j];
        ki[p] = ki[p + j];
        kv[p + j] = tv;
        ki[p + j] = ti;
      }
}

// The quad's eight lists (four lanes, rows r0 and r1) merged into two:
// lanes 1 and 3 of the quad (odd) take row r1, lanes 0 and 2 row r0.
// Step one swaps the other row's list with lane ^ 1 and merges; step
// two merges with lane ^ 2, which holds the same row.  On return
// (kv0, ki0) is the quad's list of the lane's row.
template <int K>
__device__ __forceinline__ void merge_quad(float (&kv0)[K], int (&ki0)[K],
                                           const float (&kv1)[K],
                                           const int (&ki1)[K], bool odd) {
  float ov[K];
  int oi[K];
#pragma unroll
  for (int p = 0; p < K; ++p) {
    ov[p] = __shfl_xor_sync(0xffffffffu, odd ? kv0[p] : kv1[p], 1);
    oi[p] = __shfl_xor_sync(0xffffffffu, odd ? ki0[p] : ki1[p], 1);
    if (odd) {
      kv0[p] = kv1[p];
      ki0[p] = ki1[p];
    }
  }
  merge_with(kv0, ki0, ov, oi);
#pragma unroll
  for (int p = 0; p < K; ++p) {
    ov[p] = __shfl_xor_sync(0xffffffffu, kv0[p], 2);
    oi[p] = __shfl_xor_sync(0xffffffffu, ki0[p], 2);
  }
  merge_with(kv0, ki0, ov, oi);
}

// Issue one 64 x 64 score tile of a warpgroup: hi·hi into acc, and the
// small products of the flagged terms (SF: the samples' mid and lo, TF:
// the tokens') into acc2, each accumulator overwritten by its first
// product.  One straight-line group per flag case; the caller commits
// and waits.  K-major operands: 64-column panels of 128-byte rows, 32
// bytes a k16 step; plane p of the samples PLANE_A and of the tile
// PLANE_T apart.
template <bool SF, bool TF>
__device__ __forceinline__ void tile_mma(float (&acc)[32], float (&acc2)[32],
                                         uint32_t a_hi, uint32_t tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < PLANE_DP / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint32_t a = a_hi + (kk / 4) * ROWS * 128 + off;
    const uint32_t b = tile + (kk / 4) * TILE * 128 + off;
    const auto desc = [](uint32_t x) { return smem_desc(x, 16, 1024); };
    int acc2_on = kk > 0;
    wgmma_ss_n64(acc, desc(a), desc(b), kk > 0);
    if constexpr (SF) {
      wgmma_ss_n64(acc2, desc(a + PLANE_A), desc(b), acc2_on);
      wgmma_ss_n64(acc2, desc(a + 2 * PLANE_A), desc(b), 1);
      acc2_on = 1;
    }
    if constexpr (TF) {
      wgmma_ss_n64(acc2, desc(a), desc(b + PLANE_T), acc2_on);
      wgmma_ss_n64(acc2, desc(a), desc(b + 2 * PLANE_T), 1);
    }
    if constexpr (SF && TF)
      wgmma_ss_n64(acc2, desc(a + PLANE_A), desc(b + PLANE_T), 1);
  }
  wgmma_commit();
}

// One consumer warpgroup: sample rows row0 + 64 wg ... + 63 against the
// block's documents.  Thread (warp w, lane) owns rows r0 = 16 w + lane/4
// and r1 = r0 + 8; column 8 i + 2 (lane % 4) + e of a tile sits in
// register 4 i + e (r0) and 4 i + 2 + e (r1), the wgmma accumulator
// layout.
template <int K>
__device__ __forceinline__ void consume(
    uint32_t base, int wg, int row0, int d_begin, int d_end,
    const int* __restrict__ sflags, int n_sgroups,
    const int* __restrict__ tflags, const uint8_t* __restrict__ alive,
    int N, int m, int k, float* __restrict__ vals, int* __restrict__ idxs) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int r0 = row0 + 64 * wg + 16 * warp + lane / 4, r1 = r0 + 8;
  const int cl = 2 * (lane % 4);
  const int sg = row0 / 64 + wg;
  const bool sf = uniform(sg < n_sgroups && sflags[sg]);
  const uint32_t bars = base + OFF_BARS;
  const int n_t = (m + TILE - 1) / TILE;
  const uint32_t a_hi = base + wg * 64 * 128;

  // Ping-pong: the warpgroups take turns issuing their tiles' wgmmas
  // (named barriers 1 and 2), so that one's epilogue runs while the
  // tensor cores work for the other; warpgroup 0 goes first.
  const int n_tiles = (d_end - d_begin) * n_t;
  if (wg == 1 && n_tiles > 0) bar_arrive(1, 256);

  mbar_wait(bars, 0);                                   // sample planes
  int it = 0;
  for (int doc = d_begin; doc < d_end; ++doc) {
    const bool tf = uniform(tflags[doc]);
    const uint8_t* al = alive + (size_t)doc * m;
    float kv0[K], kv1[K];
    int ki0[K], ki1[K];
#pragma unroll
    for (int p = 0; p < K; ++p) {
      kv0[p] = kv1[p] = -INFINITY;
      ki0[p] = ki1[p] = 0x7FFFFFFF;
    }
    for (int t = 0; t < n_t; ++t, ++it) {
      const int c0 = t * TILE;
      // alive bytes of the tile's 64 columns, loaded before the wait
      const bool l0 = c0 + lane < m && al[c0 + lane];
      const bool l1 = c0 + 32 + lane < m && al[c0 + 32 + lane];
      const int s = it % STAGES;
      const uint32_t full = bars + 8 + 8 * s;
      const uint32_t tile = base + OFF_T + s * STAGE_T;
      float acc[32], acc2[32];
      mbar_wait(full, (it / STAGES) & 1);
      bar_sync(1 + wg, 256);                            // my turn
      if (sf) {
        if (tf)
          tile_mma<true, true>(acc, acc2, a_hi, tile);
        else
          tile_mma<true, false>(acc, acc2, a_hi, tile);
      } else {
        if (tf)
          tile_mma<false, true>(acc, acc2, a_hi, tile);
        else
          tile_mma<false, false>(acc, acc2, a_hi, tile);
      }
      if (wg == 0 || it + 1 < n_tiles) bar_arrive(2 - wg, 256);  // yours
      wgmma_wait0();
      fence_regs(acc);
      fence_regs(acc2);
      if (!sf && !tf) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc2[i] = 0.f;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 + 8 * (STAGES + s));

      // bit 8 i + e of w[i / 4] is this thread's column 8 i + cl + e
      const uint32_t w0 = __ballot_sync(0xffffffffu, l0) >> cl;
      const uint32_t w1 = __ballot_sync(0xffffffffu, l1) >> cl;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t w = i < 4 ? w0 : w1;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * i + cl + e;
          if (col < m) {
            const bool live = (w >> (8 * (i % 4) + e)) & 1u;
            const float v0 = live ? acc[4 * i + e] + acc2[4 * i + e] : NEG;
            const float v1 =
                live ? acc[4 * i + 2 + e] + acc2[4 * i + 2 + e] : NEG;
            insert(kv0, ki0, v0, col);
            insert(kv1, ki1, v1, col);
          }
        }
      }
    }
    const bool odd = lane & 1;
    merge_quad(kv0, ki0, kv1, ki1, odd);
    // the two lanes that hold a row write half of its k entries each
    const int row = odd ? r1 : r0, half = (lane % 4) / 2;
    if (row < N) {
      const size_t o = ((size_t)doc * N + row) * k;
#pragma unroll
      for (int p = 0; p < K; ++p) {
        if (p >= k || p / (K / 2) != half) continue;
        vals[o + p] = kv0[p];
        idxs[o + p] = ki0[p];
      }
    }
  }
}

template <int K>
__global__ void __launch_bounds__(NT, 1)
maxsim_topk_sm90(const __grid_constant__ CUtensorMap ts,
                 const __grid_constant__ CUtensorMap tt,
                 const int* __restrict__ sflags, int n_sgroups,
                 const int* __restrict__ tflags,
                 const uint8_t* __restrict__ alive, int N, int B, int m,
                 int k, int docs_per_block, float* __restrict__ vals,
                 int* __restrict__ idxs) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + OFF_BARS;
  const int row0 = blockIdx.x * ROWS;
  const int d_begin = blockIdx.y * docs_per_block;
  const int d_end = min(B, d_begin + docs_per_block);

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 + 8 * s, 1);
      mbar_init(bars + 8 + 8 * (STAGES + s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // setmaxnreg moves registers from the producer warpgroup (24) to the
  // consumers (240), whose register lists and accumulators need them
  const int warp = uniform(threadIdx.x / 32);
  if (warp / 4 == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    // producer: one thread keeps the ring full
    if (threadIdx.x == 256) {
      // the second 64-row half only where it holds a sample
      const int halves = N - row0 > 64 ? 2 : 1;
      mbar_expect_tx(bars, 3 * halves * PLANE_A / 2);
      for (int pl = 0; pl < 3; ++pl)
        for (int p = 0; p < PLANE_DP / 64; ++p)
          for (int h = 0; h < halves; ++h)
            tma_load_3d(base + pl * PLANE_A + p * ROWS * 128 + h * 64 * 128,
                        &ts, bars, p * 64, row0 + 64 * h, pl);
      const int n_t = (m + TILE - 1) / TILE;
      int it = 0;
      for (int doc = d_begin; doc < d_end; ++doc) {
        const int n_pl = tflags[doc] ? 3 : 1;
        for (int t = 0; t < n_t; ++t, ++it) {
          const int s = it % STAGES;
          const uint32_t full = bars + 8 + 8 * s;
          mbar_wait(bars + 8 + 8 * (STAGES + s), ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full, n_pl * PLANE_T);
          for (int pl = 0; pl < n_pl; ++pl)
            for (int p = 0; p < PLANE_DP / 64; ++p)
              tma_load_3d(base + OFF_T + s * STAGE_T + pl * PLANE_T +
                              p * TILE * 128,
                          &tt, full, p * 64, t * TILE, pl * B + doc);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    consume<K>(base, warp / 4, row0, d_begin, d_end, sflags,
               n_sgroups, tflags, alive, N, m, k, vals, idxs);
  }
}

template <int K>
int launch(const CUtensorMap& ts, const CUtensorMap& tt, const int* sflags,
           int n_sgroups, const int* tflags, const uint8_t* alive, int N,
           int B, int m, int k, float* vals, int* idxs,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      maxsim_topk_sm90<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_DYNAMIC);
  if (err != cudaSuccess) return static_cast<int>(err);
  // about four blocks an SM; blocks of one document group are adjacent
  const int gx = (N + ROWS - 1) / ROWS;
  const int groups = max(1, min(B, (4 * sm_count() + gx - 1) / gx));
  const int per = (B + groups - 1) / groups;
  dim3 grid(gx, (B + per - 1) / per);
  maxsim_topk_sm90<K><<<grid, NT, SMEM_DYNAMIC, stream>>>(
      ts, tt, sflags, n_sgroups, tflags, alive, N, B, m, k, per, vals, idxs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// samples (N, dim) fp32, tokens (B, m, dim) fp32, alive (B, m) bool ->
// vals (B, N, k) fp32, idxs (B, N, k) int32.  Scratch from the caller:
// s_planes (3, N, 128) bf16, s_flags (ceil(N / 64),) int32, t_planes
// (3, B·m, 128) bf16, t_flags (B,) int32.  Returns a cudaError_t code.
extern "C" int maxsim_topk_launch(const float* samples, const float* tokens,
                                  const uint8_t* alive, int B, int N, int m,
                                  int dim, int k, void* s_planes,
                                  int* s_flags, void* t_planes,
                                  int* t_flags, float* vals, int* idxs,
                                  void* stream) {
  if (k < 1 || k > KMAX || k > m || dim < 1 || dim > PLANE_DP)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || N < 1) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* sp = static_cast<__nv_bfloat16*>(s_planes);
  auto* tp = static_cast<__nv_bfloat16*>(t_planes);
  int err = split_planes(samples, N, dim, 64, sp, s_flags, s);
  if (err) return err;
  err = split_planes(tokens, B * m, dim, m, tp, t_flags, s);
  if (err) return err;
  CUtensorMap ts, tt;
  const uint64_t row = PLANE_DP * 2;
  if (!encode_3d(&ts, sp, PLANE_DP, N, 3, row, row * N, 64, 1) ||
      !encode_3d(&tt, tp, PLANE_DP, m, 3ull * B, row, row * m, TILE, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_sg = (N + 63) / 64;
  if (k <= 4)
    return launch<4>(ts, tt, s_flags, n_sg, t_flags, alive, N, B, m, k,
                     vals, idxs, s);
  if (k <= 8)
    return launch<8>(ts, tt, s_flags, n_sg, t_flags, alive, N, B, m, k,
                     vals, idxs, s);
  if (k <= 16)
    return launch<16>(ts, tt, s_flags, n_sg, t_flags, alive, N, B, m, k,
                      vals, idxs, s);
  return launch<32>(ts, tt, s_flags, n_sg, t_flags, alive, N, B, m, k, vals,
                    idxs, s);
}

extern "C" const char* maxsim_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The Hopper skeleton of the two pruning score kernels, B1 (maxsim_top2.cu)
// and B2 (maxsim_topk.cu): the same masked scores of samples (N, dim)
// against a bucket of documents tokens (B, m, dim) with alive (B, m),
// reduced per (document, sample) by an epilogue that each source
// supplies — B2's sorted top-k register lists, B1's best and second.
//
// Exactness.  Samples and tokens are fp32, split into bf16 terms
// (sm90.cuh: hi + mid + lo == x); each product of two terms is exact in
// fp32; hi·hi accumulates in one fp32 accumulator and the smaller
// products in a second, added once at the end, so the tensor core never
// aligns a term 2^-8 or 2^-16 smaller against the large sum.  A score is
// the fp32 dot product up to the order of its sums (and the dropped
// terms below 2^-24).
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
// operands K-major from shared memory (sm90::split_mma_n64); it releases
// the stage, then hands each of its two rows' 16 columns to the
// epilogue in ascending index order — every real column, dead ones at
// -1e30 with their own index; columns past m never.  The two warpgroups
// take turns issuing their wgmmas (two named barriers), so one's
// epilogue runs under the other's products.  Blocks of one document
// group are adjacent in launch order, so the sample blocks that read the
// same tokens run together in the 50 MB L2; the caller sizes the doc
// groups (core/tuning.py's heuristic: about four blocks an SM, so a
// bucket of 128 documents, 16 sample blocks x 32 groups of 4, fills the
// card as well as one of 2,908).
//
// An epilogue Epi is default-constructed at a document's start, takes
// add(v0, v1, col) for the thread's rows r0 and r1 at column col, and
// finish(lane, r0, r1, N, doc, out) writes the document's rows; its
// Out is the kernel's output argument, passed __grid_constant__: as a
// plain by-value parameter, read through a reference here, it made B2
// 10-13 % slower and spilled 8 bytes at K 32 (the same build measured
// against B2's own kernel on the card).

#pragma once

#include "sm90.cuh"

namespace {

namespace maxsim_sm90 {

using namespace sm90;

constexpr int ROWS = 128;     // samples per block: two warpgroups of 64
constexpr int TILE = 64;      // tokens per tile (wgmma N)
constexpr int STAGES = 2;     // token ring depth
constexpr int NT = 384;       // consumer warpgroups 0 and 1, producer 2
constexpr int CONSUMER_WARPS = 8;
constexpr float NEG = -1e30f;

constexpr uint32_t PLANE_A = ROWS * PLANE_DP * 2;     // one sample plane
constexpr uint32_t PLANE_T = TILE * PLANE_DP * 2;     // one token plane
constexpr uint32_t STAGE_T = 3 * PLANE_T;
constexpr uint32_t OFF_T = 3 * PLANE_A;
constexpr uint32_t OFF_BARS = OFF_T + STAGES * STAGE_T;
// a_full, then full[STAGES], empty[STAGES]
constexpr uint32_t SMEM_BYTES = OFF_BARS + 8 * (1 + 2 * STAGES);
constexpr uint32_t SMEM_DYNAMIC = SMEM_BYTES + 1024;   // alignment slack
static_assert(PLANE_A == SPLIT_A_PLANE && PLANE_T == SPLIT_B_PLANE,
              "split_mma_n64's plane strides");

// The (value desc, index asc) order of the tie contract.
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// One consumer warpgroup: sample rows row0 + 64 wg ... + 63 against the
// block's documents.  Thread (warp w, lane) owns rows r0 = 16 w + lane/4
// and r1 = r0 + 8; column 8 i + 2 (lane % 4) + e of a tile sits in
// register 4 i + e (r0) and 4 i + 2 + e (r1), the wgmma accumulator
// layout.
template <class Epi>
__device__ __forceinline__ void consume(
    uint32_t base, int wg, int row0, int d_begin, int d_end,
    const int* __restrict__ sflags, int n_sgroups,
    const int* __restrict__ tflags, const uint8_t* __restrict__ alive,
    int N, int m, const typename Epi::Out& out) {
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
    Epi ep;
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
          split_mma_n64<true, true>(acc, acc2, a_hi, tile);
        else
          split_mma_n64<true, false>(acc, acc2, a_hi, tile);
      } else {
        if (tf)
          split_mma_n64<false, true>(acc, acc2, a_hi, tile);
        else
          split_mma_n64<false, false>(acc, acc2, a_hi, tile);
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
            ep.add(v0, v1, col);
          }
        }
      }
    }
    ep.finish(lane, r0, r1, N, doc, out);
  }
}

// The kernel body: block (sample block x, document group y).
template <class Epi>
__device__ __forceinline__ void score_block(
    const CUtensorMap& ts, const CUtensorMap& tt,
    const int* __restrict__ sflags, int n_sgroups,
    const int* __restrict__ tflags, const uint8_t* __restrict__ alive, int N,
    int B, int m, int docs_per_block, const typename Epi::Out& out) {
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
    consume<Epi>(base, warp / 4, row0, d_begin, d_end, sflags, n_sgroups,
                 tflags, alive, N, m, out);
  }
}

// The pre-pass's planes and flags and the two tensor maps of a launch.
struct Prepared {
  CUtensorMap ts, tt;
  int n_sgroups;
};

// Split samples and tokens into the caller's scratch: s_planes (3, N,
// 128) bf16, s_flags (ceil(N / 64),) int32, t_planes (3, B·m, 128) bf16,
// t_flags (B,) int32.  Returns a cudaError_t code.
inline int prepare(const float* samples, const float* tokens, int B, int N,
                   int m, int dim, void* s_planes, int* s_flags,
                   void* t_planes, int* t_flags, cudaStream_t stream,
                   Prepared& p) {
  auto* sp = static_cast<__nv_bfloat16*>(s_planes);
  auto* tp = static_cast<__nv_bfloat16*>(t_planes);
  int err = split_planes(samples, N, dim, 64, sp, s_flags, stream);
  if (err) return err;
  err = split_planes(tokens, B * m, dim, m, tp, t_flags, stream);
  if (err) return err;
  const uint64_t row = PLANE_DP * 2;
  if (!encode_3d(&p.ts, sp, PLANE_DP, N, 3, row, row * N, 64, 1) ||
      !encode_3d(&p.tt, tp, PLANE_DP, m, 3ull * B, row, row * m, TILE, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  p.n_sgroups = (N + 63) / 64;
  return 0;
}

// Launch `kernel` (a __global__ that runs score_block<Epi>) over sample
// blocks x document groups of `per` documents (the caller's doc block,
// core/tuning.py; at least 1), the blocks of one group adjacent.  A
// document's arithmetic does not depend on the group it falls in.
template <class Kernel, class Out>
int launch(Kernel kernel, const Prepared& p, const int* t_flags,
           const int* s_flags, const uint8_t* alive, int N, int B, int m,
           int per, const Out& out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DYNAMIC);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int gx = (N + ROWS - 1) / ROWS;
  per = whole_groups(per, 1);
  dim3 grid(gx, (B + per - 1) / per);
  kernel<<<grid, NT, SMEM_DYNAMIC, stream>>>(p.ts, p.tt, s_flags,
                                             p.n_sgroups, t_flags, alive, N,
                                             B, m, per, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace maxsim_sm90

}  // namespace

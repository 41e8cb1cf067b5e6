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
// Design and exactness: maxsim_sm90.cuh, the skeleton B2 shares with
// B1 (maxsim_top2.cu): the split pre-pass, a 128-sample block of two
// consumer warpgroups fed 64-token tiles by a TMA ring, split-bf16
// wgmma into two fp32 accumulators.  The score is the fp32 dot product
// up to the order of its sums, the plain version's function within its
// 1e-5 gate.  This file holds B2's epilogue.
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

#include "maxsim_sm90.cuh"

using namespace sm90;
using namespace maxsim_sm90;

namespace {

constexpr int KMAX = 32;

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

struct TopKOut {
  float* vals;    // (B, N, k)
  int* idxs;
  int k;
};

// Per row a sorted register list of K >= k entries (fully unrolled,
// static indices), seeded with (-inf, INT_MAX) sentinels that every
// real token beats.
template <int K>
struct TopK {
  using Out = TopKOut;
  float kv0[K], kv1[K];
  int ki0[K], ki1[K];

  __device__ __forceinline__ TopK() {
#pragma unroll
    for (int p = 0; p < K; ++p) {
      kv0[p] = kv1[p] = -INFINITY;
      ki0[p] = ki1[p] = 0x7FFFFFFF;
    }
  }

  __device__ __forceinline__ void add(float v0, float v1, int col) {
    insert(kv0, ki0, v0, col);
    insert(kv1, ki1, v1, col);
  }

  __device__ __forceinline__ void finish(int lane, int r0, int r1, int N,
                                         int doc, const Out& out) {
    const bool odd = lane & 1;
    merge_quad(kv0, ki0, kv1, ki1, odd);
    // the two lanes that hold a row write half of its k entries each
    const int row = odd ? r1 : r0, half = (lane % 4) / 2;
    if (row < N) {
      const size_t o = ((size_t)doc * N + row) * out.k;
#pragma unroll
      for (int p = 0; p < K; ++p) {
        if (p >= out.k || p / (K / 2) != half) continue;
        out.vals[o + p] = kv0[p];
        out.idxs[o + p] = ki0[p];
      }
    }
  }
};

template <int K>
__global__ void __launch_bounds__(NT, 1)
maxsim_topk_sm90(const __grid_constant__ CUtensorMap ts,
                 const __grid_constant__ CUtensorMap tt,
                 const int* __restrict__ sflags, int n_sgroups,
                 const int* __restrict__ tflags,
                 const uint8_t* __restrict__ alive, int N, int B, int m,
                 int docs_per_block,
                 const __grid_constant__ TopKOut out) {
  score_block<TopK<K>>(ts, tt, sflags, n_sgroups, tflags, alive, N, B, m,
                       docs_per_block, out);
}

}  // namespace

// samples (N, dim) fp32, tokens (B, m, dim) fp32, alive (B, m) bool ->
// vals (B, N, k) fp32, idxs (B, N, k) int32.  Scratch from the caller:
// s_planes (3, N, 128) bf16, s_flags (ceil(N / 64),) int32, t_planes
// (3, B·m, 128) bf16, t_flags (B,) int32.  A block takes docs_per_block
// documents.  Returns a cudaError_t code.
extern "C" int maxsim_topk_launch(const float* samples, const float* tokens,
                                  const uint8_t* alive, int B, int N, int m,
                                  int dim, int k, void* s_planes,
                                  int* s_flags, void* t_planes,
                                  int* t_flags, float* vals, int* idxs,
                                  int docs_per_block, void* stream) {
  if (k < 1 || k > KMAX || k > m || dim < 1 || dim > PLANE_DP)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || N < 1) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Prepared p;
  const int err = prepare(samples, tokens, B, N, m, dim, s_planes, s_flags,
                          t_planes, t_flags, s, p);
  if (err) return err;
  const TopKOut out{vals, idxs, k};
  const int per = docs_per_block;
  if (k <= 4)
    return launch(maxsim_topk_sm90<4>, p, t_flags, s_flags, alive, N, B, m,
                  per, out, s);
  if (k <= 8)
    return launch(maxsim_topk_sm90<8>, p, t_flags, s_flags, alive, N, B, m,
                  per, out, s);
  if (k <= 16)
    return launch(maxsim_topk_sm90<16>, p, t_flags, s_flags, alive, N, B, m,
                  per, out, s);
  return launch(maxsim_topk_sm90<32>, p, t_flags, s_flags, alive, N, B, m,
                per, out, s);
}

// Dynamic shared memory of one block (every k).
extern "C" int maxsim_topk_smem() { return SMEM_DYNAMIC; }

extern "C" const char* maxsim_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

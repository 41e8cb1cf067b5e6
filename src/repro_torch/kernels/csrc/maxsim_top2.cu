// maxsim_top2 — the Voronoi-pruning hot loop, batched over documents.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/maxsim_top2/maxsim_top2.py:109
//   ::maxsim_top2 (_kernel; pallas_call at :136).
// For samples (N, dim) and a bucket of documents tokens (B, m, dim) with
// alive (B, m), writes per (document, sample) the best and second-best
// score of samples . tokens^T over alive tokens and their token indices
// (dead tokens score -1e30).  Ties go to the lower index for both, and
// the second is the argmax of the row with the best slot reset to -1e30,
// exactly as repro's ref.py defines it (maxsim_top2.py:22-26).
//
// Bound on the H100: operations, as B2's (maxsim_topk.cu): on the
// pruning path the tokens are bf16-exact (one term) and the sphere
// samples fp32 (three), so a score costs three bf16 products,
// 3 · 2·B·N·m·dim flops on the tensor cores — 0.832 ms at 2,908 docs x
// 180 tokens, N 2,048, dim 128 — against 0.080 ms of tokens and 0.028 ms
// of (B, N) x 4 outputs.  One launch serves a whole bucket for one
// greedy step of Alg. 1.
//
// Design: B2's skeleton (maxsim_sm90.cuh: split pre-pass, TMA ring of
// 64-token tiles, split-bf16 wgmma into two fp32 accumulators, two
// consumer warpgroups taking turns) with a two-entry epilogue in
// registers in place of B2's k-lists.  Nothing (N, m)-shaped reaches
// device memory.
//
// Epilogue and the tie contract.  Each thread keeps, per row, (b1, i1,
// b2, i2), seeded with (-inf, INT_MAX) sentinels that every real column
// beats.  It meets its own columns (8i + 2q + e of each tile) in
// ascending index order and takes a value only when strictly larger, so
// its pair is the top two of its columns under (value desc, index asc).
// At a document's end the quad merges its four pairs for both rows with
// lane xor 1, then xor 2, under that explicit order — columns interleave
// across lanes, so this is the one place the index compare is needed.
// Then, once on the merged pair, the fix-up of ref.py's second: the
// best slot itself competes for second at -1e30 (ref.py resets it
// rather than dropping it), and wins when nothing else beats -1e30 (one
// token; every other token dead) or ties there at a lower index (an
// all-dead document: best and second are both token 0).  Without it the
// pair would be lax.top_k's top two, which differ from ref.py's second
// whenever the best index is lower than every dead one.

#include "maxsim_sm90.cuh"

using namespace sm90;
using namespace maxsim_sm90;

namespace {

struct Top2Out {
  float* best;      // (B, N) each
  float* second;
  int* bi;
  int* si;
};

// The top two of (v, i) pairs under (value desc, index asc).
struct Pair {
  float v1, v2;
  int i1, i2;

  // a column of a higher index than every one taken so far
  __device__ __forceinline__ void take(float v, int j) {
    const bool gt1 = v > v1, gt2 = v > v2;
    v2 = gt1 ? v1 : (gt2 ? v : v2);
    i2 = gt1 ? i1 : (gt2 ? j : i2);
    v1 = gt1 ? v : v1;
    i1 = gt1 ? j : i1;
  }

  // the pair of lane ^ mask, whose columns are disjoint from this one's
  __device__ __forceinline__ void merge(int mask) {
    const float o1 = __shfl_xor_sync(0xffffffffu, v1, mask);
    const float o2 = __shfl_xor_sync(0xffffffffu, v2, mask);
    const int j1 = __shfl_xor_sync(0xffffffffu, i1, mask);
    const int j2 = __shfl_xor_sync(0xffffffffu, i2, mask);
    if (before(o1, j1, v1, i1)) {
      const bool mine = before(v1, i1, o2, j2);
      v2 = mine ? v1 : o2;
      i2 = mine ? i1 : j2;
      v1 = o1;
      i1 = j1;
    } else if (before(o1, j1, v2, i2)) {
      v2 = o1;
      i2 = j1;
    }
  }
};

struct Top2 {
  using Out = Top2Out;
  Pair p[2];      // rows r0 and r1

  __device__ __forceinline__ Top2() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      p[r].v1 = p[r].v2 = -INFINITY;
      p[r].i1 = p[r].i2 = 0x7FFFFFFF;
    }
  }

  __device__ __forceinline__ void add(float v0, float v1, int col) {
    p[0].take(v0, col);
    p[1].take(v1, col);
  }

  __device__ __forceinline__ void finish(int lane, int r0, int r1, int N,
                                         int doc, const Out& out) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      p[r].merge(1);
      p[r].merge(2);
      // ref.py's second: the best slot at -1e30 against the rest
      if (p[r].v2 < NEG || (p[r].v2 == NEG && p[r].i1 < p[r].i2)) {
        p[r].v2 = NEG;
        p[r].i2 = p[r].i1;
      }
    }
    // every lane of the quad holds both rows; lane 0 writes r0, lane 1 r1
    const int q = lane % 4;
    const int row = q == 0 ? r0 : r1;
    if (q < 2 && row < N) {
      // selects, not p[q]: a dynamic index would put p in local memory
      const size_t o = (size_t)doc * N + row;
      out.best[o] = q == 0 ? p[0].v1 : p[1].v1;
      out.second[o] = q == 0 ? p[0].v2 : p[1].v2;
      out.bi[o] = q == 0 ? p[0].i1 : p[1].i1;
      out.si[o] = q == 0 ? p[0].i2 : p[1].i2;
    }
  }
};

__global__ void __launch_bounds__(NT, 1)
maxsim_top2_sm90(const __grid_constant__ CUtensorMap ts,
                 const __grid_constant__ CUtensorMap tt,
                 const int* __restrict__ sflags, int n_sgroups,
                 const int* __restrict__ tflags,
                 const uint8_t* __restrict__ alive, int N, int B, int m,
                 int docs_per_block,
                 const __grid_constant__ Top2Out out) {
  score_block<Top2>(ts, tt, sflags, n_sgroups, tflags, alive, N, B, m,
                    docs_per_block, out);
}

}  // namespace

// samples (N, dim) fp32, tokens (B, m, dim) fp32, alive (B, m) bool ->
// best, second (B, N) fp32, bi, si (B, N) int32.  Scratch from the
// caller: s_planes (3, N, 128) bf16, s_flags (ceil(N / 64),) int32,
// t_planes (3, B·m, 128) bf16, t_flags (B,) int32.  A block takes
// docs_per_block documents.  Returns a cudaError_t code.
extern "C" int maxsim_top2_launch(const float* samples, const float* tokens,
                                  const uint8_t* alive, int B, int N, int m,
                                  int dim, void* s_planes, int* s_flags,
                                  void* t_planes, int* t_flags, float* best,
                                  float* second, int* bi, int* si,
                                  int docs_per_block, void* stream) {
  if (m < 1 || dim < 1 || dim > PLANE_DP)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || N < 1) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Prepared p;
  const int err = prepare(samples, tokens, B, N, m, dim, s_planes, s_flags,
                          t_planes, t_flags, s, p);
  if (err) return err;
  return launch(maxsim_top2_sm90, p, t_flags, s_flags, alive, N, B, m,
                docs_per_block, Top2Out{best, second, bi, si}, s);
}

// Dynamic shared memory of one block.
extern "C" int maxsim_top2_smem() { return SMEM_DYNAMIC; }

extern "C" const char* maxsim_top2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

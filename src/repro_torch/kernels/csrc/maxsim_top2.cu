// maxsim_top2 — the Voronoi-pruning hot loop, batched over documents.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/maxsim_top2/maxsim_top2.py::maxsim_top2 (_kernel).
// For samples (N, dim) and a bucket of documents tokens (B, m, dim) with
// alive (B, m), writes per (document, sample) the best and second-best
// score of samples . tokens^T over alive tokens and their token indices
// (dead tokens score -1e30).  Ties go to the lower index for both, and
// the second is the argmax of the row with the best slot reset to -1e30,
// exactly as repro's ref.py defines it.
//
// Bound on the H100: operations.  Each launch does 2*B*N*m*dim fp32
// flops on the CUDA cores (no TF32: the reference is IEEE fp32) against
// (N + B*m)*dim*4 bytes of input, far above the card's flop/byte ridge.
// Design: one launch serves a whole bucket for one greedy step (grid =
// documents x sample tiles), so Alg. 1 costs a few launches per step
// instead of one per document.  Each block computes 64 x 64 score tiles
// in shared memory (score_tile.cuh) and 64 threads fold their own row
// into a running top-2, scanning tokens in ascending order with strict
// '>' — the lowest-index tie rule comes out by itself, and no merge
// across threads is needed.  Nothing (N, m)-shaped reaches device
// memory.  Later work: tensor-core-free register blocking is the
// limiter (smem bandwidth); a wider micro-tile or a split of the
// epilogue across all 256 threads is the next step.

#include "score_tile.cuh"

using namespace repro;

__global__ void __launch_bounds__(NT)
maxsim_top2_kernel(const float* __restrict__ samples,
                   const float* __restrict__ tokens,
                   const uint8_t* __restrict__ alive, int N, int m, int dim,
                   float* __restrict__ best, float* __restrict__ second,
                   int* __restrict__ bi, int* __restrict__ si) {
  __shared__ TileSmem sm;
  const int doc = blockIdx.x;
  const int row0 = blockIdx.y * RT;
  const int nrows = min(RT, N - row0);
  const float* A = samples + (size_t)row0 * dim;
  const float* D = tokens + (size_t)doc * m * dim;
  const uint8_t* al = alive + (size_t)doc * m;
  const int tid = threadIdx.x;

  float b1 = -INFINITY, b2 = -INFINITY;
  int i1 = -1, i2 = -1;
  for (int c0 = 0; c0 < m; c0 += CT) {
    const int nc = min(CT, m - c0);
    score_tile(A, nrows, D + (size_t)c0 * dim, nc, dim, sm);
    if (tid < RT) {
      for (int c = 0; c < nc; ++c) {
        const int j = c0 + c;
        const float v = al[j] ? sm.s[tid][c] : NEG;
        if (v > b1) {
          b2 = b1; i2 = i1; b1 = v; i1 = j;
        } else if (v > b2) {
          b2 = v; i2 = j;
        }
      }
    }
    __syncthreads();  // sm.s is rewritten by the next tile
  }
  if (tid < nrows) {
    // The best slot itself competes for second at -1e30 (ref.py resets
    // it rather than dropping it): it wins when nothing else beats
    // -1e30, or ties there at a lower index.
    if (b2 < NEG || (b2 == NEG && i1 < i2)) {
      b2 = NEG;
      i2 = i1;
    }
    const size_t o = (size_t)doc * N + row0 + tid;
    best[o] = b1;
    second[o] = b2;
    bi[o] = i1;
    si[o] = i2;
  }
}

extern "C" int maxsim_top2_launch(const float* samples, const float* tokens,
                                  const uint8_t* alive, int B, int N, int m,
                                  int dim, float* best, float* second,
                                  int* bi, int* si, void* stream) {
  if (B > 0 && N > 0) {
    dim3 grid(B, (N + RT - 1) / RT);
    maxsim_top2_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        samples, tokens, alive, N, m, dim, best, second, bi, si);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_ERROR_STRING(maxsim_top2)

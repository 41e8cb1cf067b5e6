// maxsim_topk — the shortlist-rescan hot path, batched over documents.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/maxsim_topk/maxsim_topk.py::maxsim_topk (_kernel).
// For samples (N, dim) and a bucket tokens (B, m, dim) with alive (B, m),
// writes per (document, sample) the k largest scores of
// where(alive, samples . tokens^T, -1e30) sorted descending and their
// token indices — equal to lax.top_k of the masked matrix, ties to the
// lowest index, dead tokens included at -1e30.
//
// Bound on the H100: operations (2*B*N*m*dim fp32 flops on the CUDA
// cores; the top-k insertion adds O(k) compares per score).
// Design: one launch per rescan for a whole bucket (grid = documents x
// sample tiles); 64 x 64 score tiles live in shared memory
// (score_tile.cuh) and each of 64 threads keeps its own sample's
// sorted k-list (k <= 32) in local memory.  Tokens arrive in ascending
// index order and an entry moves ahead of another only on a strictly
// larger value, so the list is ordered on (value desc, index asc) with
// no index compare at all.  The list starts EMPTY rather than seeded with
// sentinels: every real token — dead ones at -1e30 with their real
// index — enters, so a dead token shows up in the output exactly when
// fewer than k tokens are alive, as in the reference (whose NEG-valued
// seeds carry out-of-range indices and lose every tie to a real token).
// Padded columns past m never enter.

#include "score_tile.cuh"

using namespace repro;

constexpr int KMAX = 32;

__global__ void __launch_bounds__(NT)
maxsim_topk_kernel(const float* __restrict__ samples,
                   const float* __restrict__ tokens,
                   const uint8_t* __restrict__ alive, int N, int m, int dim,
                   int k, float* __restrict__ vals, int* __restrict__ idxs) {
  __shared__ TileSmem sm;
  const int doc = blockIdx.x;
  const int row0 = blockIdx.y * RT;
  const int nrows = min(RT, N - row0);
  const float* A = samples + (size_t)row0 * dim;
  const float* D = tokens + (size_t)doc * m * dim;
  const uint8_t* al = alive + (size_t)doc * m;
  const int tid = threadIdx.x;

  float kv[KMAX];
  int ki[KMAX];
  int cnt = 0;
  for (int c0 = 0; c0 < m; c0 += CT) {
    const int nc = min(CT, m - c0);
    score_tile(A, nrows, D + (size_t)c0 * dim, nc, dim, sm);
    if (tid < RT) {
      for (int c = 0; c < nc; ++c) {
        const int j = c0 + c;
        const float v = al[j] ? sm.s[tid][c] : NEG;
        if (cnt < k || v > kv[k - 1]) {
          int p = cnt < k ? cnt : k - 1;
          while (p > 0 && kv[p - 1] < v) {
            kv[p] = kv[p - 1];
            ki[p] = ki[p - 1];
            --p;
          }
          kv[p] = v;
          ki[p] = j;
          if (cnt < k) ++cnt;
        }
      }
    }
    __syncthreads();
  }
  if (tid < nrows) {
    const size_t o = ((size_t)doc * N + row0 + tid) * k;
    for (int p = 0; p < k; ++p) {
      vals[o + p] = kv[p];
      idxs[o + p] = ki[p];
    }
  }
}

extern "C" int maxsim_topk_launch(const float* samples, const float* tokens,
                                  const uint8_t* alive, int B, int N, int m,
                                  int dim, int k, float* vals, int* idxs,
                                  void* stream) {
  if (k < 1 || k > KMAX || k > m) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0 && N > 0) {
    dim3 grid(B, (N + RT - 1) / RT);
    maxsim_topk_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        samples, tokens, alive, N, m, dim, k, vals, idxs);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_ERROR_STRING(maxsim_topk)

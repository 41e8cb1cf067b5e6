// colbert_maxsim — exact ColBERT MaxSim scoring for serving.
//
// Replaces two Pallas TPU kernels of
//   src/repro/kernels/colbert_maxsim/colbert_maxsim.py:
//   * colbert_maxsim_multi (_kernel_multi): a query batch (n_q, l, dim)
//     against a doc array (n_docs, m, dim) -> (n_q, n_docs);
//   * colbert_maxsim (_kernel), which ops.colbert_maxsim_rerank_op vmaps
//     over per-query candidate blocks: queries (n_q, l, dim) against
//     their own docs (n_q, n_cand, m, dim) -> (n_q, n_cand), in ONE
//     launch over (candidates x queries).
// score(q, d) = sum over live query tokens of the max over live doc
// tokens of q.d; masked doc tokens score -1e30 and masked query tokens
// contribute 0, so an all-masked doc scores the finite l x -1e30
// sentinel the streaming pad audits rely on (never -inf or NaN).
//
// Bound on the H100: operations (2*n_q*l*n_docs*m*dim fp32 flops on the
// CUDA cores) at the serving shapes; bytes read are the doc tokens once.
// Design: a block owns one doc (one candidate) and a 64-row tile of
// flattened query tokens — whole queries only, floor(64 / l) of them —
// and sweeps the doc's tokens in 64-column tiles (score_tile.cuh), so a
// doc of any length fits in 25 KB of static shared memory.  Each of 64
// threads keeps its row's running fp32 max; the per-query sum over l
// token maxes runs in double and is rounded once, so it does not depend
// on a summation order.  The 4-D (n_q, n_docs, l, m) tensor of the plain
// version never exists.

#include "score_tile.cuh"

using namespace repro;

// RERANK: doc array is (n_q, n_docs, m, dim) and each query reads its
// own slab; otherwise all queries share (n_docs, m, dim).
template <bool RERANK>
__global__ void __launch_bounds__(NT)
colbert_maxsim_kernel(const float* __restrict__ q,
                      const uint8_t* __restrict__ qmask,
                      const float* __restrict__ docs,
                      const uint8_t* __restrict__ dmask, int n_q, int l,
                      int n_docs, int m, int dim, int qb,
                      float* __restrict__ out) {
  __shared__ TileSmem sm;
  __shared__ float rowmax[RT];
  const int d = blockIdx.x;
  const int q0 = blockIdx.y * qb;
  const int nq = min(qb, n_q - q0);
  const int nrows = nq * l;
  const float* A = q + (size_t)q0 * l * dim;
  const size_t doc = RERANK ? (size_t)q0 * n_docs + d : (size_t)d;
  const float* D = docs + doc * m * dim;
  const uint8_t* dm = dmask + doc * m;
  const int tid = threadIdx.x;

  float rmax = -INFINITY;
  for (int c0 = 0; c0 < m; c0 += CT) {
    const int nc = min(CT, m - c0);
    score_tile(A, nrows, D + (size_t)c0 * dim, nc, dim, sm);
    if (tid < RT) {
      for (int c = 0; c < nc; ++c)
        rmax = fmaxf(rmax, dm[c0 + c] ? sm.s[tid][c] : NEG);
    }
    __syncthreads();
  }
  if (tid < RT) rowmax[tid] = rmax;
  __syncthreads();
  if (tid < nq) {
    const int qi = q0 + tid;
    double acc = 0.0;
    for (int t = 0; t < l; ++t)
      if (qmask[(size_t)qi * l + t]) acc += (double)rowmax[tid * l + t];
    out[(size_t)qi * n_docs + d] = (float)acc;
  }
}

static int launch(bool rerank, const float* q, const uint8_t* qmask,
                  const float* docs, const uint8_t* dmask, int n_q, int l,
                  int n_docs, int m, int dim, float* out, void* stream) {
  if (l < 1 || l > RT) return static_cast<int>(cudaErrorInvalidValue);
  const int qb = rerank ? 1 : RT / l;
  if (n_q > 0 && n_docs > 0) {
    dim3 grid(n_docs, (n_q + qb - 1) / qb);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (rerank)
      colbert_maxsim_kernel<true><<<grid, NT, 0, s>>>(
          q, qmask, docs, dmask, n_q, l, n_docs, m, dim, qb, out);
    else
      colbert_maxsim_kernel<false><<<grid, NT, 0, s>>>(
          q, qmask, docs, dmask, n_q, l, n_docs, m, dim, qb, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int colbert_maxsim_multi_launch(const float* q,
                                           const uint8_t* qmask,
                                           const float* docs,
                                           const uint8_t* dmask, int n_q,
                                           int l, int n_docs, int m, int dim,
                                           float* out, void* stream) {
  return launch(false, q, qmask, docs, dmask, n_q, l, n_docs, m, dim, out,
                stream);
}

extern "C" int colbert_maxsim_rerank_launch(const float* q,
                                            const uint8_t* qmask,
                                            const float* docs,
                                            const uint8_t* dmask, int n_q,
                                            int l, int n_cand, int m,
                                            int dim, float* out,
                                            void* stream) {
  return launch(true, q, qmask, docs, dmask, n_q, l, n_cand, m, dim, out,
                stream);
}

REPRO_ERROR_STRING(colbert_maxsim)

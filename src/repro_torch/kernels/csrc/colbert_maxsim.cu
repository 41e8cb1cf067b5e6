// colbert_maxsim — exact ColBERT MaxSim scoring for serving.
//
// Replaces four Pallas TPU kernels of
//   src/repro/kernels/colbert_maxsim/colbert_maxsim.py:
//   * colbert_maxsim_multi (_kernel_multi): a query batch (n_q, l, dim)
//     against a doc array (n_docs, m, dim) -> (n_q, n_docs);
//   * colbert_maxsim (_kernel), which ops.colbert_maxsim_rerank_op vmaps
//     over per-query candidate blocks: queries (n_q, l, dim) against
//     their own docs (n_q, n_cand, m, dim) -> (n_q, n_cand), in ONE
//     launch over (candidates x queries);
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
// Bound on the H100: operations (2*n_q*l*n_docs*m*dim fp32 flops on the
// CUDA cores) at the serving shapes; bytes read are the doc tokens once
// (4, 2, or 1 + dim*bits/8 + 4 bytes a token).
// Design: a block owns one doc (one candidate) and a 64-row tile of
// flattened query tokens — whole queries only, floor(64 / l) of them —
// and sweeps the doc's tokens in 64-column tiles (score_tile.cuh), so a
// doc of any length fits in 25 KB of static shared memory.  The doc
// format is a template parameter: its loader widens bf16 or decodes the
// residual codec while the tile is staged into shared memory, so the
// decoded bucket exists one tile at a time.  Each of 64 threads keeps
// its row's running fp32 max; the per-query sum over l token maxes runs
// in double and is rounded once, so it does not depend on a summation
// order.  The 4-D (n_q, n_docs, l, m) tensor of the plain version never
// exists.

#include "score_tile.cuh"

using namespace repro;

// Doc sources: doc(d) is the loader of flat doc index d.
template <class T>
struct DenseDocs {
  const T* docs;
  int m, dim;
  __device__ __forceinline__ DenseCols<T> doc(size_t d) const {
    return {docs + d * m * dim, dim};
  }
};

// bucket_of entries outside [0, n_tables) are clamped, like codes.
template <int BITS>
struct ResidualDocs {
  const int8_t* codes;
  const uint8_t* resq;
  const float* scale;
  const float* codebooks;   // one (C, dim) table, or (n_buckets, C, dim)
  const int* bucket_of;     // null: every doc uses table 0
  int m, dim, n_centroids, n_tables;
  __device__ __forceinline__ ResidualCols<BITS> doc(size_t d) const {
    const size_t cb =
        bucket_of ? (size_t)min(max(bucket_of[d], 0), n_tables - 1) : 0;
    return {codes + d * m, resq + d * m * (dim * BITS / 8), scale + d * m,
            codebooks + cb * n_centroids * dim, dim, n_centroids};
  }
};

// RERANK: the doc axis is (n_q, n_docs) and each query reads its own
// slab; otherwise all queries share (n_docs, ...).
template <bool RERANK, class Docs>
__global__ void __launch_bounds__(NT)
colbert_maxsim_kernel(const float* __restrict__ q,
                      const uint8_t* __restrict__ qmask, Docs docs,
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
  const auto D = docs.doc(doc);
  const uint8_t* dm = dmask + doc * m;
  const int tid = threadIdx.x;

  float rmax = -INFINITY;
  for (int c0 = 0; c0 < m; c0 += CT) {
    const int nc = min(CT, m - c0);
    score_tile(A, nrows, D, c0, nc, dim, sm);
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

template <class Docs>
static int launch(bool rerank, const float* q, const uint8_t* qmask,
                  Docs docs, const uint8_t* dmask, int n_q, int l,
                  int n_docs, int m, int dim, float* out, void* stream) {
  if (l < 1 || l > RT) return static_cast<int>(cudaErrorInvalidValue);
  const int qb = rerank ? 1 : RT / l;
  if (n_q > 0 && n_docs > 0) {
    dim3 grid(n_docs, (n_q + qb - 1) / qb);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (rerank)
      colbert_maxsim_kernel<true, Docs><<<grid, NT, 0, s>>>(
          q, qmask, docs, dmask, n_q, l, n_docs, m, dim, qb, out);
    else
      colbert_maxsim_kernel<false, Docs><<<grid, NT, 0, s>>>(
          q, qmask, docs, dmask, n_q, l, n_docs, m, dim, qb, out);
  }
  return static_cast<int>(cudaGetLastError());
}

static int launch_dense(bool rerank, const float* q, const uint8_t* qmask,
                        const void* docs, const uint8_t* dmask, int n_q,
                        int l, int n_docs, int m, int dim, int bf16,
                        float* out, void* stream) {
  if (bf16)
    return launch(rerank, q, qmask,
                  DenseDocs<__nv_bfloat16>{
                      static_cast<const __nv_bfloat16*>(docs), m, dim},
                  dmask, n_q, l, n_docs, m, dim, out, stream);
  return launch(rerank, q, qmask,
                DenseDocs<float>{static_cast<const float*>(docs), m, dim},
                dmask, n_q, l, n_docs, m, dim, out, stream);
}

static int launch_residual(bool rerank, const float* q,
                           const uint8_t* qmask, const int8_t* codes,
                           const uint8_t* resq, const float* scale,
                           const float* codebooks, const int* bucket_of,
                           int n_tables, const uint8_t* dmask, int n_q,
                           int l, int n_docs, int m, int dim,
                           int n_centroids, int bits, float* out,
                           void* stream) {
  if ((bits != 2 && bits != 4) || dim % (8 / bits) || n_centroids < 1 ||
      n_tables < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bits == 2)
    return launch(rerank, q, qmask,
                  ResidualDocs<2>{codes, resq, scale, codebooks, bucket_of,
                                  m, dim, n_centroids, n_tables},
                  dmask, n_q, l, n_docs, m, dim, out, stream);
  return launch(rerank, q, qmask,
                ResidualDocs<4>{codes, resq, scale, codebooks, bucket_of, m,
                                dim, n_centroids, n_tables},
                dmask, n_q, l, n_docs, m, dim, out, stream);
}

extern "C" int colbert_maxsim_multi_launch(const float* q,
                                           const uint8_t* qmask,
                                           const void* docs,
                                           const uint8_t* dmask, int n_q,
                                           int l, int n_docs, int m, int dim,
                                           int bf16, float* out,
                                           void* stream) {
  return launch_dense(false, q, qmask, docs, dmask, n_q, l, n_docs, m, dim,
                      bf16, out, stream);
}

extern "C" int colbert_maxsim_rerank_launch(const float* q,
                                            const uint8_t* qmask,
                                            const void* docs,
                                            const uint8_t* dmask, int n_q,
                                            int l, int n_cand, int m,
                                            int dim, int bf16, float* out,
                                            void* stream) {
  return launch_dense(true, q, qmask, docs, dmask, n_q, l, n_cand, m, dim,
                      bf16, out, stream);
}

extern "C" int colbert_maxsim_residual_multi_launch(
    const float* q, const uint8_t* qmask, const int8_t* codes,
    const uint8_t* resq, const float* scale, const float* codebook,
    const uint8_t* dmask, int n_q, int l, int n_docs, int m, int dim,
    int n_centroids, int bits, float* out, void* stream) {
  return launch_residual(false, q, qmask, codes, resq, scale, codebook,
                         nullptr, 1, dmask, n_q, l, n_docs, m, dim,
                         n_centroids, bits, out, stream);
}

extern "C" int colbert_maxsim_residual_rerank_launch(
    const float* q, const uint8_t* qmask, const int8_t* codes,
    const uint8_t* resq, const float* scale, const float* codebooks,
    const int* bucket_of, int n_buckets, const uint8_t* dmask, int n_q,
    int l, int n_cand, int m, int dim, int n_centroids, int bits, float* out,
    void* stream) {
  return launch_residual(true, q, qmask, codes, resq, scale, codebooks,
                         bucket_of, n_buckets, dmask, n_q, l, n_cand, m, dim,
                         n_centroids, bits, out, stream);
}

REPRO_ERROR_STRING(colbert_maxsim)

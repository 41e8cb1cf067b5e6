// The fp32 score-tile engine of the one retrieval kernel not yet on the
// tensor cores: the rerank (B4, colbert_maxsim.cu).
//
// It computes a small dense product S = A . B^T (A: rows x dim, B:
// cols x dim, fp32) and reduces each row of S over the columns (max).
// The TPU kernel kept that product in VMEM; here one 256-thread block
// computes one RT x CT tile of S with a classic shared-memory tiled
// SGEMM on the CUDA cores (each thread owns a 4 x 4 register micro-tile,
// the dim axis streams through shared memory DK values at a time), then
// parks the tile in shared memory so the caller's epilogue can scan each
// row in ascending column order.  Nothing (rows x cols)-shaped ever
// reaches device memory.
//
// Numerics: IEEE fp32 fmaf, dim summed in ascending order — no TF32,
// no tensor cores (fp32 on Hopper's tensor cores exists only as TF32).
// Rows past `nrows` and columns past `ncols` read as 0 and must be
// ignored by the epilogue.
//
// The B side comes through a loader, `B(c, k)` = element k of column c
// as fp32: fp32 and bf16 doc tokens (DenseCols, bf16 widened exactly).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int RT = 64;    // rows per tile
constexpr int CT = 64;    // columns per tile
constexpr int DK = 16;    // dim slice staged per step
constexpr int NT = 256;   // threads per block (16 x 16, 4 x 4 each)
constexpr float NEG = -1e30f;

struct TileSmem {
  float a[DK][RT + 1];
  float b[DK][CT + 1];
  float s[RT][CT + 1];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Dense doc tokens, row-major (cols, dim), fp32 or bf16.
template <class T>
struct DenseCols {
  const T* p;
  int dim;
  __device__ __forceinline__ float operator()(int c, int k) const {
    return to_f32(p[(size_t)c * dim + k]);
  }
};

// S[r][c] = dot(A[r], B(c0 + c, .)) for r < RT, c < CT into sm.s.  A
// points at the tile's first row, row-major with row length `dim`.
// Ends with a __syncthreads(): sm.s is readable by every thread.
template <class Cols>
__device__ __forceinline__ void score_tile(const float* __restrict__ A,
                                           int nrows, const Cols& B,
                                           int c0, int ncols, int dim,
                                           TileSmem& sm) {
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < dim; k0 += DK) {
    for (int e = tid; e < RT * DK; e += NT) {
      const int r = e / DK, k = e % DK;
      sm.a[k][r] = (r < nrows && k0 + k < dim)
                       ? A[(size_t)r * dim + k0 + k] : 0.f;
    }
    for (int e = tid; e < CT * DK; e += NT) {
      const int c = e / DK, k = e % DK;
      sm.b[k][c] = (c < ncols && k0 + k < dim) ? B(c0 + c, k0 + k) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sm.a[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sm.b[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sm.s[ty * 4 + i][tx * 4 + j] = acc[i][j];
  __syncthreads();
}

}  // namespace repro

#define REPRO_ERROR_STRING(prefix)                              \
  extern "C" const char* prefix##_error_string(int err) {       \
    return cudaGetErrorString(static_cast<cudaError_t>(err));   \
  }

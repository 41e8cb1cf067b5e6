// embedding_bag — fused gather and reduce of table rows per bag (the
// recsys family's lookups).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/embedding_bag/embedding_bag.py:36
//   ::embedding_bag (_kernel; pallas_call at :56).
// For a table (V, D) fp32 and ids (n_bags, nnz) int32 it writes, per
// bag, out[b] = sum_j table[ids[b, j]] in fp32, divided by nnz when
// mean is set (a division, as the Pallas wrapper divides).  The rows of
// a bag are added onto zero one at a time, j = 0 ... nnz-1 ascending:
// the Pallas kernel's order (its grid walks j sequentially and does
// out_ref[...] += row), so on fp32 the result equals that kernel's bit
// for bit, and at nnz = 1 it equals a plain gather.
//
// Ids out of range follow the oracle's jnp.take: an id in [-V, 0) wraps
// to id + V, an id outside [-V, V) gives a NaN row.  The kernel never
// reads outside the table.
//
// The TPU kernel's grid is (n_bags, nnz), run in order, with the ids
// prefetched as scalars so the DMA of the next row overlaps the add.
// Here G lanes of a warp own one bag (G = the row's 16-byte units,
// rounded up to a power of two, at most 32; several bags share a warp
// when D is narrow), load their bag's ids themselves and keep the sum
// in registers; a grid-stride loop walks the bags (6.8 M of them at
// dlrm-rm2's serve_bulk lookup).  Loads of the rows of one bag are
// independent, so the unrolled j loop keeps several in flight.
//
// Bound on the H100: device-memory bytes.  Each gathered row is read
// once and each bag's output written once (plus the ids), with one add
// per element read: far below the card's flop/byte ridge.  The design
// does what the Pallas kernel does about that: no (nnz, D) intermediate
// reaches device memory.  Rows are read as coalesced 16-byte loads when
// D % 4 == 0 and the table and output are 16-byte aligned (D 64: one
// 256-byte row per 16 lanes); otherwise a scalar path reads 4 bytes a
// lane.  At D = 1 (Wide & Deep's wide table) a 4-byte row still costs
// the card a whole 32-byte sector: that is the table's layout, not the
// kernel's, so its bound counts the useful bytes.
//
// 64-bit offsets.  The stacked dlrm-rm2 table has 27,262,976 rows of 64
// floats (6.98 GB): row * D overflows 32 bits.  Every row and bag
// address here is computed in 64 bits.  A test at a small V cannot show
// that fault; chip_smoke.py reads back rows at the end of the stacked
// table on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 16384;

// The row an id selects, by jnp.take's rule; false for a NaN row.
__device__ __forceinline__ bool row_of(int id, long long V, long long* row) {
  long long r = id;
  if (r < 0) r += V;
  *row = r;
  return r >= 0 && r < V;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// G lanes own one bag; lane t holds the 16-byte units t, t + G, ... of
// the row (d4 units of 4 floats).
template <int G>
__global__ void __launch_bounds__(kThreads)
bag_vec4(const float4* __restrict__ table, const int* __restrict__ ids,
         long long V, int n_bags, int nnz, int d4, int mean,
         float4* __restrict__ out) {
  const float nan = __int_as_float(0x7fc00000);
  const float4 nan4 = make_float4(nan, nan, nan, nan);
  const long long groups = (long long)gridDim.x * (kThreads / G);
  const int t = threadIdx.x % G;
  for (long long bag = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
       bag < n_bags; bag += groups) {
    const int* bid = ids + bag * nnz;
    for (int c = t; c < d4; c += G) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int j = 0; j < nnz; ++j) {
        long long row;
        const float4 v = row_of(__ldg(bid + j), V, &row)
                             ? __ldg(table + row * d4 + c) : nan4;
        acc = add4(acc, v);
      }
      if (mean) {
        const float n = (float)nnz;
        acc = make_float4(acc.x / n, acc.y / n, acc.z / n, acc.w / n);
      }
      out[bag * d4 + c] = acc;
    }
  }
}

// The same with 4-byte loads, for any D and alignment.
template <int G>
__global__ void __launch_bounds__(kThreads)
bag_scalar(const float* __restrict__ table, const int* __restrict__ ids,
           long long V, int n_bags, int nnz, int D, int mean,
           float* __restrict__ out) {
  const float nan = __int_as_float(0x7fc00000);
  const long long groups = (long long)gridDim.x * (kThreads / G);
  const int t = threadIdx.x % G;
  for (long long bag = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
       bag < n_bags; bag += groups) {
    const int* bid = ids + bag * nnz;
    for (int c = t; c < D; c += G) {
      float acc = 0.f;
#pragma unroll 4
      for (int j = 0; j < nnz; ++j) {
        long long row;
        acc += row_of(__ldg(bid + j), V, &row) ? __ldg(table + row * D + c)
                                               : nan;
      }
      if (mean) acc = acc / (float)nnz;
      out[bag * D + c] = acc;
    }
  }
}

int pow2_group(int units) {
  int g = 1;
  while (g < units && g < 32) g *= 2;
  return g;
}

long long n_blocks(int n_bags, int g) {
  const long long per_block = kThreads / g;
  long long b = (n_bags + per_block - 1) / per_block;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

template <int G>
void launch_vec4(const float* table, const int* ids, long long V, int D,
                 int n_bags, int nnz, int mean, float* out, cudaStream_t s) {
  bag_vec4<G><<<(unsigned)n_blocks(n_bags, G), kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(table), ids, V, n_bags, nnz, D / 4,
      mean, reinterpret_cast<float4*>(out));
}

template <int G>
void launch_scalar(const float* table, const int* ids, long long V, int D,
                   int n_bags, int nnz, int mean, float* out,
                   cudaStream_t s) {
  bag_scalar<G><<<(unsigned)n_blocks(n_bags, G), kThreads, 0, s>>>(
      table, ids, V, n_bags, nnz, D, mean, out);
}

using Launch = void (*)(const float*, const int*, long long, int, int, int,
                        int, float*, cudaStream_t);

template <int G>
Launch pick_g(bool vec) {
  return vec ? &launch_vec4<G> : &launch_scalar<G>;
}

Launch pick(bool vec, int g) {
  switch (g) {
    case 1: return pick_g<1>(vec);
    case 2: return pick_g<2>(vec);
    case 4: return pick_g<4>(vec);
    case 8: return pick_g<8>(vec);
    case 16: return pick_g<16>(vec);
    default: return pick_g<32>(vec);
  }
}

}  // namespace

extern "C" int embedding_bag_launch(const float* table, const int* ids,
                                    long long V, int D, int n_bags, int nnz,
                                    int mean, float* out, void* stream) {
  if (n_bags > 0 && D > 0) {
    const bool vec = D % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    pick(vec, pow2_group(vec ? D / 4 : D))(
        table, ids, V, D, n_bags, nnz, mean, out,
        static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* embedding_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

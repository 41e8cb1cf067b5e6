// flash_attention — attention forward with an online softmax (LM prefill).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py:84
//   ::flash_attention (_kernel; pallas_call at :107),
// with the GQA front of its ops.py.  For q (B, H, Sq, d) and k, v
// (B, KV, Sk, d), H % KV == 0, it writes o = softmax(q kᵀ · scale) v per
// head, query head h reading KV head h / (H / KV) (the mapping of
// jnp.repeat in ops.py, without the repeat).  scale = 1/√d, masked
// scores are -1e30, and key j is visible to query i iff j < Sk, j <= i
// if causal, j > i - window if windowed — the Pallas kernel's `vis`
// rule.  fp32 or bf16 inputs are widened to fp32 (exact), the
// scores, p = exp(s - m) and the P·V product stay fp32 (IEEE fmaf, no
// TF32, no tensor cores), and o = acc / max(l, 1e-30) is rounded once
// to q's type.
//
// The TPU kernel's K axis is a sequential grid dimension that carries
// (m, l, acc) in its output blocks; its m and l blocks index the row
// tile only, so every head shares one buffer, which is right only
// because the TPU runs the grid in order.  Here one block owns one
// (batch·head, 64-row query tile) and loops over the K tiles itself,
// keeping m and l per (head, row) in registers and the 64 x d
// accumulator in registers (4 rows x 8 strided columns a thread).
//
// Tile skipping.  A K tile that holds no column visible to any row of
// the query tile (wholly above the causal diagonal, or wholly left of
// the window) is skipped.  That is the same function: before a row's
// first visible tile, a wholly masked tile gives it m = -1e30 and
// p = exp(0) = 1 for every column, which the next visible tile wipes
// with alpha = exp(-1e30 - m_new) = 0 (the Pallas _init does the same);
// after it, such a tile gives p = 0 and alpha = 1.  Every row must see
// at least one key (with causal masking each row sees its own
// diagonal); the wrapper raises where a window leaves a row nothing.
// Query rows past Sq are computed and never stored; key columns past Sk
// are masked.
//
// Bound on the H100: operations.  At minitron-4b's prefill (4 x 24
// heads, 8 KV heads, S 2,048, d 128, causal, bf16) a layer does
// ~1.0e11 visible FLOPs (4·d per visible (row, key) pair: the two
// products) against ~134 MB of q, k, v and o.  Q·Kᵀ takes bf16 operands,
// whose products are exact in fp32, so the card's bf16 tensor cores with
// fp32 accumulation (989 TFLOP/s) compute it; P·V takes the fp32 p and
// runs at the fp32 rate (67 TFLOP/s): 0.05 + 0.77 ms, against 0.04 ms of
// memory traffic.  This first design runs both products on the CUDA
// cores (1.5 ms at 67 TFLOP/s is its own floor, not the function's).
// It keeps everything (rows x keys)-shaped in shared memory and
// registers, so the bytes stay at their floor; the limit is the fp32 FMA
// rate and the shared-memory reads that feed it (2 loads per 4 FMAs in
// Q·Kᵀ, 12 per 32 in P·V).  Later work: bf16 wgmma for Q·Kᵀ (and for
// P·V as an explicit opt-in with its own tolerance, since it rounds p),
// TMA double-buffering of the K/V tiles, and a split of long rows' K
// range across blocks.
//
// Shared memory: Q (transposed, d x 65), one K-or-V buffer (K
// transposed d x 65, then V row-major 64 x d) and the P tile (64 x 65),
// all fp32: 83,200 bytes at d = 128, above the 48 KB static limit, so
// the launch opts into dynamic shared memory; two blocks fit an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // key columns per K/V tile
constexpr int NT = 256;      // threads per block, 16 x 16
constexpr int DMAX = 128;    // widest head the accumulator holds (8 x 16)
constexpr int LD = BQ + 1;   // padded row of the transposed tiles
constexpr float NEG = -1e30f;

static_assert(BQ == BK, "the transposed Q and K tiles share LD");

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows [r0, r0 + 64) of a row-major (S, d) matrix as fp32, 0 past S:
// transposed, dst[k * LD + r] (Q and K), or row-major, dst[r * d + k]
// (V).  Eight consecutive elements per thread and step (16-byte loads).
template <bool TRANSPOSE, class T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int r0,
                                          int S, int d,
                                          float* __restrict__ dst) {
  const int n8 = d / 8;
  for (int e = threadIdx.x; e < BQ * n8; e += NT) {
    const int r = e / n8, k = (e % n8) * 8;
    float x[8];
    if (r0 + r < S) {
      load8(src + (size_t)(r0 + r) * d + k, x);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = 0.f;
    }
    if (TRANSPOSE) {
#pragma unroll
      for (int u = 0; u < 8; ++u) dst[(k + u) * LD + r] = x[u];
    } else {
      float4* p = reinterpret_cast<float4*>(dst + r * d + k);
      p[0] = make_float4(x[0], x[1], x[2], x[3]);
      p[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
  }
}

// Reductions over the 16 lanes of a half-warp: the 16 threads that
// share a row (thread = ty * 16 + tx, rows by ty).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Thread (ty, tx) owns query rows ty + 16 i (i < 4), score columns
// tx + 16 j (j < 4) and output columns tx + 16 j (j < 8, < d): strided
// so that a half-warp reads 16 consecutive shared-memory words.
template <class T>
__global__ void __launch_bounds__(NT, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int KV, int Sq, int Sk, int d, int causal,
                       int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;              // [d][LD]  Q tile, transposed
  float* kv = qs + d * LD;       // [d][LD]  K tile, transposed; then
                                 // [BK][d] V tile, row-major
  float* ps = kv + d * LD;       // [BQ][LD] P tile

  const int bh = blockIdx.x;     // b * H + h
  const int kvh = (bh / H) * KV + (bh % H) / (H / KV);
  // heaviest causal tiles (the last rows) are dispatched first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const T* qp = q + (size_t)bh * Sq * d;
  const T* kp = k + (size_t)kvh * Sk * d;
  const T* vp = v + (size_t)kvh * Sk * d;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  // Key columns any row of this tile can see: [lo, hi).
  const int hi = causal ? min(Sk, q0 + BQ) : Sk;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;

  load_tile<true>(qp, q0, Sq, d, qs);

  float acc[4][8], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    load_tile<true>(kp, k0, Sk, d, kv);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < d; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[kk * LD + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = kv[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
    __syncthreads();             // every thread is done with the K tile
    load_tile<false>(vp, k0, Sk, d, kv);

    // online softmax: m' = max(m, rowmax s), l' = l·α + Σ exp(s - m'),
    // acc' = acc·α + exp(s - m')·V, α = exp(m - m')
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mt = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool vis = col < Sk && (!causal || col <= row) &&
                         (window <= 0 || col > row - window);
        s[i][j] = vis ? s[i][j] * scale : NEG;
        mt = fmaxf(mt, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max(mt));
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        ps[(ty + 16 * i) * LD + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();             // P and V tiles are in shared memory

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4], w[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        w[j] = tx + 16 * j < d ? kv[c * d + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
    __syncthreads();             // the next tile overwrites K/V and P
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    T* out = o + ((size_t)bh * Sq + row) * d;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      if (col < d) store(out + col, acc[i][j] / den);
    }
  }
}

template <class T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int Sq, int Sk, int d, int causal, int window,
           float scale, cudaStream_t stream) {
  const int smem = (2 * d * LD + BQ * LD) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_attention_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, Sq, Sk, d, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (q, k, v and o share it).  window <= 0
// means no window.  Returns a cudaError_t code.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int KV, int Sq, int Sk, int d,
                                      int causal, int window, float scale,
                                      int dtype, void* stream) {
  if (d < 8 || d > DMAX || d % 8 || KV < 1 || H < KV || H % KV || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || Sq < 1) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, o, B, H, KV, Sq, Sk, d, causal, window,
                           scale, s);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Sk, d, causal,
                                   window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared Hopper (sm_90a) pieces of the port's tensor-core kernels.
//
// B7's device helpers (moved here from flash_attention.cu unchanged):
// shared-memory addresses, mbarriers, 3-D TMA loads, wgmma smem
// descriptors of swizzled operands (128B, or 64B for fp32 B7's 64-byte
// rows), the wgmma fences and wrappers,
// quad reductions over the four threads that share an accumulator row,
// and the two-term bf16 split of B7's p (m64n128k16 from shared memory
// gained an accumulate flag that defaults to B7's 1; m64n32k16 with A
// from registers is fp32 B7's P·V at head dims up to 32).  New beside them:
// the wgmma shape m64n64k16 with both operands from shared memory,
// commit and wait as two calls, a lane-0 broadcast the compiler knows
// to be warp-uniform, named barriers, a host encoder of 3-D tensor maps,
// the three-term split pre-pass of the score kernels and their
// two-accumulator 64 x 64 split tile (maxsim_sm90.cuh, colbert_maxsim.cu)
// with its step-by-step, round-to-nearest variant (B3-B6; A blocks of
// 128 or 64 rows, B panels 64 or 128 rows apart), and, for a producer
// that writes wgmma operands itself (B4's split, B5's and B6's decode,
// fp32 B7's split), 16-byte shared loads and stores and the
// generic-to-async proxy fence.
//
// The three-term split.  For fp32 x let hi = RN_bf16(x), mid =
// RN_bf16(x - hi) and lo = RN_bf16(x - hi - mid).  Both subtractions
// are exact in fp32 (Sterbenz: each operand pair lies within a factor of
// two), hi keeps x's top 8 significant bits and mid the next 8, so
// x - hi - mid has at most 8 significant bits left and lo holds them
// exactly: hi + mid + lo == x for every normal x whose lo is a normal
// bf16 (|x| >= ~2^-110).  Below that lo is a bf16 subnormal and may
// round, and the tensor cores may flush it; the score kernels' inputs
// (unit-norm embeddings and sphere samples) never come near.  Each
// product of two bf16 terms is exact in fp32 (8 x 8 significant bits),
// so a product of split operands summed in an fp32 accumulator gives
// the fp32 dot product up to the order of the sums, once the terms
// below 2^-24 relative (mid·lo, lo·mid, lo·lo) are dropped.
//
// The pre-pass writes the three planes of a row-major (rows, dim) fp32
// matrix as (3, rows, PLANE_DP) bf16, zero past dim, and one flag per
// group of rows: 1 iff any mid or lo of the group is non-zero.  The
// mid and lo planes of a group are written only when its flag is set,
// so a kernel reads them only then; on bf16-exact data (the encoder's
// output, widened) the flag is 0 and a kernel spends one bf16 product
// per score — precision is decided by the data, never by a knob.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.  A
// barrier that does not complete within ~2^34 cycles (several seconds)
// traps, so a protocol fault ends the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// One box of a 3-D tensor map (column c0, row c1, matrix c2) into shared
// memory at dst; completion adds its bytes to bar's transaction count.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a swizzled operand: start address,
// leading and stride byte offsets (16-byte units), layout B128 (1, rows
// of 128 bytes) or B64 (2, rows of 64 bytes).  K-major (Q, K): the
// stride offset is the 8 rows of a swizzle atom (1,024 bytes in B128);
// the leading offset is unused.  MN-major (V): the leading offset is the
// stride between column panels, the stride offset the 8 keys of an
// atom.  A shared address is below 2^18, so the descriptor of addr +
// off is this one plus off / 16.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo,
                                              uint32_t layout = 1) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pin accumulator registers in place across an asynchronous wgmma, so
// that no read or write of them is moved across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A and B from shared memory
// through their descriptors, both K-major.  acc = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A from registers (the bf16
// fragment, four b32 of two values each), B from shared memory,
// MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (the bf16
// fragment, four b32 of two values each), B from shared memory,
// MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// D[64 x 32] += A[64 x 16] B[16 x 32]: A from registers (the bf16
// fragment, four b32 of two values each), B from shared memory,
// MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], uint32_t a0,
                                            uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// p = hi + lo to ~2^-17 relative: the A fragments of P_hi and P_lo for
// two neighbouring columns of one row.
__device__ __forceinline__ void split(float p0, float p1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(p0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(p1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(__float2bfloat16_rn(p0 - __bfloat162float(h0)),
                 __float2bfloat16_rn(p1 - __bfloat162float(h1)));
}

// D[64 x 64] = A[64 x 16] B[16 x 64] + (acc ? D : 0): A and B from
// shared memory through their descriptors, both K-major.  acc = 0 on a
// tile's first k step spares zeroing the accumulator.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// D[64 x 32] = A[64 x 16] B[16 x 32] + (acc ? D : 0): A and B from
// shared memory through their descriptors, both K-major.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// x of lane 0, which the compiler knows to be warp-uniform: a branch on
// it around wgmma is not a divergent path (ptxas otherwise serializes
// the wgmmas behind its own warpgroup arrives).  The warps are
// converged.
__device__ __forceinline__ int uniform(int x) {
  return __shfl_sync(0xffffffffu, x, 0);
}

// Order this thread's generic-proxy writes to shared memory before later
// async-proxy reads (wgmma operands): each writer fences, then arrives
// on the barrier the readers wait for.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ float4 ld_shared_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// Named barrier `id` (1..15; 0 is __syncthreads) over `count` threads:
// wait for it, or only arrive.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// ---- the three-term split ----

constexpr int PLANE_DP = 128;   // bf16 columns in a plane row: dim <= 128

__device__ __forceinline__ void split3(float x, __nv_bfloat16& hi,
                                       __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(r - __bfloat162float(mid));
}

// One block per group of `group_rows` rows; 8 columns a thread and step,
// one 16-byte store per plane.  The second pass (mid and lo) runs only
// for a group with a non-zero term, and recomputes the split.
__global__ void __launch_bounds__(256)
split_planes_kernel(const float* __restrict__ x, int rows, int dim,
                    int group_rows, __nv_bfloat16* __restrict__ planes,
                    int* __restrict__ flags) {
  constexpr int C8 = PLANE_DP / 8;
  const int r0 = blockIdx.x * group_rows;
  const int n = min(group_rows, rows - r0) * C8;
  const size_t plane = (size_t)rows * PLANE_DP;
  int nz = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int r = r0 + e / C8, c = (e % C8) * 8;
      const float* src = x + (size_t)r * dim;
      uint32_t h[4], m[4], l[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        __nv_bfloat16 h0, m0, l0, h1, m1, l1;
        split3(c + 2 * u < dim ? src[c + 2 * u] : 0.f, h0, m0, l0);
        split3(c + 2 * u + 1 < dim ? src[c + 2 * u + 1] : 0.f, h1, m1, l1);
        h[u] = pack_bf16(h0, h1);
        m[u] = pack_bf16(m0, m1);
        l[u] = pack_bf16(l0, l1);
      }
      __nv_bfloat16* dst = planes + (size_t)r * PLANE_DP + c;
      if (pass == 0) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], h[2], h[3]);
#pragma unroll
        for (int u = 0; u < 4; ++u) nz |= (m[u] | l[u]) & 0x7FFF7FFFu;
      } else {
        *reinterpret_cast<uint4*>(dst + plane) =
            make_uint4(m[0], m[1], m[2], m[3]);
        *reinterpret_cast<uint4*>(dst + 2 * plane) =
            make_uint4(l[0], l[1], l[2], l[3]);
      }
    }
    if (pass == 0) {
      nz = __syncthreads_or(nz);
      if (threadIdx.x == 0) flags[blockIdx.x] = nz != 0;
      if (!nz) return;
    }
  }
}

// One 64 x 64 score tile of a warpgroup from split operands in shared
// memory: A is 64 rows of a 128-row block (three planes, SPLIT_A_PLANE
// apart), B a 64-row tile (three planes, SPLIT_B_PLANE apart), both
// K-major in 64-column panels of 128-byte rows, 128B-swizzled.  hi·hi
// goes into acc; the products of the flagged small terms (AF: A's mid
// and lo, BF: B's) into acc2 — hi·mid, hi·lo, mid·hi, lo·hi, mid·mid,
// the terms above 2^-24 relative — each accumulator overwritten by its
// first product.  Committed here; the caller waits.
constexpr uint32_t SPLIT_A_PLANE = 128 * PLANE_DP * 2;
constexpr uint32_t SPLIT_B_PLANE = 64 * PLANE_DP * 2;

template <bool AF, bool BF>
__device__ __forceinline__ void split_mma_n64(float (&acc)[32],
                                              float (&acc2)[32],
                                              uint32_t a_hi, uint32_t b_hi) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < PLANE_DP / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint32_t a = a_hi + (kk / 4) * 128 * 128 + off;
    const uint32_t b = b_hi + (kk / 4) * 64 * 128 + off;
    const auto desc = [](uint32_t x) { return smem_desc(x, 16, 1024); };
    int acc2_on = kk > 0;
    wgmma_ss_n64(acc, desc(a), desc(b), kk > 0);
    if constexpr (AF) {
      wgmma_ss_n64(acc2, desc(a + SPLIT_A_PLANE), desc(b), acc2_on);
      wgmma_ss_n64(acc2, desc(a + 2 * SPLIT_A_PLANE), desc(b), 1);
      acc2_on = 1;
    }
    if constexpr (BF) {
      wgmma_ss_n64(acc2, desc(a), desc(b + SPLIT_B_PLANE), acc2_on);
      wgmma_ss_n64(acc2, desc(a), desc(b + 2 * SPLIT_B_PLANE), 1);
    }
    if constexpr (AF && BF)
      wgmma_ss_n64(acc2, desc(a + SPLIT_A_PLANE), desc(b + SPLIT_B_PLANE), 1);
  }
  wgmma_commit();
}

__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// The products of split_mma_n64 summed with rounding to nearest between
// k16 steps.  The tensor cores add each product group to their fp32
// accumulator with truncation, so eight steps into one accumulator
// drift low by up to a few ulp of the dot product.  Here each step goes
// into a fresh accumulator — two in turn, one step in flight while the
// other is added — its flagged small products first and hi·hi last, so
// that the step truncates once against its own partial sum, and the
// steps are summed in fp32 on the CUDA cores, round to nearest.  On
// return every product is complete and sum is readable.  A's block has
// A_ROWS rows, its panels and planes that far apart: 128 as in
// split_mma_n64, or 64 for a block of one warpgroup (B4, B6).  B's
// panels are B_ROWS rows apart: 64, or 128 for a 64-row half of bf16
// B3's 128-row tiles (b_hi at the half's first row; B's mid and lo
// planes, read for BF, are SPLIT_B_PLANE apart).
template <bool AF, bool BF, int A_ROWS = 128, int B_ROWS = 64>
__device__ __forceinline__ void split_mma_n64_rn(float (&sum)[32],
                                                 uint32_t a_hi,
                                                 uint32_t b_hi) {
  constexpr uint32_t A_PLANE = A_ROWS * PLANE_DP * 2;
  float t0[32], t1[32];
  const auto desc = [](uint32_t x) { return smem_desc(x, 16, 1024); };
#pragma unroll
  for (int kk = 0; kk < PLANE_DP / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint32_t a = a_hi + (kk / 4) * A_ROWS * 128 + off;
    const uint32_t b = b_hi + (kk / 4) * B_ROWS * 128 + off;
    float (&t)[32] = kk % 2 ? t1 : t0;
    int on = 0;        // the step's first product overwrites t
    wgmma_fence();     // t of step kk - 2 was read by the adds below
    if constexpr (AF && BF) {
      wgmma_ss_n64(t, desc(a + A_PLANE), desc(b + SPLIT_B_PLANE), on);
      on = 1;
    }
    if constexpr (BF) {
      wgmma_ss_n64(t, desc(a), desc(b + 2 * SPLIT_B_PLANE), on);
      wgmma_ss_n64(t, desc(a), desc(b + SPLIT_B_PLANE), 1);
      on = 1;
    }
    if constexpr (AF) {
      wgmma_ss_n64(t, desc(a + 2 * A_PLANE), desc(b), on);
      wgmma_ss_n64(t, desc(a + A_PLANE), desc(b), 1);
      on = 1;
    }
    wgmma_ss_n64(t, desc(a), desc(b), on);
    wgmma_commit();
    if (kk > 0) {
      wgmma_wait1();                      // step kk - 1 is complete
      float (&p)[32] = kk % 2 ? t0 : t1;
      fence_regs(p);
#pragma unroll
      for (int i = 0; i < 32; ++i) sum[i] = kk == 1 ? p[i] : sum[i] + p[i];
    }
  }
  wgmma_wait0();
  fence_regs(t1);
#pragma unroll
  for (int i = 0; i < 32; ++i) sum[i] += t1[i];
}

// Split x (rows, dim) fp32 into planes (3, rows, PLANE_DP) bf16 and
// ceil(rows / group_rows) flags.  Returns a cudaError_t code.
inline int split_planes(const float* x, int rows, int dim, int group_rows,
                        __nv_bfloat16* planes, int* flags,
                        cudaStream_t stream) {
  if (dim < 1 || dim > PLANE_DP || group_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0)
    split_planes_kernel<<<(rows + group_rows - 1) / group_rows, 256, 0,
                          stream>>>(x, rows, dim, group_rows, planes, flags);
  return static_cast<int>(cudaGetLastError());
}

// A 3-D tensor map of bf16 elements (inner d0, then d1, then d2; byte
// strides s1 and s2 of dims 1 and 2), boxes b0 x b1 x b2 with b0 = 64
// (one 128-byte row), swizzled 128B, zero fill out of bounds.
inline bool encode_3d(CUtensorMap* map, const void* ptr, uint64_t d0,
                      uint64_t d1, uint64_t d2, uint64_t s1, uint64_t s2,
                      uint32_t b1, uint32_t b2) {
  cuuint64_t dims[3] = {d0, d1, d2};
  cuuint64_t strides[2] = {s1, s2};
  cuuint32_t box[3] = {64, b1, b2};
  cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The caller's doc block as a whole number of tile groups of G docs (at
// least one group).
inline int whole_groups(int docs, int G) {
  return (max(docs, 1) + G - 1) / G * G;
}

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

}  // namespace sm90

}  // namespace

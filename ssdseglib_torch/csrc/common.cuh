// Shared pieces of the port's kernels: dtype conversion, the values of a
// 16-byte vector and the asynchronous 16-byte copy (all of them); the
// tensor-core helpers (ldmatrix, mma.sync m16n8k16 bf16 -> f32, padded row
// strides) of fused_mbconv.cu and s2d_stem.cu; the one-launch
// deterministic cross-CTA reduction (`finish`) of pointwise_wgrad.cu,
// fused_chain_backward.cu and depthwise_backward.cu; and Hopper's
// asynchronous machinery (mbarriers, TMA tile copies, wgmma s8) of
// int8_pointwise.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ssdseg {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The elements of a 16-byte vector of T (n of them) as f32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
    f[0] = __uint_as_float(v.x), f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z), f[3] = __uint_as_float(v.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // a bf16 is the upper half of an f32
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
};

// Asynchronous 16-byte copy from device memory to shared memory (sm_80+).
// With `inside` false nothing is read and the 16 bytes are zero-filled (the
// src-size operand is 0), so ragged edges take the same path.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool inside) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(inside ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's committed groups are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Tensor cores: mma.sync m16n8k16 bf16 -> f32 with operands from ldmatrix
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Row stride, in bf16 elements, of a shared tile whose rows hold n (a
// multiple of 8) values: padded so that the stride is an odd number of 16-byte
// units and the eight rows an ldmatrix reads fall in eight different bank
// groups.
__host__ __device__ constexpr int padded_ld(int n) { return (n / 8) % 2 == 0 ? n + 8 : n + 16; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ldmatrix: four (or two) 8 x 8 b16 matrices from shared memory, each lane
// giving the address of one row; .trans hands out the transposes.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a (16 x 16, row-major) * b (16 x 8, "col"), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                          unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Round to bf16, then clamp to [0, 6] (exact in bf16), as a float.
__device__ __forceinline__ float relu6_rounded(float v) {
  return fminf(fmaxf(__bfloat162float(__float2bfloat16_rn(v)), 0.0f), 6.0f);
}

// ---------------------------------------------------------------------------
// One launch for a split-K sum, deterministic
// ---------------------------------------------------------------------------

// The end of a kernel whose `n` CTAs each wrote an M-float partial, the one
// of this CTA (number `index` among them) to partials[index * M ...].  The
// last CTA of each group of `group` consecutive CTAs sums the group's
// partials in CTA order into the slot of the group's first CTA, and the last
// group to finish sums those in group order and hands each total to
// `out(e, total)`.  The order of every sum is fixed by the grid, not by which
// CTA came last, so the result is the same bit pattern on every run.  The
// winners reset their counters (n / group rounded up, plus one) to 0 for the
// next launch on the stream.  `ticket` is a shared int.
template <typename Out>
__device__ __forceinline__ void finish(float* __restrict__ partials, int* __restrict__ counters,
                                       int n, int index, int M, int group, int& ticket,
                                       Out out) {
  const int g = index / group;
  const int g0 = g * group, members = min(group, n - g0);
  const int groups = (n + group - 1) / group;
  __threadfence();  // this CTA's partial is visible before its ticket is taken
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(counters + g, 1);
  __syncthreads();
  if (ticket != members - 1) return;
  __threadfence();
  for (int e = threadIdx.x; e < M; e += blockDim.x) {
    float s = 0.0f;
#pragma unroll 8
    for (int p = 0; p < members; ++p) s += __ldcg(partials + size_t(g0 + p) * M + e);
    __stcg(partials + size_t(g0) * M + e, s);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    counters[g] = 0;
    ticket = atomicAdd(counters + groups, 1);
  }
  __syncthreads();
  if (ticket != groups - 1) return;
  __threadfence();
  for (int e = threadIdx.x; e < M; e += blockDim.x) {
    float s = 0.0f;
#pragma unroll 8
    for (int q = 0; q < groups; ++q) s += __ldcg(partials + size_t(q) * group * M + e);
    out(e, s);
  }
  if (threadIdx.x == 0) counters[groups] = 0;
}

// ceil(sqrt(n)): the group size of `finish` for n CTAs.
inline int finish_group(int n) {
  int g = 1;
  while (g * g < n) ++g;
  return g;
}

// Counters `finish` needs for n CTAs in groups of `group`.
__host__ __device__ inline int finish_counters(int n, int group) { return (n + group - 1) / group + 1; }

// ---------------------------------------------------------------------------
// Hopper (sm_90a): mbarriers, TMA tile copies, warpgroup MMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// One arrival that also expects `bytes` of TMA transactions on the phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// Returns once the phase of parity `parity` has completed.  A wait of more
// than 2^35 clocks (~20 s) traps: a deadlock fails the launch, not the run.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  long long since = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (since == 0) since = clock64();
    else if (clock64() - since > (1ll << 35)) __trap();
  }
}

// A barrier among `count` threads (a multiple of 32) of the CTA, number `id`
// (1..15; 0 is __syncthreads).
__device__ __forceinline__ void named_barrier(unsigned id, unsigned count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy accesses (wgmma operand reads, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TMA: the box at (c0, c1) (innermost first) of the tensor `map` (a
// __grid_constant__ CUtensorMap) into shared memory at `dst`, completing
// its bytes on the mbarrier `bar`; out-of-bounds elements read as zeros.
__device__ __forceinline__ void tma_load_2d(unsigned dst, const void* map, int c0, int c1,
                                            unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(map), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
// TMA: shared memory at `src` to the box at (c0, c1) of `map`; what lies out
// of bounds is not written.  Tracked by bulk groups.
__device__ __forceinline__ void tma_store_2d(const void* map, unsigned src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
                   map),
               "r"(c0), "r"(c1), "r"(src)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's bulk groups still read shared memory.
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Waits until all of this thread's bulk groups are complete.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle
// (rows of 128 bytes, 8-row atoms of 1024 bytes, 1024-byte aligned): start
// address, stride between 8-row atoms 1024 bytes, layout SWIZZLE_128B.  One
// step of 32 bytes along K adds 2 to it.
__device__ __forceinline__ unsigned long long sw128_desc(unsigned addr) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N of the warpgroup's wgmma groups are in flight.
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// setmaxnreg: a warpgroup gives up registers (dec) or takes them (inc); every
// warp of the warpgroup executes it.
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
// Keeps the compiler from moving accesses of an accumulator register across
// the asynchronous wgmma that owns it.
__device__ __forceinline__ void wgmma_pin(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// d (64 x 128 s32, the warpgroup's accumulator fragment) = a (64 x 32 s8)
// * b (128 x 32 s8)^T + (accumulate ? d : 0), both operands K-major in
// shared memory (descriptors above).
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], unsigned long long a,
                                                    unsigned long long b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31,\n"
      "%32, %33, %34, %35, %36, %37, %38, %39,\n"
      "%40, %41, %42, %43, %44, %45, %46, %47,\n"
      "%48, %49, %50, %51, %52, %53, %54, %55,\n"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The least power of two >= n.
inline int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace ssdseg

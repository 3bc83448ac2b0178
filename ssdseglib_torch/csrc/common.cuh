// Shared pieces of the port's kernels: dtype conversion, the values of a
// 16-byte vector and the asynchronous 16-byte copy (all of them); the
// tensor-core helpers (ldmatrix, mma.sync m16n8k16 bf16 -> f32, padded row
// strides) of fused_mbconv.cu and s2d_stem.cu; and the one-launch
// deterministic cross-CTA reduction (`finish`) of pointwise_wgrad.cu,
// fused_chain_backward.cu and depthwise_backward.cu.

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

// The least power of two >= n.
inline int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace ssdseg

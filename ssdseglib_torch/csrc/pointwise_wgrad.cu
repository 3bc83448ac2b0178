// Weight gradient of a 1x1 stride-1 dense convolution for Hopper (sm_90a), and
// the two measuring sticks that go with it:
//
//     wgrad_mma   dW[o,i] = sum_k dy[k,o] * x[k,i]   on the tensor cores (bf16)
//     wgrad_fma   the same dW by FMAs on the CUDA cores (bf16 or f32 operands,
//                 cast to f32 in registers)
//     wgrad_copy  out[o,i] = sum_k x[k,i] + sum_k dy[k,o]: the same loads and
//                 no product, i.e. what the memory system alone costs
//
// Replaces the three Pallas TPU kernels of tests/tpu_scripts/
// mosaic_reshape_probe.py (`kernel`, `vpu_kernel`, `copy_kernel`).  x is
// (K, Ci) and dy is (K, Co), row-major and contiguous, K = B*H*W the flattened
// batch and spatial axes of NHWC tensors; the result is (Co, Ci) -- the layout
// of a (Co, Ci, 1, 1) conv weight -- in f32 or bf16.
//
// What bounds them on the H100: bytes.  K is ~1.2 M and Ci, Co are tens, so
// each operand element is read once and used for Ci or Co products: 2*K*Ci*Co
// operations against 2*K*(Ci+Co) bytes in bf16 is Ci*Co/(Ci+Co) ~ 10-14
// operations a byte, far under the ~295 where the tensor cores would limit.
// So the design is about keeping enough bytes in flight.
//
// Design.  The TPU kernels add into one (Ci, Co) output block that stays
// resident while a sequential grid walks K.  CUDA blocks carry nothing from
// one to the next, so all three are split-K reductions: a CTA owns a contiguous
// range of rows of K, reduces it to a (Co, Ci) f32 partial and writes it to a
// (CTAs, Co, Ci) scratch buffer.  The sum over the partials happens in the same
// launch (`finish` below): each CTA takes a ticket from a device counter after
// writing its partial; the last CTA of a group of consecutive CTAs adds the
// group's partials in CTA order, and the last group to finish adds the group
// sums in group order and writes dW in the output dtype.  The order of every
// sum is fixed by the grid, not by which CTA came last, so the result is the
// same bit pattern on every run; the winners reset the counters for the next
// launch on the stream.  Every operand element is loaded exactly once, 16
// bytes a thread; rows past K are staged as zeros, so a ragged K needs no
// second code path.
//
// x stored (K, Ci) row-major IS the column-major Ci x K operand of x^T dy, and
// dy is the row-major K x Co operand, so the tensor-core kernel stages no
// transpose.  Each warp owns two shared-memory slabs of ROWS rows of x and dy:
// while wmma 16x16x16 bf16 -> f32 runs on one slab, `cp.async` (16 bytes a
// lane, zero-filled past K) fills the other with the warp's next rows.  Its
// TI x TO accumulator tiles live in registers for its whole share of K.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace ssdseg;
using namespace nvcuda;

constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;          // wmma tile edge; channels come in multiples
constexpr int kChunkRows = 64;     // rows of K a CTA stages per step (fma); split granularity
constexpr int kPad = 8;            // bf16 elements of padding per staged row (mma)
constexpr int kFmaCtas = 528;      // grid of the fma and copy kernels (4 per SM)

// The tensor-core kernel's rows a warp stages per slab and its grid: an A/B
// of the kernel alone on the H100 over 16 / 32 rows and 132-528 CTAs picked
// the same for both layers of the envelope (PERF.md, `chip_smoke.py
// --wgrad-variants`).
constexpr int kMmaRows = 16;
constexpr int kMmaCtas = 132;  // one per SM

// Rows of K per CTA (a multiple of the staging granularity) and the grid size.
struct Split {
  int rows_per_cta;
  int ctas;
  int group;  // CTAs per group of the in-launch reduction
};

inline Split make_split(long long K, int max_ctas) {
  long long rows = (K + max_ctas - 1) / max_ctas;
  rows = (rows + kChunkRows - 1) / kChunkRows * kChunkRows;
  Split s;
  s.rows_per_cta = int(rows);
  s.ctas = int((K + rows - 1) / rows);
  s.group = 1;
  while (s.group * s.group < s.ctas) ++s.group;  // ceil(sqrt(ctas))
  return s;
}

// Counters the in-launch reduction uses: one per group and one for the groups.
inline int counters_needed(const Split& s) { return (s.ctas + s.group - 1) / s.group + 1; }

// 16 bytes of `a` starting at element `idx`, or zeros when `inside` is false.
template <typename T>
__device__ __forceinline__ uint4 load16(const T* __restrict__ a, size_t idx, bool inside) {
  return inside ? *reinterpret_cast<const uint4*>(a + idx) : make_uint4(0u, 0u, 0u, 0u);
}

template <typename T> struct Vec;  // elements in 16 bytes, and their f32 values
template <> struct Vec<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
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

// Four consecutive elements of shared memory as f32.
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}

// Copies rows [r, r + rows) of the (K, C) array `a` into shared memory with a
// row stride of `ld` elements, zeros for rows at or past `K`, by the `n`
// threads whose index among them is `t`.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ a, T* s, long long r, int rows,
                                           long long K, int C, int ld, int t, int n) {
  constexpr int V = Vec<T>::n;
  const int vpr = C / V;  // 16-byte vectors per row
  for (int v = t; v < rows * vpr; v += n) {
    const int row = v / vpr, cv = v - row * vpr;
    *reinterpret_cast<uint4*>(s + row * ld + cv * V) =
        load16(a, size_t(r + row) * C + cv * V, r + row < K);
  }
}

// The end of every kernel below.  Each CTA has written its (Co, Ci) partial to
// partials[blockIdx.x]; the last CTA of each group of `group` consecutive CTAs
// sums the group's partials in CTA order into the slot of the group's first
// CTA, and the last group to finish sums those in group order into `out`
// ((Co, Ci), f32 when out_bf16 is 0, else bf16).  The winners reset their
// counters to 0.  `ticket` is a shared int.
__device__ __forceinline__ void finish(float* __restrict__ partials, int* __restrict__ counters,
                                       void* __restrict__ out, int out_bf16, int M, int group,
                                       int& ticket) {
  const int n = gridDim.x, g = blockIdx.x / group;
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
    for (int q = 0; q < groups; ++q) s += __ldcg(partials + size_t(q) * group * M + e);
    if (out_bf16)
      static_cast<__nv_bfloat16*>(out)[e] = __float2bfloat16_rn(s);
    else
      static_cast<float*>(out)[e] = s;
  }
  if (threadIdx.x == 0) counters[groups] = 0;
}

// ---------------------------------------------------------------------------
// wgrad_mma: tensor cores, bf16 operands, f32 accumulation
// ---------------------------------------------------------------------------

// Starts the copy of rows [r, r + ROWS) of x and dy into a warp's slab, by
// its 32 lanes, zeros past K.
template <int Ci, int Co, int ROWS>
__device__ __forceinline__ void stage_slab_async(const __nv_bfloat16* __restrict__ x,
                                                 const __nv_bfloat16* __restrict__ dy,
                                                 __nv_bfloat16* xs, long long r, long long K,
                                                 int lane) {
  constexpr int ldx = Ci + kPad, ldy = Co + kPad;
  static_assert(ROWS * (Ci / 8) % 32 == 0 && ROWS * (Co / 8) % 32 == 0, "whole lanes");
  __nv_bfloat16* ys = xs + ROWS * ldx;
#pragma unroll
  for (int j = 0; j < ROWS * (Ci / 8) / 32; ++j) {
    const int v = lane + 32 * j;
    const int row = v / (Ci / 8), cv = v % (Ci / 8);
    const bool inside = r + row < K;
    cp_async16(xs + row * ldx + cv * 8, inside ? x + size_t(r + row) * Ci + cv * 8 : x, inside);
  }
#pragma unroll
  for (int j = 0; j < ROWS * (Co / 8) / 32; ++j) {
    const int v = lane + 32 * j;
    const int row = v / (Co / 8), cv = v % (Co / 8);
    const bool inside = r + row < K;
    cp_async16(ys + row * ldy + cv * 8, inside ? dy + size_t(r + row) * Co + cv * 8 : dy,
               inside);
  }
}

template <int TI, int TO, int ROWS>
__global__ void __launch_bounds__(kThreads)
wgrad_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                 float* __restrict__ partials, int* __restrict__ counters, void* __restrict__ out,
                 int out_bf16, long long K, int rows_per_cta, int group) {
  constexpr int Ci = TI * kTile, Co = TO * kTile;
  constexpr int ldx = Ci + kPad, ldy = Co + kPad;
  constexpr int slab = ROWS * (ldx + ldy);  // bf16 elements per slab; a warp has two
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int ticket;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __nv_bfloat16* slabs = reinterpret_cast<__nv_bfloat16*>(smem) + warp * 2 * slab;

  wmma::fragment<wmma::accumulator, kTile, kTile, kTile, float> acc[TI][TO];
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int o = 0; o < TO; ++o) wmma::fill_fragment(acc[i][o], 0.0f);

  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  long long r1 = r0 + rows_per_cta;
  if (r1 > K) r1 = K;
  // the warps of a CTA interleave ROWS-row steps of its range; a step never
  // crosses into the next CTA's range (rows_per_cta is a multiple of ROWS)
  constexpr long long step = (long long)kWarps * ROWS;
  long long r = r0 + warp * ROWS;
  if (r < r1) stage_slab_async<Ci, Co, ROWS>(x, dy, slabs, r, K, lane);
  cp_async_commit();
  for (int s = 0; r < r1; ++s, r += step) {
    // the next slab's copy is in flight while this one is multiplied
    if (r + step < r1)
      stage_slab_async<Ci, Co, ROWS>(x, dy, slabs + ((s + 1) & 1) * slab, r + step, K, lane);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    const __nv_bfloat16* xs = slabs + (s & 1) * slab;
    const __nv_bfloat16* ys = xs + ROWS * ldx;
    // A = x^T: element (i, k) sits at xs[k * ldx + i], i.e. column-major
#pragma unroll
    for (int k0 = 0; k0 < ROWS; k0 += kTile) {
      wmma::fragment<wmma::matrix_a, kTile, kTile, kTile, __nv_bfloat16, wmma::col_major> a[TI];
#pragma unroll
      for (int i = 0; i < TI; ++i) wmma::load_matrix_sync(a[i], xs + k0 * ldx + i * kTile, ldx);
#pragma unroll
      for (int o = 0; o < TO; ++o) {
        wmma::fragment<wmma::matrix_b, kTile, kTile, kTile, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, ys + k0 * ldy + o * kTile, ldy);
#pragma unroll
        for (int i = 0; i < TI; ++i) wmma::mma_sync(acc[i][o], a[i], b, acc[i][o]);
      }
    }
    __syncwarp();  // the slab is read: the copy two steps on may overwrite it
  }
  cp_async_wait<0>();

  // the warps add their tiles into one (Ci, Co) f32 block, one warp after the
  // other, so the order of the sum is fixed
  __syncthreads();
  float* blk = reinterpret_cast<float*>(smem);
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int o = 0; o < TO; ++o) {
          float* tile = blk + i * kTile * Co + o * kTile;
          if (w > 0) {
            wmma::fragment<wmma::accumulator, kTile, kTile, kTile, float> prev;
            wmma::load_matrix_sync(prev, tile, Co, wmma::mem_row_major);
#pragma unroll
            for (int e = 0; e < prev.num_elements; ++e) acc[i][o].x[e] += prev.x[e];
          }
          wmma::store_matrix_sync(tile, acc[i][o], Co, wmma::mem_row_major);
        }
    }
    __syncthreads();
  }
  float* mine = partials + size_t(blockIdx.x) * Ci * Co;
  for (int e = threadIdx.x; e < Ci * Co; e += kThreads) {
    const int o = e / Ci, i = e - o * Ci;
    mine[e] = blk[i * Co + o];
  }
  finish(partials, counters, out, out_bf16, Ci * Co, group, ticket);
}

template <int TI, int TO, int ROWS>
cudaError_t launch_mma(const void* x, const void* dy, float* partials, int* counters, void* out,
                       int out_bf16, long long K, const Split& s, cudaStream_t stream) {
  constexpr int Ci = TI * kTile, Co = TO * kTile;
  const size_t stage =
      size_t(kWarps) * 2 * ROWS * (Ci + Co + 2 * kPad) * sizeof(__nv_bfloat16);
  const size_t block = size_t(Ci) * Co * sizeof(float);
  const size_t smem = stage > block ? stage : block;
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_mma_kernel<TI, TO, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  wgrad_mma_kernel<TI, TO, ROWS><<<s.ctas, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy), partials,
      counters, out, out_bf16, K, s.rows_per_cta, s.group);
  return cudaGetLastError();
}

template <int TI, int TO>
cudaError_t launch_mma_rows(int rows, const void* x, const void* dy, float* partials,
                            int* counters, void* out, int out_bf16, long long K, const Split& s,
                            cudaStream_t stream) {
  if (rows == 16)
    return launch_mma<TI, TO, 16>(x, dy, partials, counters, out, out_bf16, K, s, stream);
  if (rows == 32)
    return launch_mma<TI, TO, 32>(x, dy, partials, counters, out, out_bf16, K, s, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// wgrad_fma: CUDA cores, operands cast to f32 in registers
// ---------------------------------------------------------------------------

// A thread owns a 4 x 4 block of dW; the (Ci/4) * (Co/4) blocks of one copy of
// dW make a group, and the CTA's groups take the rows of a staged chunk in
// turn.  Per row a thread reads 4 + 4 operands and does 16 FMAs.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wgrad_fma_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ partials,
                 int* __restrict__ counters, void* __restrict__ out, int out_bf16, long long K,
                 int rows_per_cta, int group, int Ci, int Co) {
  extern __shared__ __align__(32) unsigned char smem[];
  __shared__ int ticket;
  T* xs = reinterpret_cast<T*>(smem);   // (kChunkRows, Ci)
  T* ys = xs + kChunkRows * Ci;         // (kChunkRows, Co)
  const int tid = threadIdx.x;
  const int blocks_o = Co / 4, blocks = (Ci / 4) * blocks_o;
  const int groups = kThreads / blocks;
  const int grp = tid / blocks, blk = tid - grp * blocks;
  const int i0 = (blk / blocks_o) * 4, o0 = (blk % blocks_o) * 4;
  const bool active = grp < groups;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 0; o < 4; ++o) acc[i][o] = 0.0f;

  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  long long r1 = r0 + rows_per_cta;
  if (r1 > K) r1 = K;
  for (long long r = r0; r < r1; r += kChunkRows) {
    stage_rows(x, xs, r, kChunkRows, K, Ci, Ci, tid, kThreads);
    stage_rows(dy, ys, r, kChunkRows, K, Co, Co, tid, kThreads);
    __syncthreads();
    if (active) {
      for (int row = grp; row < kChunkRows; row += groups) {
        float xv[4], gv[4];
        load4(xs + row * Ci + i0, xv);
        load4(ys + row * Co + o0, gv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int o = 0; o < 4; ++o) acc[i][o] = fmaf(xv[i], gv[o], acc[i][o]);
      }
    }
    __syncthreads();
  }

  // the groups' copies of dW, summed in group order
  float* red = reinterpret_cast<float*>(smem);  // (groups, Ci, Co)
  if (active) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int o = 0; o < 4; ++o) red[(grp * Ci + i0 + i) * Co + o0 + o] = acc[i][o];
  }
  __syncthreads();
  float* mine = partials + size_t(blockIdx.x) * Ci * Co;
  for (int e = tid; e < Ci * Co; e += kThreads) {
    const int o = e / Ci, i = e - o * Ci;
    float s = 0.0f;
    for (int g = 0; g < groups; ++g) s += red[(g * Ci + i) * Co + o];
    mine[e] = s;
  }
  finish(partials, counters, out, out_bf16, Ci * Co, group, ticket);
}

template <typename T>
cudaError_t launch_fma(const void* x, const void* dy, float* partials, int* counters, void* out,
                       int out_bf16, long long K, int Ci, int Co, const Split& s,
                       cudaStream_t stream) {
  const int groups = kThreads / ((Ci / 4) * (Co / 4));
  const size_t stage = size_t(kChunkRows) * (Ci + Co) * sizeof(T);
  const size_t red = size_t(groups) * Ci * Co * sizeof(float);
  wgrad_fma_kernel<T><<<s.ctas, kThreads, stage > red ? stage : red, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), partials, counters, out, out_bf16, K,
      s.rows_per_cta, s.group, Ci, Co);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// wgrad_copy: the loads alone
// ---------------------------------------------------------------------------

// Column sums of rows [r0, r1) of the (K, C) array `a` into sums[0..C).  A
// thread keeps one 16-byte column group for the whole range, so its partial
// sums stay in registers; `red` is kThreads * 8 floats of shared memory.
template <typename T>
__device__ __forceinline__ void column_sums(const T* __restrict__ a, int C, long long r0,
                                            long long r1, float* red, float* sums) {
  constexpr int V = Vec<T>::n;
  const int tid = threadIdx.x;
  const int vpr = C / V;
  const int rows_step = kThreads / vpr, lanes = rows_step * vpr;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
  if (tid < lanes) {
    const int cv = tid % vpr;
#pragma unroll 4
    for (long long r = r0 + tid / vpr; r < r1; r += rows_step) {
      float f[V];
      Vec<T>::unpack(load16(a, size_t(r) * C + cv * V, true), f);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] += f[j];
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) red[tid * V + j] = acc[j];
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {
    const int cv = c / V, j = c - cv * V;
    float s = 0.0f;
    for (int t = cv; t < lanes; t += vpr) s += red[t * V + j];
    sums[c] = s;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wgrad_copy_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ partials,
                  int* __restrict__ counters, void* __restrict__ out, int out_bf16, long long K,
                  int rows_per_cta, int group, int Ci, int Co) {
  __shared__ float red[kThreads * 8];
  __shared__ float sx[256], sy[256];
  __shared__ int ticket;
  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  long long r1 = r0 + rows_per_cta;
  if (r1 > K) r1 = K;
  column_sums(x, Ci, r0, r1, red, sx);
  column_sums(dy, Co, r0, r1, red, sy);
  float* mine = partials + size_t(blockIdx.x) * Ci * Co;
  for (int e = threadIdx.x; e < Ci * Co; e += kThreads) mine[e] = sy[e / Ci] + sx[e % Ci];
  finish(partials, counters, out, out_bf16, Ci * Co, group, ticket);
}

template <typename T>
cudaError_t launch_copy(const void* x, const void* dy, float* partials, int* counters, void* out,
                        int out_bf16, long long K, int Ci, int Co, const Split& s,
                        cudaStream_t stream) {
  wgrad_copy_kernel<T><<<s.ctas, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), partials, counters, out, out_bf16, K,
      s.rows_per_cta, s.group, Ci, Co);
  return cudaGetLastError();
}

// The channel envelope of the three kernels: multiples of the wmma tile edge,
// at most 8 accumulator tiles a warp (ops/pointwise_wgrad.py states the same
// to its callers as `channels_applicable`).
inline bool channels_ok(int Ci, int Co) {
  return Ci >= kTile && Co >= kTile && Ci % kTile == 0 && Co % kTile == 0 && Ci <= 64 &&
         Co <= 96 && (Ci / kTile) * (Co / kTile) <= 8;
}

// The split of a launch: `ctas` when positive, else kMmaCtas for the
// tensor-core kernel and kFmaCtas for the other two.
inline Split split_for(int kernel, long long K, int ctas) {
  if (ctas <= 0) ctas = kernel == 0 ? kMmaCtas : kFmaCtas;
  return make_split(K, ctas);
}

}  // namespace

// The grid a launch below uses for K rows, given `ctas` (0: the built-in
// choice): *ctas_out, the first extent of the (CTAs, Co, Ci) f32 scratch, and
// *counters_out, the int32 counters it needs, zero before the first launch
// (each launch leaves them zero).  Returns a cudaError_t (0 on success).
extern "C" int pointwise_wgrad_grid(int kernel, long long K, int Ci, int Co, int ctas,
                                    int* ctas_out, int* counters_out) {
  if (K < 1 || !channels_ok(Ci, Co)) return cudaErrorInvalidValue;
  const Split s = split_for(kernel, K, ctas);
  *ctas_out = s.ctas;
  *counters_out = counters_needed(s);
  return cudaSuccess;
}

// kernel: 0 = mma (bf16 only), 1 = fma, 2 = copy.  dtype: 0 = float32, 1 =
// bfloat16.  x (K, Ci), dy (K, Co) contiguous, 16-byte aligned; partials and
// counters as pointwise_wgrad_grid sizes them for the same (kernel, K, Ci,
// Co, ctas); out (Co, Ci) in f32 (out_bf16 = 0) or bf16 (1).  rows (mma only)
// and ctas: 0 for the built-in choice.  One launch.  Returns a cudaError_t (0
// on success).
extern "C" int pointwise_wgrad_launch(int kernel, int dtype, const void* x, const void* dy,
                                      void* partials, void* counters, void* out, int out_bf16,
                                      long long K, int Ci, int Co, int rows, int ctas,
                                      void* stream) {
  if (K < 1 || !channels_ok(Ci, Co) || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto pf = static_cast<float*>(partials);
  auto ct = static_cast<int*>(counters);
  const Split s = split_for(kernel, K, ctas);
  if (kernel == 1)
    return dtype == 0 ? launch_fma<float>(x, dy, pf, ct, out, out_bf16, K, Ci, Co, s, st)
                      : launch_fma<__nv_bfloat16>(x, dy, pf, ct, out, out_bf16, K, Ci, Co, s, st);
  if (kernel == 2)
    return dtype == 0 ? launch_copy<float>(x, dy, pf, ct, out, out_bf16, K, Ci, Co, s, st)
                      : launch_copy<__nv_bfloat16>(x, dy, pf, ct, out, out_bf16, K, Ci, Co, s, st);
  if (kernel != 0 || dtype != 1) return cudaErrorInvalidValue;
  if (rows <= 0) rows = kMmaRows;
#define SSDSEG_MMA_CASE(TI, TO)                                                          \
  if (Ci == TI * kTile && Co == TO * kTile)                                              \
    return launch_mma_rows<TI, TO>(rows, x, dy, pf, ct, out, out_bf16, K, s, st);
  SSDSEG_MMA_CASE(1, 1) SSDSEG_MMA_CASE(1, 2) SSDSEG_MMA_CASE(1, 3) SSDSEG_MMA_CASE(1, 4)
  SSDSEG_MMA_CASE(1, 5) SSDSEG_MMA_CASE(1, 6) SSDSEG_MMA_CASE(2, 1) SSDSEG_MMA_CASE(2, 2)
  SSDSEG_MMA_CASE(2, 3) SSDSEG_MMA_CASE(2, 4) SSDSEG_MMA_CASE(3, 1) SSDSEG_MMA_CASE(3, 2)
  SSDSEG_MMA_CASE(4, 1) SSDSEG_MMA_CASE(4, 2)
#undef SSDSEG_MMA_CASE
  return cudaErrorInvalidValue;
}

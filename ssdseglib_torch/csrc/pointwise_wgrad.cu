// Weight gradient of a 1x1 stride-1 dense convolution for Hopper (sm_90a), and
// the two measuring sticks that go with it:
//
//     wgrad_mma   dW[i,o] = sum_k x[k,i] * dy[k,o]   on the tensor cores (bf16)
//     wgrad_fma   the same dW by FMAs on the CUDA cores (bf16 or f32 operands,
//                 cast to f32 in registers)
//     wgrad_copy  out[i,o] = sum_k x[k,i] + sum_k dy[k,o]: the same loads and
//                 no product, i.e. what the memory system alone costs
//
// Replaces the three Pallas TPU kernels of tests/tpu_scripts/
// mosaic_reshape_probe.py (`kernel`, `vpu_kernel`, `copy_kernel`).  x is
// (K, Ci) and dy is (K, Co), row-major and contiguous, K = B*H*W the flattened
// batch and spatial axes of NHWC tensors; the result is (Ci, Co) f32.
//
// What bounds them on the H100: bytes.  K is ~1.2 M and Ci, Co are tens, so
// each operand element is read once and used for Ci or Co products: 2*K*Ci*Co
// operations against 2*K*(Ci+Co) bytes in bf16 is Ci*Co/(Ci+Co) ~ 10-14
// operations a byte, far under the ~295 where the tensor cores would limit.
//
// Design.  The TPU kernels add into one (Ci, Co) output block that stays
// resident while a sequential grid walks K.  CUDA blocks carry nothing from
// one to the next, so all three are split-K reductions: a CTA owns a contiguous
// range of rows of K, reduces it to a (Ci, Co) f32 partial, writes it to a
// (CTAs, Ci, Co) buffer, and `reduce_partials` (common.cuh) sums the partials
// in a fixed order.  No atomics: the result is the same bit pattern every run.
// Every operand element is loaded exactly once, 16 bytes a thread, neighbouring
// threads on neighbouring addresses; rows past K are staged as zeros, so a
// ragged K needs no second code path.
//
// x stored (K, Ci) row-major IS the column-major Ci x K operand of dW = x^T dy,
// and dy is the row-major K x Co operand, so the tensor-core kernel stages no
// transpose: a warp copies 16 rows of x and dy to its own shared-memory slab
// and runs wmma 16x16x16 bf16 -> f32 on them, its TI x TO accumulator tiles
// living in registers for its whole share of K.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace ssdseg;
using namespace nvcuda;

constexpr int kWarps = kThreads / 32;
constexpr int kMaxCtas = 528;      // 4 per SM of an H100
constexpr int kTile = 16;          // wmma tile edge; channels come in multiples
constexpr int kWarpRows = 16;      // rows of K a warp stages per step (mma), a multiple of kTile
constexpr int kChunkRows = 64;     // rows of K a CTA stages per step (fma)
constexpr int kPad = 8;            // bf16 elements of padding per staged row (mma)

// Rows of K per CTA (a multiple of the staging granularity) and the grid size.
struct Split {
  int rows_per_cta;
  int ctas;
};

inline Split make_split(long long K) {
  long long rows = (K + kMaxCtas - 1) / kMaxCtas;
  rows = (rows + kChunkRows - 1) / kChunkRows * kChunkRows;
  Split s;
  s.rows_per_cta = int(rows);
  s.ctas = int((K + rows - 1) / rows);
  return s;
}

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

// ---------------------------------------------------------------------------
// wgrad_mma: tensor cores, bf16 operands, f32 accumulation
// ---------------------------------------------------------------------------

template <int TI, int TO>
__global__ void __launch_bounds__(kThreads)
wgrad_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                 float* __restrict__ partials, long long K, int rows_per_cta) {
  constexpr int Ci = TI * kTile, Co = TO * kTile;
  constexpr int ldx = Ci + kPad, ldy = Co + kPad;
  constexpr int slab = kWarpRows * (ldx + ldy);  // bf16 elements per warp
  extern __shared__ __align__(32) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem) + warp * slab;
  __nv_bfloat16* ys = xs + kWarpRows * ldx;

  wmma::fragment<wmma::accumulator, kTile, kTile, kTile, float> acc[TI][TO];
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int o = 0; o < TO; ++o) wmma::fill_fragment(acc[i][o], 0.0f);

  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  long long r1 = r0 + rows_per_cta;
  if (r1 > K) r1 = K;
  // the warps of a CTA interleave kWarpRows-row steps of its range
  for (long long r = r0 + warp * kWarpRows; r < r1; r += kWarps * kWarpRows) {
    stage_rows(x, xs, r, kWarpRows, K, Ci, ldx, lane, 32);
    stage_rows(dy, ys, r, kWarpRows, K, Co, ldy, lane, 32);
    __syncwarp();
    // A = x^T: element (i, k) sits at xs[k * ldx + i], i.e. column-major
#pragma unroll
    for (int k0 = 0; k0 < kWarpRows; k0 += kTile) {
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
    __syncwarp();  // the slab is read: the next step may overwrite it
  }

  // the warps add their tiles into one (Ci, Co) f32 block, one warp after the
  // other, so the order of the sum is fixed
  __syncthreads();
  float* out = reinterpret_cast<float*>(smem);
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int o = 0; o < TO; ++o) {
          float* tile = out + i * kTile * Co + o * kTile;
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
  for (int e = threadIdx.x; e < Ci * Co; e += kThreads) mine[e] = out[e];
}

template <int TI, int TO>
cudaError_t launch_mma(const void* x, const void* dy, float* partials, float* dw, long long K,
                       cudaStream_t stream) {
  constexpr int Ci = TI * kTile, Co = TO * kTile;
  const Split s = make_split(K);
  const size_t stage = size_t(kWarps) * kWarpRows * (Ci + Co + 2 * kPad) * sizeof(__nv_bfloat16);
  const size_t block = size_t(Ci) * Co * sizeof(float);
  const size_t smem = stage > block ? stage : block;
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_mma_kernel<TI, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  wgrad_mma_kernel<TI, TO><<<s.ctas, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy), partials, K,
      s.rows_per_cta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(partials, dw, s.ctas, Ci * Co, stream);
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
                 long long K, int rows_per_cta, int Ci, int Co) {
  extern __shared__ __align__(32) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);   // (kChunkRows, Ci)
  T* ys = xs + kChunkRows * Ci;         // (kChunkRows, Co)
  const int tid = threadIdx.x;
  const int blocks_o = Co / 4, blocks = (Ci / 4) * blocks_o;
  const int groups = kThreads / blocks;
  const int group = tid / blocks, blk = tid - group * blocks;
  const int i0 = (blk / blocks_o) * 4, o0 = (blk % blocks_o) * 4;
  const bool active = group < groups;

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
      for (int row = group; row < kChunkRows; row += groups) {
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
      for (int o = 0; o < 4; ++o) red[(group * Ci + i0 + i) * Co + o0 + o] = acc[i][o];
  }
  __syncthreads();
  float* mine = partials + size_t(blockIdx.x) * Ci * Co;
  for (int e = tid; e < Ci * Co; e += kThreads) {
    float s = 0.0f;
    for (int g = 0; g < groups; ++g) s += red[g * Ci * Co + e];
    mine[e] = s;
  }
}

template <typename T>
cudaError_t launch_fma(const void* x, const void* dy, float* partials, float* dw, long long K,
                       int Ci, int Co, cudaStream_t stream) {
  const Split s = make_split(K);
  const int groups = kThreads / ((Ci / 4) * (Co / 4));
  const size_t stage = size_t(kChunkRows) * (Ci + Co) * sizeof(T);
  const size_t red = size_t(groups) * Ci * Co * sizeof(float);
  wgrad_fma_kernel<T><<<s.ctas, kThreads, stage > red ? stage : red, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), partials, K, s.rows_per_cta, Ci, Co);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(partials, dw, s.ctas, Ci * Co, stream);
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
                  long long K, int rows_per_cta, int Ci, int Co) {
  __shared__ float red[kThreads * 8];
  __shared__ float sx[256], sy[256];
  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  long long r1 = r0 + rows_per_cta;
  if (r1 > K) r1 = K;
  column_sums(x, Ci, r0, r1, red, sx);
  column_sums(dy, Co, r0, r1, red, sy);
  float* mine = partials + size_t(blockIdx.x) * Ci * Co;
  for (int e = threadIdx.x; e < Ci * Co; e += kThreads) mine[e] = sx[e / Co] + sy[e % Co];
}

template <typename T>
cudaError_t launch_copy(const void* x, const void* dy, float* partials, float* dw, long long K,
                        int Ci, int Co, cudaStream_t stream) {
  const Split s = make_split(K);
  wgrad_copy_kernel<T><<<s.ctas, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), partials, K, s.rows_per_cta, Ci, Co);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(partials, dw, s.ctas, Ci * Co, stream);
}

// The channel envelope of the three kernels: multiples of the wmma tile edge,
// at most 8 accumulator tiles a warp (ops/pointwise_wgrad.py states the same
// to its callers as `channels_applicable`).
inline bool channels_ok(int Ci, int Co) {
  return Ci >= kTile && Co >= kTile && Ci % kTile == 0 && Co % kTile == 0 && Ci <= 64 &&
         Co <= 96 && (Ci / kTile) * (Co / kTile) <= 8;
}

}  // namespace

// CTAs a launch below uses for K rows: the first extent of the (CTAs, Ci, Co)
// f32 scratch buffer it needs.
extern "C" int pointwise_wgrad_ctas(long long K) { return K < 1 ? 0 : make_split(K).ctas; }

// kernel: 0 = mma (bf16 only), 1 = fma, 2 = copy.  dtype: 0 = float32, 1 =
// bfloat16.  x (K, Ci), dy (K, Co) contiguous, 16-byte aligned; partials
// (pointwise_wgrad_ctas(K), Ci, Co) f32 scratch; dw (Ci, Co) f32.  Returns a
// cudaError_t (0 on success).
extern "C" int pointwise_wgrad_launch(int kernel, int dtype, const void* x, const void* dy,
                                      void* partials, void* dw, long long K, int Ci, int Co,
                                      void* stream) {
  if (K < 1 || !channels_ok(Ci, Co) || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto pf = static_cast<float*>(partials);
  auto df = static_cast<float*>(dw);
  if (kernel == 1)
    return dtype == 0 ? launch_fma<float>(x, dy, pf, df, K, Ci, Co, s)
                      : launch_fma<__nv_bfloat16>(x, dy, pf, df, K, Ci, Co, s);
  if (kernel == 2)
    return dtype == 0 ? launch_copy<float>(x, dy, pf, df, K, Ci, Co, s)
                      : launch_copy<__nv_bfloat16>(x, dy, pf, df, K, Ci, Co, s);
  if (kernel != 0 || dtype != 1) return cudaErrorInvalidValue;
#define SSDSEG_MMA_CASE(TI, TO) \
  if (Ci == TI * kTile && Co == TO * kTile) return launch_mma<TI, TO>(x, dy, pf, df, K, s);
  SSDSEG_MMA_CASE(1, 1) SSDSEG_MMA_CASE(1, 2) SSDSEG_MMA_CASE(1, 3) SSDSEG_MMA_CASE(1, 4)
  SSDSEG_MMA_CASE(1, 5) SSDSEG_MMA_CASE(1, 6) SSDSEG_MMA_CASE(2, 1) SSDSEG_MMA_CASE(2, 2)
  SSDSEG_MMA_CASE(2, 3) SSDSEG_MMA_CASE(2, 4) SSDSEG_MMA_CASE(3, 1) SSDSEG_MMA_CASE(3, 2)
  SSDSEG_MMA_CASE(4, 1) SSDSEG_MMA_CASE(4, 2)
#undef SSDSEG_MMA_CASE
  return cudaErrorInvalidValue;
}

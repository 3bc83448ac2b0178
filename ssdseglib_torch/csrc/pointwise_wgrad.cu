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
// launch (`finish`, common.cuh): each CTA takes a ticket from a device counter after
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
//
// The CUDA-core kernel is the f32 route of the training step: at f32 batch 16
// its bound is bytes (32 -> 16: 1.23 M rows x 48 x 4 bytes, 0.070 ms; 16 -> 96:
// x 112 x 4, 0.165 ms) against 2 K Ci Co FMA operations at the 67 TFLOP/s f32
// rate (0.019 and 0.056 ms).  Its grid is kFmaCtasPerSm CTAs an SM; each CTA
// walks its range in chunks of R rows (128 at 32 -> 16, 64 at 16 -> 96: about
// the same bytes a chunk) through a ring of S shared-memory slots that
// 16-byte cp.async copies fill S - 1 chunks ahead, so the loads overlap
// the FMAs with one barrier a chunk.  A thread owns a BI x BO register block
// of dW (4 x 4 at 32 -> 16, 8 x 6 at 16 -> 96: 32 blocks, so a warp holds one
// copy of dW and every thread is busy; BI + BO shared loads for BI * BO
// FMAs); the CTA's copies of dW are summed in group order.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace ssdseg;
using namespace nvcuda;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;          // wmma tile edge; channels come in multiples
constexpr int kChunkRows = 64;     // split granularity of the mma and copy kernels
constexpr int kPad = 8;            // bf16 elements of padding per staged row (mma)
constexpr int kCopyCtas = 528;     // grid of the copy kernel (4 per SM)

// The CUDA-core kernel's chunks (rows of K: the most, up to kFmaMaxRows, whose
// x and dy hold at most kFmaChunkElems values), chunks in its ring and CTAs an
// SM: an A/B of the kernel alone on the H100 at f32 batch 16 and 2 (PERF.md,
// `chip_smoke.py --wgrad-variants`: 128 rows at 32 -> 16, 64 at 16 -> 96).
constexpr int kFmaChunkElems = 8192;
constexpr int kFmaMaxRows = 128;
constexpr int kFmaStages = 3;
constexpr int kFmaCtasPerSm = 2;

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

// Rows a CTA are a multiple of `granularity`.
inline Split make_split(long long K, int max_ctas, int granularity) {
  long long rows = (K + max_ctas - 1) / max_ctas;
  rows = (rows + granularity - 1) / granularity * granularity;
  Split s;
  s.rows_per_cta = int(rows);
  s.ctas = int((K + rows - 1) / rows);
  s.group = finish_group(s.ctas);
  return s;
}

// Counters the in-launch reduction uses: one per group and one for the groups.
inline int counters_needed(const Split& s) { return finish_counters(s.ctas, s.group); }

// 16 bytes of `a` starting at element `idx`, or zeros when `inside` is false.
template <typename T>
__device__ __forceinline__ uint4 load16(const T* __restrict__ a, size_t idx, bool inside) {
  return inside ? *reinterpret_cast<const uint4*>(a + idx) : make_uint4(0u, 0u, 0u, 0u);
}

// The end of every kernel below: `finish` (common.cuh) over the grid, writing
// dW ((Co, Ci), f32 when out_bf16 is 0, else bf16).
__device__ __forceinline__ void finish_dw(float* __restrict__ partials, int* __restrict__ counters,
                                          void* __restrict__ out, int out_bf16, int M, int group,
                                          int& ticket) {
  finish(partials, counters, gridDim.x, blockIdx.x, M, group, ticket, [&](int e, float s) {
    if (out_bf16)
      static_cast<__nv_bfloat16*>(out)[e] = __float2bfloat16_rn(s);
    else
      static_cast<float*>(out)[e] = s;
  });
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
  finish_dw(partials, counters, out, out_bf16, Ci * Co, group, ticket);
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

// N consecutive values of a staged row as f32, by the widest loads the
// offsets allow (a block's offset is a multiple of N, a row 16-byte aligned).
template <int N>
__device__ __forceinline__ void load_vals(const float* p, float (&f)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + j);
      f[j] = v.x, f[j + 1] = v.y, f[j + 2] = v.z, f[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + j);
      f[j] = v.x, f[j + 1] = v.y;
    }
  }
}
template <int N>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p, float (&f)[N]) {
  // a bf16 is the upper half of an f32
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 8) {
      float v[8];
      Vec<__nv_bfloat16>::unpack(*reinterpret_cast<const uint4*>(p + j), v);
#pragma unroll
      for (int q = 0; q < 8; ++q) f[j + q] = v[q];
    }
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(p + j);
      f[j] = __uint_as_float(v.x << 16), f[j + 1] = __uint_as_float(v.x & 0xffff0000u);
      f[j + 2] = __uint_as_float(v.y << 16), f[j + 3] = __uint_as_float(v.y & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      const unsigned v = *reinterpret_cast<const unsigned*>(p + j);
      f[j] = __uint_as_float(v << 16), f[j + 1] = __uint_as_float(v & 0xffff0000u);
    }
  }
}

// Waits until at most n (< 3) of this thread's committed copy groups are in
// flight.
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  if (n <= 0)
    cp_async_wait<0>();
  else if (n == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<2>();
}

// A thread owns a BI x BO block of dW; the (Ci / BI) * (Co / BO) blocks of one
// copy of dW make a group, and the CTA's groups take the rows of a chunk in
// turn (per row BI + BO operands from shared memory, BI * BO FMAs).  The CTA
// walks its contiguous range of K in chunks of R rows through a ring of S
// slots: 16-byte cp.async copies (zero fill past K) keep the next S - 1
// chunks in flight while the FMAs run on this one, one barrier a chunk.
template <typename T, int BI, int BO>
__global__ void __launch_bounds__(kThreads)
wgrad_fma_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ partials,
                 int* __restrict__ counters, void* __restrict__ out, int out_bf16, long long K,
                 int rows_per_cta, int group, int Ci, int Co, int R, int S) {
  constexpr int V = Vec<T>::n;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ticket;
  const int ldx = Ci + V, ldy = Co + V;  // rows padded by 16 bytes: other banks
  const int slot = R * (ldx + ldy);      // elements of a chunk's x and dy
  T* ring = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x;
  const int blocks_o = Co / BO, blocks = (Ci / BI) * blocks_o;
  const int groups = kThreads / blocks;
  const int grp = tid / blocks, blk = tid - grp * blocks;
  const int i0 = (blk / blocks_o) * BI, o0 = (blk % blocks_o) * BO;
  const bool active = grp < groups;

  const long long r0 = (long long)blockIdx.x * rows_per_cta;
  const long long r1 = r0 + rows_per_cta < K ? r0 + rows_per_cta : K;
  const int chunks = r1 > r0 ? int((r1 - r0 + R - 1) / R) : 0;
  const int vx = Ci / V, vy = Co / V;  // 16-byte vectors of a row
  // starts the copy of chunk s into its slot; a chunk never reaches into the
  // next CTA's range (rows_per_cta is a multiple of R)
  auto stage = [&](int s) {
    T* xs = ring + (s % S) * slot;
    T* ys = xs + R * ldx;
    const long long r = r0 + (long long)s * R;
    for (int v = tid; v < R * vx; v += kThreads) {
      const int row = v / vx, cv = v - row * vx;
      const bool inside = r + row < K;
      cp_async16(xs + row * ldx + cv * V, x + (inside ? size_t(r + row) * Ci + cv * V : 0),
                 inside);
    }
    for (int v = tid; v < R * vy; v += kThreads) {
      const int row = v / vy, cv = v - row * vy;
      const bool inside = r + row < K;
      cp_async16(ys + row * ldy + cv * V, dy + (inside ? size_t(r + row) * Co + cv * V : 0),
                 inside);
    }
  };

  float acc[BI][BO];
#pragma unroll
  for (int i = 0; i < BI; ++i)
#pragma unroll
    for (int o = 0; o < BO; ++o) acc[i][o] = 0.0f;

  for (int s = 0; s < S - 1; ++s) {
    if (s < chunks) stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < chunks; ++s) {
    cp_async_wait_pending(S - 2);  // chunk s has landed
    __syncthreads();               // ... for every thread; chunk s - 1's slot is free
    if (s + S - 1 < chunks) stage(s + S - 1);
    cp_async_commit();
    const T* xs = ring + (s % S) * slot;
    const T* ys = xs + R * ldx;
    if (active) {
#pragma unroll 2
      for (int row = grp; row < R; row += groups) {
        float xv[BI], gv[BO];
        load_vals<BI>(xs + row * ldx + i0, xv);
        load_vals<BO>(ys + row * ldy + o0, gv);
#pragma unroll
        for (int i = 0; i < BI; ++i)
#pragma unroll
          for (int o = 0; o < BO; ++o) acc[i][o] = fmaf(xv[i], gv[o], acc[i][o]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is dead: its memory takes the sum

  // the groups' copies of dW, summed in group order into this CTA's partial
  float* red = reinterpret_cast<float*>(smem);  // (groups, Ci, Co)
  if (active) {
#pragma unroll
    for (int i = 0; i < BI; ++i)
#pragma unroll
      for (int o = 0; o < BO; ++o) red[(grp * Ci + i0 + i) * Co + o0 + o] = acc[i][o];
  }
  __syncthreads();
  // e walks red's (Ci, Co) order, so a warp reads consecutive words
  float* mine = partials + size_t(blockIdx.x) * Ci * Co;  // (Co, Ci)
  for (int e = tid; e < Ci * Co; e += kThreads) {
    const int i = e / Co, o = e - i * Co;
    float s = 0.0f;
    for (int g = 0; g < groups; ++g) s += red[g * Ci * Co + e];
    mine[o * Ci + i] = s;
  }
  finish_dw(partials, counters, out, out_bf16, Ci * Co, group, ticket);
}

// The register blocks (BI, BO) the kernel is built for, the larger first.
constexpr int kFmaBlocks[][2] = {{8, 8}, {8, 6}, {8, 4}, {4, 4}};
constexpr int kFmaBlockCount = 4;

// The register block of (Ci, Co): number `block` (1-based) of kFmaBlocks when
// positive, else the first of those that cut dW into 32 blocks (a warp holds
// one copy of dW, so its lanes read one staged row: 4 x 4 at 32 -> 16, 8 x 6
// at 16 -> 96, the fastest in the A/B on the H100, PERF.md) or, where none
// does, the first of those that keep the most threads busy; -1 when it does
// not divide the channels.
inline int fma_block(int Ci, int Co, int block) {
  int best = -1, best_score = 0;
  for (int b = 0; b < kFmaBlockCount; ++b) {
    const int bi = kFmaBlocks[b][0], bo = kFmaBlocks[b][1];
    if (Ci % bi != 0 || Co % bo != 0 || (block > 0 && b != block - 1)) continue;
    const int blocks = (Ci / bi) * (Co / bo);
    if (blocks > kThreads) continue;
    const int score = (blocks == 32 ? kThreads + 1 : 0) + kThreads / blocks * blocks;
    if (score > best_score) best = b, best_score = score;
  }
  return best;
}

// Shared memory of a launch: the ring, or the groups' copies of dW if larger.
inline size_t fma_smem(int Ci, int Co, int bi, int bo, int R, int S, size_t elem) {
  const int V = int(16 / elem);
  const size_t ring = size_t(S) * R * (Ci + Co + 2 * V) * elem;
  const size_t red = size_t(kThreads / ((Ci / bi) * (Co / bo))) * Ci * Co * sizeof(float);
  return ring > red ? ring : red;
}

template <typename T, int BI, int BO>
cudaError_t launch_fma_block(const void* x, const void* dy, float* partials, int* counters,
                             void* out, int out_bf16, long long K, int Ci, int Co, int R, int S,
                             const Split& s, cudaStream_t stream) {
  const size_t smem = fma_smem(Ci, Co, BI, BO, R, S, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_fma_kernel<T, BI, BO>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  wgrad_fma_kernel<T, BI, BO><<<s.ctas, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), partials, counters, out, out_bf16, K,
      s.rows_per_cta, s.group, Ci, Co, R, S);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma(const void* x, const void* dy, float* partials, int* counters, void* out,
                       int out_bf16, long long K, int Ci, int Co, int R, int S, int block,
                       const Split& s, cudaStream_t stream) {
  switch (fma_block(Ci, Co, block)) {
    case 0:
      return launch_fma_block<T, 8, 8>(x, dy, partials, counters, out, out_bf16, K, Ci, Co, R, S,
                                       s, stream);
    case 1:
      return launch_fma_block<T, 8, 6>(x, dy, partials, counters, out, out_bf16, K, Ci, Co, R, S,
                                       s, stream);
    case 2:
      return launch_fma_block<T, 8, 4>(x, dy, partials, counters, out, out_bf16, K, Ci, Co, R, S,
                                       s, stream);
    case 3:
      return launch_fma_block<T, 4, 4>(x, dy, partials, counters, out, out_bf16, K, Ci, Co, R, S,
                                       s, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
  finish_dw(partials, counters, out, out_bf16, Ci * Co, group, ticket);
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

// The CUDA-core kernel's rows a chunk: `rows` when positive, else the
// built-in rule.
inline int fma_rows(int Ci, int Co, int rows) {
  if (rows > 0) return rows;
  int r = kFmaMaxRows;
  while (r > 1 && r * (Ci + Co) > kFmaChunkElems) r >>= 1;
  return r;
}

// The split of a launch: `ctas` CTAs when positive, else kMmaCtas for the
// tensor-core kernel, kFmaCtasPerSm an SM for the CUDA-core one and kCopyCtas
// for the loads alone; the CUDA-core kernel's ranges are whole chunks.
inline cudaError_t split_for(int kernel, long long K, int Ci, int Co, int rows, int ctas,
                             Split* s) {
  int granularity = kChunkRows;
  if (kernel == 1) {
    granularity = fma_rows(Ci, Co, rows);
    if (ctas <= 0) {
      int device = 0, sms = 0;
      cudaError_t err = cudaGetDevice(&device);
      if (err != cudaSuccess) return err;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (err != cudaSuccess) return err;
      ctas = sms * kFmaCtasPerSm;
    }
  } else if (ctas <= 0) {
    ctas = kernel == 0 ? kMmaCtas : kCopyCtas;
  }
  *s = make_split(K, ctas, granularity);
  return cudaSuccess;
}

bool fma_args_ok(int rows, int stages) {
  return rows >= 0 && rows <= 1024 && stages >= 0 && stages <= 4 && stages != 1;
}

}  // namespace

// The grid a launch below uses for K rows, given `rows` (the CUDA-core
// kernel's chunk; the others ignore it) and `ctas`, 0 for the built-in
// choices: *ctas_out, the first extent of the (CTAs, Co, Ci) f32 scratch, and
// *counters_out, the int32 counters it needs, zero before the first launch
// (each launch leaves them zero).  Returns a cudaError_t (0 on success).
extern "C" int pointwise_wgrad_grid(int kernel, long long K, int Ci, int Co, int rows, int ctas,
                                    int* ctas_out, int* counters_out) {
  if (K < 1 || !channels_ok(Ci, Co) || !fma_args_ok(rows, 0)) return cudaErrorInvalidValue;
  Split s;
  const cudaError_t err = split_for(kernel, K, Ci, Co, rows, ctas, &s);
  if (err != cudaSuccess) return err;
  *ctas_out = s.ctas;
  *counters_out = counters_needed(s);
  return cudaSuccess;
}

// The CUDA-core kernel at (rows a chunk, chunks in the ring, register block
// number), 0 for the built-in choices: *out receives (BI, BO, rows, stages,
// shared bytes a CTA) for operands of `dtype` (0 f32, 1 bf16).  Returns a
// cudaError_t (0 on success).
extern "C" int wgrad_fma_config(int dtype, int Ci, int Co, int rows, int stages, int block,
                                int* out) {
  if (!channels_ok(Ci, Co) || !fma_args_ok(rows, stages) || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  const int b = fma_block(Ci, Co, block);
  if (b < 0) return cudaErrorInvalidValue;
  const int R = fma_rows(Ci, Co, rows), S = stages > 0 ? stages : kFmaStages;
  out[0] = kFmaBlocks[b][0], out[1] = kFmaBlocks[b][1], out[2] = R, out[3] = S;
  out[4] = int(fma_smem(Ci, Co, out[0], out[1], R, S, dtype == 0 ? 4 : 2));
  return cudaSuccess;
}

// The CUDA-core kernel, one launch, with its knobs: rows a chunk (the grid's
// `rows`), chunks in the ring (2-4) and register block (1-based in
// kFmaBlocks), 0 for the built-in choices; the other arguments as for
// pointwise_wgrad_launch.
extern "C" int wgrad_fma_launch(int dtype, const void* x, const void* dy, void* partials,
                                void* counters, void* out, int out_bf16, long long K, int Ci,
                                int Co, int rows, int ctas, int stages, int block, void* stream) {
  if (K < 1 || !channels_ok(Ci, Co) || !fma_args_ok(rows, stages) || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  Split s;
  const cudaError_t err = split_for(1, K, Ci, Co, rows, ctas, &s);
  if (err != cudaSuccess) return err;
  const int R = fma_rows(Ci, Co, rows), S = stages > 0 ? stages : kFmaStages;
  auto st = static_cast<cudaStream_t>(stream);
  auto pf = static_cast<float*>(partials);
  auto ct = static_cast<int*>(counters);
  return dtype == 0
             ? launch_fma<float>(x, dy, pf, ct, out, out_bf16, K, Ci, Co, R, S, block, s, st)
             : launch_fma<__nv_bfloat16>(x, dy, pf, ct, out, out_bf16, K, Ci, Co, R, S, block, s,
                                         st);
}

// kernel: 0 = mma (bf16 only), 1 = fma, 2 = copy.  dtype: 0 = float32, 1 =
// bfloat16.  x (K, Ci), dy (K, Co) contiguous, 16-byte aligned; partials and
// counters as pointwise_wgrad_grid sizes them for the same (kernel, K, Ci,
// Co, rows, ctas); out (Co, Ci) in f32 (out_bf16 = 0) or bf16 (1).  rows (mma:
// a warp's slab, fma: a chunk) and ctas: 0 for the built-in choice.  One
// launch.  Returns a cudaError_t (0 on success).
extern "C" int pointwise_wgrad_launch(int kernel, int dtype, const void* x, const void* dy,
                                      void* partials, void* counters, void* out, int out_bf16,
                                      long long K, int Ci, int Co, int rows, int ctas,
                                      void* stream) {
  if (K < 1 || !channels_ok(Ci, Co) || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
  if (kernel == 1)
    return wgrad_fma_launch(dtype, x, dy, partials, counters, out, out_bf16, K, Ci, Co, rows,
                            ctas, 0, 0, stream);
  auto st = static_cast<cudaStream_t>(stream);
  auto pf = static_cast<float*>(partials);
  auto ct = static_cast<int*>(counters);
  Split s;
  const cudaError_t err = split_for(kernel, K, Ci, Co, rows, ctas, &s);
  if (err != cudaSuccess) return err;
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

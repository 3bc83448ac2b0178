// Shared pieces of the port's kernels: dtype conversion and the asynchronous
// 16-byte copy (all of them), and, for the 3x3 depthwise backward kernels
// (depthwise_backward.cu, fused_chain_backward.cu), the tile geometry, the
// in-CTA reduction of per-thread partial sums and the cross-CTA reduction
// kernel.
//
// Geometry.  Tensors are NHWC contiguous, so the (w, c) axes of one image row
// are one contiguous run.  A CTA owns one image, kTileRows rows, tw columns
// and a chunk of cc channels (cc a power of two <= kMaxChunk, tw * cc <=
// kTileLanes).  A thread's channel is tid % cc for the whole kernel
// (kThreads % cc == 0), which lets it keep per-channel constants and the
// per-tap weight-gradient sums in registers while it walks the tile.  Ragged
// tiles and a ragged last channel chunk are predicated.
//
// Reductions across the grid.  CUDA blocks carry nothing from one to the next,
// so each CTA reduces its per-thread sums in shared memory, in a fixed order,
// to `rows_per_tile` x C values and writes them to a (tiles, rows, C) f32
// buffer; `reduce_partials_kernel` then sums over the tiles, again in a fixed
// order.  No atomics: the result is the same bit pattern on every run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ssdseg {

constexpr int kThreads = 256;
constexpr int kTileRows = 8;
constexpr int kTileLanes = 1024;
constexpr int kMaxChunk = 64;

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

struct Tiling {
  int cc;       // channels per chunk (power of two)
  int cc_log2;  // log2(cc): lane -> (column, channel) by shift and mask
  int tw;       // columns per tile
  int tiles_h;  // row tiles per image
  int tiles_w;  // column tiles per image
  int chunks;   // channel chunks
};

inline Tiling make_tiling(int H, int W, int C) {
  Tiling t;
  t.cc = 1;
  t.cc_log2 = 0;
  while (t.cc < C && t.cc < kMaxChunk) {
    t.cc <<= 1;
    ++t.cc_log2;
  }
  t.tw = kTileLanes / t.cc;
  if (t.tw > W) t.tw = W;
  t.tiles_h = (H + kTileRows - 1) / kTileRows;
  t.tiles_w = (W + t.tw - 1) / t.tw;
  t.chunks = (C + t.cc - 1) / t.cc;
  return t;
}

// Where a CTA works: decoded from blockIdx (x: chunk fastest, then column
// tile, then row tile; y: image).
struct TileCoord {
  int c0, y0, x0;
  size_t tile;  // linear index over (image, row tile, column tile)
};

__device__ __forceinline__ TileCoord tile_coord(const Tiling& t) {
  TileCoord tc;
  int b = blockIdx.x;
  tc.c0 = (b % t.chunks) * t.cc;
  b /= t.chunks;
  tc.x0 = (b % t.tiles_w) * t.tw;
  const int th = b / t.tiles_w;
  tc.y0 = th * kTileRows;
  tc.tile = (size_t(blockIdx.y) * t.tiles_h + th) * t.tiles_w + (tc.x0 / t.tw);
  return tc;
}

// Both convolution gradients of one tile, from shared memory:
//
//     dx[t,w,c]  = sum_{i,j} k[i,j,c] * g[t+1-i, w+1-j, c]
//     dk[i,j,c] += x[t+i-1, w+j-1, c] * g[t,w,c]
//
// gs is the cotangent g (f32) and xs the conv input x on the tile plus a
// one-pixel halo, both (kTileRows + 2, tw + 2, cc) and zero outside the image.
// A thread keeps its channel and walks down the rows of one column at a time
// with the 3 x 3 windows of g and x in registers, so a new output row costs
// six shared-memory loads, not eighteen.  acc collects this thread's dk.
template <typename T>
__device__ __forceinline__ void conv_grads_from_tile(
    const float* __restrict__ gs, const T* __restrict__ xs, const float (&kk)[9],
    float (&acc)[9], T* __restrict__ dx, const Tiling& t, const TileCoord& tc, size_t img,
    int H, int W, int C, int c, int ch) {
  const int cc = t.cc, wp = t.tw + 2;
  const int row = wp * cc;  // elements between two halo rows
  for (int l = threadIdx.x; l < t.tw * cc; l += kThreads) {
    const int q = (l >> t.cc_log2) + 1;  // column of the centre pixel in the halo tile
    const int gx = tc.x0 + q - 1;
    if (gx >= W) break;
    const int base = (q - 1) * cc + ch;  // halo row 0, column q - 1
    float g0[3], g1[3], g2[3], x0[3], x1[3], x2[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      g0[j] = gs[base + j * cc];
      g1[j] = gs[base + row + j * cc];
      x0[j] = to_f<T>(xs[base + j * cc]);
      x1[j] = to_f<T>(xs[base + row + j * cc]);
    }
#pragma unroll
    for (int r = 1; r <= kTileRows; ++r) {
      const int gy = tc.y0 + r - 1;
      if (gy >= H) break;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        g2[j] = gs[base + (r + 1) * row + j * cc];
        x2[j] = to_f<T>(xs[base + (r + 1) * row + j * cc]);
      }
      float v = 0.0f;
      const float g = g1[1];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        // tap (i, j) reads g at row r + 1 - i, column q + 1 - j
        v = fmaf(kk[j], g2[2 - j], v);
        v = fmaf(kk[3 + j], g1[2 - j], v);
        v = fmaf(kk[6 + j], g0[2 - j], v);
        // tap (i, j) reads x at row r + i - 1, column q + j - 1
        acc[j] = fmaf(x0[j], g, acc[j]);
        acc[3 + j] = fmaf(x1[j], g, acc[3 + j]);
        acc[6 + j] = fmaf(x2[j], g, acc[6 + j]);
      }
      dx[(img + size_t(gy) * W + gx) * C + c] = from_f<T>(v);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        g0[j] = g1[j];
        g1[j] = g2[j];
        x0[j] = x1[j];
        x1[j] = x2[j];
      }
    }
  }
}

// Sums `acc[0..R)` over the threads of the CTA that share a channel and writes
// the R x cc results of this CTA's chunk to partials[tile][r][c0 + ch].
// `red` is shared memory of at least R * kThreads floats that no thread still
// reads (the caller synchronises before).
template <int R>
__device__ __forceinline__ void reduce_to_partials(const float (&acc)[R], float* red,
                                                   float* __restrict__ partials,
                                                   const Tiling& t, const TileCoord& tc,
                                                   int C) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int r = 0; r < R; ++r) red[r * kThreads + tid] = acc[r];
  __syncthreads();
  const int groups = kThreads >> t.cc_log2;
  for (int o = tid; o < R * t.cc; o += kThreads) {
    const int r = o >> t.cc_log2, ch = o & (t.cc - 1);
    float s = 0.0f;
    for (int g = 0; g < groups; ++g) s += red[r * kThreads + g * t.cc + ch];
    if (tc.c0 + ch < C) partials[(tc.tile * R + r) * C + tc.c0 + ch] = s;
  }
}

// out[o] = sum over p < n of partials[p * M + o], in a fixed order.
static __global__ void __launch_bounds__(1024)
reduce_partials_kernel(const float* __restrict__ partials, float* __restrict__ out, int n,
                       int M) {
  __shared__ float s[32][33];
  const int o = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.0f;
  if (o < M)
    for (int p = threadIdx.y; p < n; p += 32) acc += partials[size_t(p) * M + o];
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && o < M) {
    float total = 0.0f;
    for (int i = 0; i < 32; ++i) total += s[i][threadIdx.x];
    out[o] = total;
  }
}

inline cudaError_t reduce_partials(const float* partials, float* out, int n, int M,
                                   cudaStream_t stream) {
  reduce_partials_kernel<<<(M + 31) / 32, dim3(32, 32), 0, stream>>>(partials, out, n, M);
  return cudaGetLastError();
}

// Bytes of dynamic shared memory for a tile with one f32 plane (the cotangent)
// and `t_planes` planes in the I/O dtype, never less than the reduction needs.
inline size_t tile_smem_bytes(const Tiling& t, size_t elem, int t_planes, int reduce_rows) {
  const size_t n = size_t(kTileRows + 2) * (t.tw + 2) * t.cc;
  const size_t tile = n * sizeof(float) + t_planes * n * elem;
  const size_t red = size_t(reduce_rows) * kThreads * sizeof(float);
  return tile > red ? tile : red;
}

}  // namespace ssdseg

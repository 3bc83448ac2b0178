// Backward of a SAME stride-1 3x3 depthwise convolution for Hopper (sm_90a):
// input gradient and weight gradient in one pass over x and dy.
//
// Replaces ssdseglib_tpu/ops/depthwise_backward.py::_bwd_kernel (the Pallas
// TPU kernel).  With g = dy:
//
//     dx[t,w,c]  = sum_{i,j} k[i,j,c] * g[t+1-i, w+1-j, c]
//     dk[i,j,c]  = sum_{b,t,w} x[t+i-1, w+j-1, c] * g[t,w,c]
//
// all products and sums in f32, dx rounded once to the I/O dtype, dk f32.
//
// What bounds it on the H100: bytes.  x and dy are read and dx is written
// once (3 tensors), against 36 FLOPs per element on the CUDA cores.  A library
// route runs two convolutions (input gradient, weight gradient) and reads dy
// twice; here a CTA stages its tile of x and dy plus a one-pixel halo in
// shared memory once and takes both gradients from it.  The halo outside the
// image is written as zero (the convolution's padding), so no padded copy of
// a tensor is made in device memory.  The TPU kernel carried its (9, W*C)
// weight-gradient sum through a sequential grid; here each CTA writes 9 x C
// partial sums and a second kernel adds them up in a fixed order (common.cuh).
//
// Layout: x, dy, dx (B, H, W, C) NHWC contiguous in the I/O dtype (float32 or
// bfloat16); k (9, C) f32, taps row-major; dk (9, C) f32.

#include "common.cuh"

namespace {

using namespace ssdseg;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dw_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ k,
              T* __restrict__ dx, float* __restrict__ partials, int H, int W, int C,
              Tiling t) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int hp = kTileRows + 2;
  const int wp = t.tw + 2, cc = t.cc;
  const int n_halo = hp * wp * cc;
  float* gs = reinterpret_cast<float*>(smem);                        // (hp, wp, cc) dy, f32
  T* xs = reinterpret_cast<T*>(smem + size_t(n_halo) * sizeof(float));  // (hp, wp, cc) x

  const TileCoord tc = tile_coord(t);
  const size_t img = size_t(blockIdx.y) * H * W;
  const int tid = threadIdx.x;
  const int ch = tid & (cc - 1);  // the same for every element this thread touches
  const int c = tc.c0 + ch;

  // 1. x and dy on the tile + halo, zero outside the image.  A thread takes a
  //    (column, channel) lane and all rows of it at once, so its loads are
  //    independent and in flight together; neighbouring threads read
  //    neighbouring addresses (channel fastest, then column).
  for (int l = tid; l < wp * cc; l += kThreads) {
    const int gx = tc.x0 - 1 + (l >> t.cc_log2);
    const bool col_inside = c < C && gx >= 0 && gx < W;
    T xv[hp], gv[hp];
#pragma unroll
    for (int r = 0; r < hp; ++r) {
      const int gy = tc.y0 - 1 + r;
      xv[r] = from_f<T>(0.0f);
      gv[r] = from_f<T>(0.0f);
      if (col_inside && gy >= 0 && gy < H) {
        const size_t idx = (img + size_t(gy) * W + gx) * C + c;
        xv[r] = x[idx];
        gv[r] = dy[idx];
      }
    }
#pragma unroll
    for (int r = 0; r < hp; ++r) {
      gs[r * wp * cc + l] = to_f<T>(gv[r]);
      xs[r * wp * cc + l] = xv[r];
    }
  }
  __syncthreads();

  // 2. both gradients from shared memory.
  float kk[9], acc[9];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    kk[tap] = c < C ? k[tap * C + c] : 0.0f;
    acc[tap] = 0.0f;
  }
  if (c < C) conv_grads_from_tile<T>(gs, xs, kk, acc, dx, t, tc, img, H, W, C, c, ch);
  __syncthreads();  // the tile is dead: its memory takes the reduction

  // 3. 9 x cc partial weight-gradient sums of this CTA.
  reduce_to_partials<9>(acc, gs, partials, t, tc, C);
}

template <typename T>
int launch(const void* x, const void* dy, const float* k, void* dx, float* partials, float* dk,
           int B, int H, int W, int C, cudaStream_t stream) {
  const Tiling t = make_tiling(H, W, C);
  const size_t smem = tile_smem_bytes(t, sizeof(T), 1, 9);
  cudaError_t err = cudaFuncSetAttribute(
      dw_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(t.tiles_h * t.tiles_w * t.chunks, B);
  dw_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), k, static_cast<T*>(dx), partials,
      H, W, C, t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(partials, dk, B * t.tiles_h * t.tiles_w, 9 * C, stream);
}

}  // namespace

// Rows of the (rows, 9, C) f32 scratch buffer the launches below need: one per
// (image, row tile, column tile).  The chain backward uses the same tiling.
extern "C" int dw_bwd_partial_rows(int B, int H, int W, int C) {
  const Tiling t = make_tiling(H, W, C);
  return B * t.tiles_h * t.tiles_w;
}

// dtype: 0 = float32, 1 = bfloat16.  partials: (dw_bwd_partial_rows, 9, C) f32
// scratch.  Returns a cudaError_t (0 on success).
extern "C" int depthwise_backward_launch(int dtype, const void* x, const void* dy,
                                         const void* k, void* dx, void* partials, void* dk,
                                         int B, int H, int W, int C, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || B > 65535) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto kf = static_cast<const float*>(k);
  auto pf = static_cast<float*>(partials);
  auto df = static_cast<float*>(dk);
  if (dtype == 0) return launch<float>(x, dy, kf, dx, pf, df, B, H, W, C, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, dy, kf, dx, pf, df, B, H, W, C, s);
  return cudaErrorInvalidValue;
}

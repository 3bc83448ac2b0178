// Whole backward of depthwise 3x3 + train-mode BatchNorm + ReLU6 for Hopper
// (sm_90a).
//
// Replaces ssdseglib_tpu/ops/fused_chain_backward.py::_chain_kernel (the
// Pallas TPU kernel) and, as a kernel of its own, the reduction pre-pass that
// the JAX package leaves to XLA.  The forward unit is
//
//     u = dw3x3_same(x, k);  mean, var = batch statistics of u
//     z = round((u - mean) * (inv * gamma) + beta);  y = min(max(z, 0), 6)
//
// and, given dy, with N = B*H*W and xhat = (u - mean) * inv:
//
//     dz     = dy where (z > 0 and z <= 6), else 0
//     dbeta  = sum dz;  dgamma = sum dz * xhat                (pass 1)
//     du     = A * dz - Bc - D * xhat                         (pass 2)
//              A = gamma * inv, Bc = A * dbeta / N, D = A * dgamma / N
//     dx     = corr3x3(du, flipped k);  dk[i,j] = sum x[t+i-1, w+j-1] * du[t,w]
//
// Rounding points, shared with the plain PyTorch version: z is computed in
// f32 with separately rounded multiply and add (no fused multiply-add), cast
// to the I/O dtype and compared there, so a bf16 run masks exactly the
// elements the forward clipped; everything else is f32, dx is rounded once.
//
// What bounds it on the H100: bytes.  Pass 2 reads x, u, dy and writes dx once
// (pass 1 reads u and dy once more).  xhat, the mask, dz and du are recomputed
// per tile and live only in shared memory, so none of the chain's
// intermediates crosses device memory.  du is computed on the tile plus a
// one-pixel halo; outside the image it is written as ZERO, not as -Bc: there
// it is the padding of the correlation, not a BatchNorm gradient.  Tiling and
// the deterministic two-step reductions are those of depthwise_backward.cu
// (common.cuh).
//
// Layout: x, u, dy, dx (B, H, W, C) NHWC contiguous in the I/O dtype (float32
// or bfloat16); k (9, C) f32; coef (6, C) f32 with rows mean, inv, A, beta,
// Bc, D (pass 1 reads the first four); sums (2, C) f32 = dbeta, dgamma;
// dk (9, C) f32.

#include "common.cuh"

namespace {

using namespace ssdseg;

struct ChannelCoef {
  float mean, inv, a, beta;
};

__device__ __forceinline__ ChannelCoef load_coef(const float* __restrict__ coef, int C, int c) {
  ChannelCoef k = {0.0f, 0.0f, 0.0f, 0.0f};
  if (c < C) {
    k.mean = coef[c];
    k.inv = coef[C + c];
    k.a = coef[2 * C + c];
    k.beta = coef[3 * C + c];
  }
  return k;
}

// dz and xhat of one element.  The intrinsics keep the compiler from fusing
// the multiply and the add of z, which would move the mask's rounding point.
template <typename T>
__device__ __forceinline__ void dz_xhat(float u, float dy, const ChannelCoef& k, float* dz,
                                        float* xhat) {
  const float d = __fsub_rn(u, k.mean);
  const float z = to_f<T>(from_f<T>(__fadd_rn(__fmul_rn(d, k.a), k.beta)));
  *dz = (z > 0.0f && z <= 6.0f) ? dy : 0.0f;
  *xhat = __fmul_rn(d, k.inv);
}

// Pass 1: per-CTA partial sums of dz and dz * xhat.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chain_sums_kernel(const T* __restrict__ u, const T* __restrict__ dy,
                  const float* __restrict__ coef, float* __restrict__ partials, int H, int W,
                  int C, Tiling t) {
  __shared__ float red[2 * kThreads];
  const TileCoord tc = tile_coord(t);
  const size_t img = size_t(blockIdx.y) * H * W;
  const int tid = threadIdx.x;
  const int ch = tid & (t.cc - 1);
  const int c = tc.c0 + ch;
  const ChannelCoef k = load_coef(coef, C, c);
  float acc[2] = {0.0f, 0.0f};
  if (c < C) {
    for (int l = tid; l < t.tw * t.cc; l += kThreads) {
      const int gx = tc.x0 + (l >> t.cc_log2);
      if (gx >= W) break;
      T uv[kTileRows], gv[kTileRows];
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {  // independent loads, in flight together
        const int gy = tc.y0 + r;
        uv[r] = from_f<T>(0.0f);
        gv[r] = from_f<T>(0.0f);
        if (gy < H) {
          const size_t idx = (img + size_t(gy) * W + gx) * C + c;
          uv[r] = u[idx];
          gv[r] = dy[idx];
        }
      }
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        if (tc.y0 + r >= H) break;
        float dz, xhat;
        dz_xhat<T>(to_f<T>(uv[r]), to_f<T>(gv[r]), k, &dz, &xhat);
        acc[0] += dz;
        acc[1] = fmaf(dz, xhat, acc[1]);
      }
    }
  }
  reduce_to_partials<2>(acc, red, partials, t, tc, C);
}

// Pass 2: du on the tile + halo into shared memory, then dx and the dk
// partial sums from it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chain_bwd_kernel(const T* __restrict__ x, const T* __restrict__ u, const T* __restrict__ dy,
                 const float* __restrict__ kern, const float* __restrict__ coef,
                 T* __restrict__ dx, float* __restrict__ partials, int H, int W, int C,
                 Tiling t) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int hp = kTileRows + 2;
  const int wp = t.tw + 2, cc = t.cc;
  const int n_halo = hp * wp * cc;
  float* gs = reinterpret_cast<float*>(smem);                        // (hp, wp, cc) du, f32
  T* xs = reinterpret_cast<T*>(smem + size_t(n_halo) * sizeof(float));  // (hp, wp, cc) x

  const TileCoord tc = tile_coord(t);
  const size_t img = size_t(blockIdx.y) * H * W;
  const int tid = threadIdx.x;
  const int ch = tid & (cc - 1);
  const int c = tc.c0 + ch;
  const ChannelCoef k = load_coef(coef, C, c);
  const float bc = c < C ? coef[4 * C + c] : 0.0f;
  const float dcoef = c < C ? coef[5 * C + c] : 0.0f;

  // 1. the elementwise gradient chain on the tile + halo.  A thread takes a
  //    (column, channel) lane and all rows of it at once, so its loads are
  //    independent and in flight together; neighbouring threads read
  //    neighbouring addresses (channel fastest, then column).
  for (int l = tid; l < wp * cc; l += kThreads) {
    const int gx = tc.x0 - 1 + (l >> t.cc_log2);
    const bool col_inside = c < C && gx >= 0 && gx < W;
    T xv[hp], uv[hp], gv[hp];
    bool inside[hp];
#pragma unroll
    for (int r = 0; r < hp; ++r) {
      const int gy = tc.y0 - 1 + r;
      inside[r] = col_inside && gy >= 0 && gy < H;
      xv[r] = from_f<T>(0.0f);
      uv[r] = from_f<T>(0.0f);
      gv[r] = from_f<T>(0.0f);
      if (inside[r]) {
        const size_t idx = (img + size_t(gy) * W + gx) * C + c;
        xv[r] = x[idx];
        uv[r] = u[idx];
        gv[r] = dy[idx];
      }
    }
#pragma unroll
    for (int r = 0; r < hp; ++r) {
      float du = 0.0f;  // outside the image: the correlation's padding
      if (inside[r]) {
        float dz, xhat;
        dz_xhat<T>(to_f<T>(uv[r]), to_f<T>(gv[r]), k, &dz, &xhat);
        du = __fsub_rn(__fsub_rn(__fmul_rn(k.a, dz), bc), __fmul_rn(dcoef, xhat));
      }
      gs[r * wp * cc + l] = du;
      xs[r * wp * cc + l] = xv[r];
    }
  }
  __syncthreads();

  // 2. the two convolution gradients from shared memory.
  float kk[9], acc[9];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    kk[tap] = c < C ? kern[tap * C + c] : 0.0f;
    acc[tap] = 0.0f;
  }
  if (c < C) conv_grads_from_tile<T>(gs, xs, kk, acc, dx, t, tc, img, H, W, C, c, ch);
  __syncthreads();  // the tile is dead: its memory takes the reduction

  reduce_to_partials<9>(acc, gs, partials, t, tc, C);
}

template <typename T>
int launch_sums(const void* u, const void* dy, const float* coef, float* partials, float* sums,
                int B, int H, int W, int C, cudaStream_t stream) {
  const Tiling t = make_tiling(H, W, C);
  const dim3 grid(t.tiles_h * t.tiles_w * t.chunks, B);
  chain_sums_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dy), coef, partials, H, W, C, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(partials, sums, B * t.tiles_h * t.tiles_w, 2 * C, stream);
}

template <typename T>
int launch_bwd(const void* x, const void* u, const void* dy, const float* kern,
               const float* coef, void* dx, float* partials, float* dk, int B, int H, int W,
               int C, cudaStream_t stream) {
  const Tiling t = make_tiling(H, W, C);
  const size_t smem = tile_smem_bytes(t, sizeof(T), 1, 9);
  cudaError_t err = cudaFuncSetAttribute(
      chain_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(t.tiles_h * t.tiles_w * t.chunks, B);
  chain_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(u), static_cast<const T*>(dy), kern, coef,
      static_cast<T*>(dx), partials, H, W, C, t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_partials(partials, dk, B * t.tiles_h * t.tiles_w, 9 * C, stream);
}

bool bad_shape(int B, int H, int W, int C) {
  return B < 1 || H < 1 || W < 1 || C < 1 || B > 65535;
}

}  // namespace

// Pass 1.  dtype: 0 = float32, 1 = bfloat16.  partials: (rows, 2, C) f32
// scratch with rows = dw_bwd_partial_rows(B, H, W, C); sums: (2, C) f32 out.
// Returns a cudaError_t (0 on success).
extern "C" int chain_bn_sums_launch(int dtype, const void* u, const void* dy, const void* coef,
                                    void* partials, void* sums, int B, int H, int W, int C,
                                    void* stream) {
  if (bad_shape(B, H, W, C)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto cf = static_cast<const float*>(coef);
  auto pf = static_cast<float*>(partials);
  auto sf = static_cast<float*>(sums);
  if (dtype == 0) return launch_sums<float>(u, dy, cf, pf, sf, B, H, W, C, s);
  if (dtype == 1) return launch_sums<__nv_bfloat16>(u, dy, cf, pf, sf, B, H, W, C, s);
  return cudaErrorInvalidValue;
}

// Pass 2.  partials: (rows, 9, C) f32 scratch; dk: (9, C) f32 out.
extern "C" int chain_backward_launch(int dtype, const void* x, const void* u, const void* dy,
                                     const void* kern, const void* coef, void* dx,
                                     void* partials, void* dk, int B, int H, int W, int C,
                                     void* stream) {
  if (bad_shape(B, H, W, C)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto kf = static_cast<const float*>(kern);
  auto cf = static_cast<const float*>(coef);
  auto pf = static_cast<float*>(partials);
  auto df = static_cast<float*>(dk);
  if (dtype == 0) return launch_bwd<float>(x, u, dy, kf, cf, dx, pf, df, B, H, W, C, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, u, dy, kf, cf, dx, pf, df, B, H, W, C, s);
  return cudaErrorInvalidValue;
}

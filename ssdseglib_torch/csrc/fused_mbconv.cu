// Fused stride-1 inverted-residual (MBConv) inference block for Hopper (sm_90a).
//
// Replaces ssdseglib_tpu/ops/fused_mbconv.py::_mbconv_kernel (the Pallas TPU
// kernel).  One block computes, with BN already folded into weights + bias:
//
//     e = relu6(round(x @ w1 + b1))            1x1 expand   Cin -> E
//     d = relu6(round(dw3x3_same(e) + b2))     3x3 depthwise, zero halo
//     y = round(d @ w3 + b3) (+ x)             1x1 project  E -> Cout
//
// with f32 accumulation and rounding to the I/O dtype at the same three
// points as the TPU kernel, and the residual added in the I/O dtype.
//
// What bounds it on the H100: the bytes of x and out cross HBM once each,
// while the E-wide tensor (E = 6 * Cin) is six times larger than either and
// would otherwise be written and read twice.  The tiling keeps that tensor
// on chip: one CTA owns one image and one th x tw spatial tile, recomputes
// the expand on the tile plus a 1-pixel halo into shared memory (the halo
// costs (th+2)(tw+2)/(th*tw) extra expand work instead of an HBM round trip),
// runs the depthwise out of shared memory into a second shared tile, and
// projects per output pixel.  The tile is the largest that fits the opt-in
// shared memory for the given (Cin, E, dtype); ragged edge tiles are masked.
// The 1x1s run on the CUDA cores, each weight load feeding kPixelsPerThread
// FMAs; moving them to the tensor cores (wgmma) is later work.
//
// Layout: x (B, H, W, Cin) and out (B, H, W, Cout) NHWC contiguous;
// w1 (Cin, E), wd (9, E) [taps row-major], w3 (E, Cout), biases (E,)/(Cout,),
// all in the I/O dtype (float32 or bfloat16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// 512 threads x 8 pixels of register blocking per thread in the 1x1s: at
// large E only one CTA fits an SM, so the block itself has to hide the L2
// latency of the streamed weights (an A/B on the H100 over 256/512 threads
// and 4/8/16 pixels is in PERF.md).
constexpr int kThreads = 512;
constexpr int kPixelsPerThread = 8;

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

// Round to the I/O dtype, then clamp to [0, 6] (exact in either dtype).
template <typename T> __device__ __forceinline__ T round_relu6(float v) {
  return from_f<T>(fminf(fmaxf(to_f<T>(from_f<T>(v)), 0.0f), 6.0f));
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

size_t smem_bytes(int th, int tw, int cin, int e, size_t elem) {
  const size_t halo = size_t(th + 2) * (tw + 2);
  return align16(halo * cin * elem) + align16(halo * e * elem) +
         align16(size_t(th) * tw * e * elem);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mbconv_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
              const T* __restrict__ wd, const T* __restrict__ b2, const T* __restrict__ w3,
              const T* __restrict__ b3, T* __restrict__ out, int H, int W, int Cin, int E,
              int Cout, int th, int tw, int residual) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hp = th + 2, wp = tw + 2;
  const int n_halo = hp * wp;
  const int n_tile = th * tw;
  T* xs = reinterpret_cast<T*>(smem);                                  // (hp, wp, Cin)
  T* es = reinterpret_cast<T*>(smem + align16(size_t(n_halo) * Cin * sizeof(T)));  // (hp, wp, E)
  T* ds = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(es) +
                               align16(size_t(n_halo) * E * sizeof(T)));  // (th, tw, E)

  const int tiles_w = (W + tw - 1) / tw;
  const int y0 = (blockIdx.x / tiles_w) * th;
  const int x0 = (blockIdx.x % tiles_w) * tw;
  const size_t img = size_t(blockIdx.y) * H * W;
  const int tid = threadIdx.x;

  // 0. x on the tile + halo (zero outside the image).
  for (int i = tid; i < n_halo * Cin; i += kThreads) {
    const int p = i / Cin, c = i - p * Cin;
    const int gy = y0 - 1 + p / wp, gx = x0 - 1 + p % wp;
    T v = from_f<T>(0.0f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = x[(img + size_t(gy) * W + gx) * Cin + c];
    xs[i] = v;
  }
  __syncthreads();

  // 1. expand 1x1 + bias -> round -> relu6 on tile + halo.  The halo outside
  //    the image is the depthwise conv's zero padding of the EXPANDED tensor,
  //    so it is written as 0 and not as relu6(b1).
  const int halo_groups = (n_halo + kPixelsPerThread - 1) / kPixelsPerThread;
  for (int i = tid; i < halo_groups * E; i += kThreads) {
    const int g = i / E, e = i - g * E;
    const int p0 = g * kPixelsPerThread;
    float acc[kPixelsPerThread];
    int row[kPixelsPerThread];
#pragma unroll
    for (int k = 0; k < kPixelsPerThread; ++k) {
      acc[k] = 0.0f;
      row[k] = min(p0 + k, n_halo - 1) * Cin;
    }
    for (int c = 0; c < Cin; ++c) {
      const float w = to_f<T>(w1[size_t(c) * E + e]);
#pragma unroll
      for (int k = 0; k < kPixelsPerThread; ++k) acc[k] = fmaf(to_f<T>(xs[row[k] + c]), w, acc[k]);
    }
    const float bias = to_f<T>(b1[e]);
#pragma unroll
    for (int k = 0; k < kPixelsPerThread; ++k) {
      const int p = p0 + k;
      if (p >= n_halo) break;
      const int gy = y0 - 1 + p / wp, gx = x0 - 1 + p % wp;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      es[size_t(p) * E + e] = inside ? round_relu6<T>(acc[k] + bias) : from_f<T>(0.0f);
    }
  }
  __syncthreads();

  // 2. depthwise 3x3 (taps summed in row-major order, as the TPU kernel
  //    does) + bias -> round -> relu6, from shared memory into shared memory.
  for (int i = tid; i < n_tile * E; i += kThreads) {
    const int p = i / E, e = i - p * E;
    const int ty = p / tw, tx = p - ty * tw;
    float acc = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        acc = fmaf(to_f<T>(es[(size_t(ty + dy) * wp + tx + dx) * E + e]),
                   to_f<T>(wd[(dy * 3 + dx) * E + e]), acc);
    ds[i] = round_relu6<T>(acc + to_f<T>(b2[e]));
  }
  __syncthreads();

  // 3. project 1x1 + bias -> round, then the residual in the I/O dtype.
  const int tile_groups = (n_tile + kPixelsPerThread - 1) / kPixelsPerThread;
  for (int i = tid; i < tile_groups * Cout; i += kThreads) {
    const int g = i / Cout, o = i - g * Cout;
    const int p0 = g * kPixelsPerThread;
    float acc[kPixelsPerThread];
    int row[kPixelsPerThread];
#pragma unroll
    for (int k = 0; k < kPixelsPerThread; ++k) {
      acc[k] = 0.0f;
      row[k] = min(p0 + k, n_tile - 1) * E;
    }
    for (int e = 0; e < E; ++e) {
      const float w = to_f<T>(w3[size_t(e) * Cout + o]);
#pragma unroll
      for (int k = 0; k < kPixelsPerThread; ++k) acc[k] = fmaf(to_f<T>(ds[row[k] + e]), w, acc[k]);
    }
    const float bias = to_f<T>(b3[o]);
#pragma unroll
    for (int k = 0; k < kPixelsPerThread; ++k) {
      const int p = p0 + k;
      if (p >= n_tile) break;
      const int ty = p / tw, tx = p - ty * tw;
      const int gy = y0 + ty, gx = x0 + tx;
      if (gy >= H || gx >= W) continue;
      float v = to_f<T>(from_f<T>(acc[k] + bias));
      if (residual) v += to_f<T>(xs[(size_t(ty + 1) * wp + tx + 1) * Cin + o]);
      out[(img + size_t(gy) * W + gx) * Cout + o] = from_f<T>(v);
    }
  }
}

// Candidate tiles, largest first; the first that fits shared memory wins.
constexpr int kTiles[][2] = {{8, 16}, {8, 8}, {4, 8}, {4, 4}, {2, 4}, {2, 2}, {1, 2}, {1, 1}};

// Picks the tile for (Cin, E, element size) on the current device.
cudaError_t pick_tile(int cin, int e, size_t elem, int* th, int* tw, size_t* smem) {
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  for (const auto& t : kTiles) {
    *smem = smem_bytes(t[0], t[1], cin, e, elem);
    if (*smem <= size_t(smem_max)) {
      *th = t[0];
      *tw = t[1];
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidConfiguration;
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* wd, const void* b2,
           const void* w3, const void* b3, void* out, int B, int H, int W, int Cin, int E,
           int Cout, int residual, cudaStream_t stream) {
  int th = 0, tw = 0;
  size_t smem = 0;
  cudaError_t err = pick_tile(Cin, E, sizeof(T), &th, &tw, &smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mbconv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(((H + th - 1) / th) * ((W + tw - 1) / tw), B);
  mbconv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(wd), static_cast<const T*>(b2), static_cast<const T*>(w3),
      static_cast<const T*>(b3), static_cast<T*>(out), H, W, Cin, E, Cout, th, tw, residual);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int fused_mbconv_launch(int dtype, const void* x, const void* w1, const void* b1,
                                   const void* wd, const void* b2, const void* w3,
                                   const void* b3, void* out, int B, int H, int W, int Cin,
                                   int E, int Cout, int residual, void* stream) {
  if (B > 65535) return cudaErrorInvalidValue;  // gridDim.y limit
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w1, b1, wd, b2, w3, b3, out, B, H, W, Cin, E, Cout, residual, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w1, b1, wd, b2, w3, b3, out, B, H, W, Cin, E, Cout,
                                 residual, s);
  return cudaErrorInvalidValue;
}

// The tile the launcher picks for (dtype, Cin, E), for reports.  Returns a
// cudaError_t (0 on success).
extern "C" int fused_mbconv_tile(int dtype, int Cin, int E, int* th, int* tw) {
  size_t smem = 0;
  return pick_tile(Cin, E, dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16), th, tw, &smem);
}

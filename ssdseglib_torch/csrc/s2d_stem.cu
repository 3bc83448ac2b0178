// Fused MobileNetV2 stem + first inverted-residual block for Hopper (sm_90a).
//
// Replaces ssdseglib_tpu/ops/s2d_stem.py::_stem_block1_kernel (the Pallas TPU
// kernel).  With BN already folded into weights + bias, on an image in
// [-1, 1]:
//
//     e  = relu6(round(conv3x3_s2(x)  + b1))    stem         3 -> 32, H/2 x W/2
//     d  = relu6(round(dw3x3_s1(e)    + bd1))   depthwise   32
//     p  =       round(d @ wp1        + bp1)    project     32 -> 16
//     e2 = relu6(round(p @ w2         + b2))    expand      16 -> 96
//     d2 = relu6(round(dw3x3_s2(e2)   + bd2))   depthwise   96,      H/4 x W/4
//     y  =       round(d2 @ wp2       + bp2)    project     96 -> 24
//
// with f32 accumulation and rounding to the I/O dtype at the same six points
// as the TPU kernel.  SAME padding at stride 2 on an even size is asymmetric
// (0 before, 1 after): output (r, c) of either stride-2 conv reads rows
// 2r .. 2r+2.  The stride-1 depthwise pads 1 and 1.  Outside the image an
// intermediate is the next conv's zero padding, so e, p and e2 are written as
// 0 there and not as relu6(bias).
//
// The TPU kernel's space-to-depth re-indexing, its packing of four images into
// 128 lanes and its row tiles answer the TPU's lane width and are not carried
// over: this kernel reads plain NHWC images.
//
// What bounds it on the H100: only the image (3 channels) and the output (24
// channels at 1/16 of the pixels) have to cross HBM; the five intermediates
// are up to 32 times the image's bytes.  One CTA owns one image and one
// kTO x kTW output tile and keeps every intermediate of that tile in shared
// memory, recomputing the halos the two 3x3 stencils and the stride-2 taps
// need: p, d and e2 on (2 kTO + 1) x (2 kTW + 1), e on (2 kTO + 3) x
// (2 kTW + 3), the image on (4 kTO + 7) x (4 kTW + 7).  The intermediates
// alternate between two buffers (image, d, e2 in one; e, p, d2 in the other),
// sized by the 96-channel e2 tile and the 32-channel e tile: 82 KB in bf16,
// 163 KB in f32.  The channel plan is fixed, and the block has 384 threads
// because 32, 16, 96 and 24 all divide it: in every stage a thread keeps one
// output channel and holds that channel's weights in registers while it walks
// over the tile's pixels, reading a pixel's input channels from shared memory
// eight at a time (one 16-byte load in bf16).  Only the last product, 96 -> 24,
// streams its weights instead: 96 of them in registers would leave room for
// one CTA an SM, and two (the bf16 tile allows it) hide the latencies between
// the seven barriers.  The products run on the CUDA cores; moving them to the
// tensor cores is later work.  Ragged edge tiles are predicated.
//
// Layout: x (B, H, W, 3) and out (B, H/4, W/4, 24) NHWC contiguous, H and W
// multiples of 4; w1 (27, 32) with rows ordered (dy, dx, cin); wd1 (9, 32) and
// wd2 (9, 96) taps row-major; wp1 (32, 16), w2 (16, 96), wp2 (96, 24); biases
// (C,); all in the I/O dtype (float32 or bfloat16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 384;
constexpr int kTO = 4, kTW = 16;                      // output tile at H/4 x W/4
constexpr int kIH = 4 * kTO + 7, kIW = 4 * kTW + 7;   // image tile
constexpr int kEH = 2 * kTO + 3, kEW = 2 * kTW + 3;   // e tile at H/2 x W/2
constexpr int kPH = 2 * kTO + 1, kPW = 2 * kTW + 1;   // d, p, e2 tile at H/2 x W/2
constexpr int kC0 = 3, kC1 = 32, kC2 = 16, kC3 = 96, kC4 = 24;

constexpr int cmax(int a, int b) { return a > b ? a : b; }
// elements of the two buffers: {image, d, e2} and {e, p, d2}
constexpr int kBufX = cmax(kIH * kIW * kC0, cmax(kPH * kPW * kC1, kPH * kPW * kC3));
constexpr int kBufY = cmax(kEH * kEW * kC1, cmax(kPH * kPW * kC2, kTO * kTW * kC3));

static_assert(kBufX % 8 == 0 && kC1 % 8 == 0 && kC2 % 8 == 0 && kC3 % 8 == 0,
              "16-byte loads of eight channels from either buffer");
static_assert(kThreads % kC1 == 0 && kThreads % kC2 == 0 && kThreads % kC3 == 0 &&
                  kThreads % kC4 == 0,
              "a thread keeps one output channel through a stage");

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

// Eight consecutive activations from shared memory as floats, in one 16-byte
// (bf16) or two 16-byte (f32) loads; `p` is aligned to that.
template <typename T> __device__ __forceinline__ void load8(const T* p, float (&v)[8]);
template <> __device__ __forceinline__ void load8<float>(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

// dst[pos, o] = round(act[pos, :] @ w[:, o] + bias[o]) (-> relu6) for the
// thread's channel o, over the kPH x kPW tile whose origin at H/2 x W/2 is
// (r0, c0); a pixel at or beyond (rows, cols) is written as 0.
template <typename T, int CIN, int COUT, bool RELU6>
__device__ __forceinline__ void pointwise_stage(const T* __restrict__ act, T* __restrict__ dst,
                                                const T* __restrict__ w,
                                                const T* __restrict__ bias, int r0, int c0,
                                                int rows, int cols) {
  static_assert(CIN % 8 == 0, "channels are read eight at a time");
  const int o = threadIdx.x % COUT;
  float wr[CIN];
#pragma unroll
  for (int c = 0; c < CIN; ++c) wr[c] = to_f<T>(w[c * COUT + o]);
  const float b = to_f<T>(bias[o]);
  for (int pos = threadIdx.x / COUT; pos < kPH * kPW; pos += kThreads / COUT) {
    const int ly = pos / kPW, lx = pos - ly * kPW;
    T v = from_f<T>(0.0f);
    if (r0 + ly < rows && c0 + lx < cols) {
      float acc = 0.0f;
#pragma unroll
      for (int cb = 0; cb < CIN; cb += 8) {
        float a[8];
        load8<T>(act + pos * CIN + cb, a);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc = fmaf(a[i], wr[cb + i], acc);
      }
      v = RELU6 ? round_relu6<T>(acc + b) : from_f<T>(acc + b);
    }
    dst[pos * COUT + o] = v;
  }
}

// dst[pos, ch] = relu6(round(3x3 taps of src, in row-major order, + bias)) for
// the thread's channel, over an OH x OW tile read at STRIDE from a tile of
// width SW whose pixel (0, 0) is output (0, 0)'s first tap.
template <typename T, int C, int OH, int OW, int SW, int STRIDE>
__device__ __forceinline__ void depthwise_stage(const T* __restrict__ src, T* __restrict__ dst,
                                                const T* __restrict__ taps,
                                                const T* __restrict__ bias) {
  const int ch = threadIdx.x % C;
  float k[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) k[t] = to_f<T>(taps[t * C + ch]);
  const float b = to_f<T>(bias[ch]);
  for (int pos = threadIdx.x / C; pos < OH * OW; pos += kThreads / C) {
    const int ly = pos / OW, lx = pos - ly * OW;
    const T* window = src + (STRIDE * ly * SW + STRIDE * lx) * C + ch;
    float acc = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        acc = fmaf(to_f<T>(window[(dy * SW + dx) * C]), k[dy * 3 + dx], acc);
    dst[pos * C + ch] = round_relu6<T>(acc + b);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)  // two CTAs an SM in bf16 (82 KB each)
stem_block1_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
                   const T* __restrict__ wd1, const T* __restrict__ bd1,
                   const T* __restrict__ wp1, const T* __restrict__ bp1,
                   const T* __restrict__ w2, const T* __restrict__ b2,
                   const T* __restrict__ wd2, const T* __restrict__ bd2,
                   const T* __restrict__ wp2, const T* __restrict__ bp2, T* __restrict__ out,
                   int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* bx = reinterpret_cast<T*>(smem);  // image, then d, then e2
  T* by = bx + kBufX;                  // e, then p, then d2

  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  const int tiles_w = (W4 + kTW - 1) / kTW;
  const int oy0 = (blockIdx.x / tiles_w) * kTO, ox0 = (blockIdx.x % tiles_w) * kTW;
  const int r0 = 2 * oy0, c0 = 2 * ox0;  // origin of the d / p / e2 tile at H/2 x W/2
  const size_t image = blockIdx.y;
  const int tid = threadIdx.x;

  // 0. the image on the tile + halo, origin (2 r0 - 2, 2 c0 - 2), zero outside.
  {
    const T* src = x + image * H * W * kC0;
    for (int i = tid; i < kIH * kIW * kC0; i += kThreads) {
      const int pix = i / kC0, ch = i - pix * kC0;
      const int ly = pix / kIW, lx = pix - ly * kIW;
      const int gy = 2 * r0 - 2 + ly, gx = 2 * c0 - 2 + lx;
      T v = from_f<T>(0.0f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = src[(size_t(gy) * W + gx) * kC0 + ch];
      bx[i] = v;
    }
  }
  __syncthreads();

  // 1. stem conv 3x3 stride 2 + bias -> round -> relu6, origin (r0 - 1, c0 - 1):
  //    e(r, c) reads image rows 2r .. 2r+2, local rows 2 ly .. 2 ly + 2.
  {
    const int ch = tid % kC1;
    float wr[27];
#pragma unroll
    for (int k = 0; k < 27; ++k) wr[k] = to_f<T>(w1[k * kC1 + ch]);
    const float b = to_f<T>(b1[ch]);
    for (int pos = tid / kC1; pos < kEH * kEW; pos += kThreads / kC1) {
      const int ly = pos / kEW, lx = pos - ly * kEW;
      const int r = r0 - 1 + ly, c = c0 - 1 + lx;
      T v = from_f<T>(0.0f);
      if (r >= 0 && r < H2 && c >= 0 && c < W2) {
        const T* window = bx + (2 * ly * kIW + 2 * lx) * kC0;
        float acc = 0.0f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int k = 0; k < 3 * kC0; ++k)  // (dx, cin) is one contiguous run
            acc = fmaf(to_f<T>(window[dy * kIW * kC0 + k]), wr[dy * 3 * kC0 + k], acc);
        v = round_relu6<T>(acc + b);
      }
      by[pos * kC1 + ch] = v;
    }
  }
  __syncthreads();

  // 2. depthwise 3x3 stride 1 (taps in row-major order) + bias -> round -> relu6,
  //    origin (r0, c0): d(r, c) reads e rows r-1 .. r+1, local rows ly .. ly + 2.
  depthwise_stage<T, kC1, kPH, kPW, kEW, 1>(by, bx, wd1, bd1);
  __syncthreads();

  // 3. project 32 -> 16 + bias -> round; 0 outside the image.
  pointwise_stage<T, kC1, kC2, false>(bx, by, wp1, bp1, r0, c0, H2, W2);
  __syncthreads();

  // 4. block-1 expand 16 -> 96 + bias -> round -> relu6; 0 outside the image.
  pointwise_stage<T, kC2, kC3, true>(by, bx, w2, b2, r0, c0, H2, W2);
  __syncthreads();

  // 5. depthwise 3x3 stride 2 + bias -> round -> relu6 on the output tile:
  //    d2(oy, ox) reads e2 rows 2 oy .. 2 oy + 2 of the tile.
  depthwise_stage<T, kC3, kTO, kTW, kPW, 2>(bx, by, wd2, bd2);
  __syncthreads();

  // 6. project 96 -> 24 + bias -> round, to device memory.  A thread keeps one
  //    output channel and kPix neighbouring pixels, so the 96 weights of its
  //    channel stream through registers eight at a time, each feeding kPix
  //    independent sums, instead of occupying 96 registers.
  {
    constexpr int kPix = 4;
    static_assert(kTO * kTW * kC4 == kThreads * kPix && kTW % kPix == 0,
                  "one pass: every thread owns kPix pixels of one tile row");
    const int o = tid % kC4, pos0 = (tid / kC4) * kPix;
    float acc[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int cb = 0; cb < kC3; cb += 8) {
      float wv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) wv[i] = to_f<T>(wp2[(cb + i) * kC4 + o]);
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        float a[8];
        load8<T>(by + (pos0 + j) * kC3 + cb, a);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[j] = fmaf(a[i], wv[i], acc[j]);
      }
    }
    const float b = to_f<T>(bp2[o]);
    T* dst = out + image * H4 * W4 * kC4;
    const int oy = oy0 + pos0 / kTW;
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int ox = ox0 + pos0 % kTW + j;
      if (oy < H4 && ox < W4) dst[(size_t(oy) * W4 + ox) * kC4 + o] = from_f<T>(acc[j] + b);
    }
  }
}

template <typename T>
int launch(const void* const* p, void* out, int B, int H, int W, cudaStream_t stream) {
  const size_t smem = size_t(kBufX + kBufY) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      stem_block1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int H4 = H / 4, W4 = W / 4;
  const dim3 grid(((H4 + kTO - 1) / kTO) * ((W4 + kTW - 1) / kTW), B);
  auto a = [&](int i) { return static_cast<const T*>(p[i]); };
  stem_block1_kernel<T><<<grid, kThreads, smem, stream>>>(
      a(0), a(1), a(2), a(3), a(4), a(5), a(6), a(7), a(8), a(9), a(10), a(11), a(12),
      static_cast<T*>(out), H, W);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int stem_block1_launch(int dtype, const void* x, const void* w1, const void* b1,
                                  const void* wd1, const void* bd1, const void* wp1,
                                  const void* bp1, const void* w2, const void* b2,
                                  const void* wd2, const void* bd2, const void* wp2,
                                  const void* bp2, void* out, int B, int H, int W,
                                  void* stream) {
  if (B < 1 || B > 65535 || H < 4 || W < 4 || H % 4 != 0 || W % 4 != 0)
    return cudaErrorInvalidValue;  // gridDim.y limit; the stride-2 padding rule
  const void* p[13] = {x, w1, b1, wd1, bd1, wp1, bp1, w2, b2, wd2, bd2, wp2, bp2};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, out, B, H, W, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, out, B, H, W, s);
  return cudaErrorInvalidValue;
}

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
// are up to 32 times the image's bytes and stay on chip.  One CTA owns one
// image and one output tile at H/4 and recomputes the halos the two 3x3
// stencils and the stride-2 taps need: with a to x tw output tile, d, p and e2
// on (2 to + 1) x (2 tw + 1) pixels, e on (2 to + 3) x (2 tw + 3), the image
// on (4 to + 7) x (4 tw + 7).  Per CTA the work is 1.1 M multiply-adds of
// matrix products (88%) against 0.16 M of depthwise taps, so the products
// decide the time once the halos are small.
//
// bfloat16, the serving dtype (`stem_block1_bf16_kernel`): all four products
// on the tensor cores (mma.sync m16n8k16 bf16 -> f32, B operands by
// ldmatrix.trans from the row-major weights):
//   0. the six convs' weights (6368 values) and the image tile arrive by
//      cp.async, 16 bytes a copy, into row strides padded to an odd number of
//      16-byte units.  An image row of the tile is one contiguous run of
//      (4 tw + 7) x 3 values that starts 12 bytes off a 16-byte boundary, so
//      the copies start at the boundary below and a per-row shift (0 or 4
//      values apart from row to row) locates the tile in shared memory;
//      copies outside the image's memory are zero-filled and the pixels left
//      or right of the image zeroed after;
//   1. the stem conv as an implicit GEMM: M = the e tile's pixels (padded to
//      16), K = 27 (dy, dx, cin) padded to 32 with zeros in both operands,
//      N = 32.  The A operand is an im2col gather whose rows start 12 bytes
//      apart, so ldmatrix cannot read it from the image tile: each lane
//      builds its fragment registers from 2-byte reads of the image tile, the
//      offsets of its eight k values computed once (an A/B on the H100 against
//      a 16 x 32 im2col slab per warp in shared memory read by ldmatrix:
//      PERF.md);
//   2. the stride-1 depthwise on the CUDA cores in f32, two channels a thread;
//   3. the 32 -> 16 project (M = the d tile's pixels, K = 32, N = 16);
//   4. block 1's 96 channels in chunks of ec: the 16 -> ec expand on the
//      tensor cores, the stride-2 depthwise on the CUDA cores, and the
//      ec -> 24 partial of the project, accumulated over the chunks in f32
//      registers (16 output pixels x 24 channels a warp and m-tile), so shared
//      memory holds one chunk of e2 and not all 96 channels;
//   5. bias, round, and 16-byte stores of the output tile.
// Shared memory is three regions: the weights; {image tile, d, e2 chunk,
// output tile}; {e, then p and the d2 chunk}.
// Products sum in the tensor cores' order, not the plain version's, so bf16
// results may differ from it by a rounding at any of the six points.  The
// tile, the chunk and the warps are runtime arguments
// (`stem_config` holds the choice of an A/B on the H100, PERF.md).
//
// float32 (`stem_block1_kernel<float>`) keeps the CUDA-core design: a 4 x 16
// output tile, every intermediate of the tile in two alternating buffers
// (163 KB), 384 threads, one output channel a thread per stage, the products
// as scalar FMAs.
//
// Layout: x (B, H, W, 3) and out (B, H/4, W/4, 24) NHWC contiguous, H and W
// multiples of 4; w1 (27, 32) with rows ordered (dy, dx, cin); wd1 (9, 32) and
// wd2 (9, 96) taps row-major; wp1 (32, 16), w2 (16, 96), wp2 (96, 24); biases
// (C,); all in the I/O dtype (float32 or bfloat16), 16-byte aligned in bf16.

#include "common.cuh"

namespace {

using ssdseg::from_f;
using ssdseg::to_f;

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------

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
__global__ void __launch_bounds__(kThreads, 2)
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


cudaError_t launch_f32(const void* const* p, void* out, int B, int H, int W,
                       cudaStream_t stream) {
  const size_t smem = size_t(kBufX + kBufY) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stem_block1_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  if (B > 65535) return cudaErrorInvalidValue;  // gridDim.y limit
  const int H4 = H / 4, W4 = W / 4;
  const dim3 grid(((H4 + kTO - 1) / kTO) * ((W4 + kTW - 1) / kTW), B);
  auto a = [&](int i) { return static_cast<const float*>(p[i]); };
  stem_block1_kernel<float><<<grid, kThreads, smem, stream>>>(
      a(0), a(1), a(2), a(3), a(4), a(5), a(6), a(7), a(8), a(9), a(10), a(11), a(12),
      static_cast<float*>(out), H, W);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: the four products on the tensor cores, block 1's 96 channels in
// chunks
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using ssdseg::cp_async16;
using ssdseg::cp_async_commit;
using ssdseg::cp_async_wait;
using ssdseg::ldsm_x2_trans;
using ssdseg::ldsm_x4;
using ssdseg::ldsm_x4_trans;
using ssdseg::mma_16816;
using ssdseg::padded_ld;
using ssdseg::round_up;

// The weights in shared memory (bf16 elements): the four matrices in padded
// row strides (w1's rows 27..31 zero), then the taps and biases dense.
constexpr int kLdW1 = padded_ld(kC1), kLdWp1 = padded_ld(kC2), kLdW2 = padded_ld(kC3),
              kLdWp2 = padded_ld(kC4);
constexpr int kOffW1 = 0, kOffWp1 = kOffW1 + 32 * kLdW1, kOffW2 = kOffWp1 + kC1 * kLdWp1,
              kOffWp2 = kOffW2 + kC2 * kLdW2, kOffWd1 = kOffWp2 + kC3 * kLdWp2,
              kOffWd2 = kOffWd1 + 9 * kC1, kOffB1 = kOffWd2 + 9 * kC3, kOffBd1 = kOffB1 + kC1,
              kOffBp1 = kOffBd1 + kC1, kOffB2 = kOffBp1 + kC2, kOffBd2 = kOffB2 + kC3,
              kOffBp2 = kOffBd2 + kC3, kWeightElems = kOffBp2 + kC4;
static_assert(kOffWd1 % 8 == 0 && kOffB1 % 8 == 0 && kOffB2 % 8 == 0 && kOffBp2 % 8 == 0,
              "every weight row starts on a 16-byte boundary");
// row strides of the tiles an ldmatrix reads: d (32 channels), p (16)
constexpr int kLdD = padded_ld(kC1), kLdP = padded_ld(kC2);
constexpr int kMaxWarps = 16;

struct StemConfig {
  int to, tw;  // output tile at H/4
  int ec;      // chunk of block 1's 96 channels
  int warps;
};

// The choice of an A/B on the H100 (PERF.md, `chip_smoke.py --stem-variants`).
constexpr StemConfig kStemConfig = {15, 16, 48, 16};

// Everything the bf16 kernel derives from (shape, config).  Built on the host.
struct StemGeo {
  int H, W, H2, W2, H4, W4;
  int to, tw, ec, chunks, warps;
  int tiles_w, tiles_h;
  int ih, iw, is;  // image tile rows, columns (pixels) and row stride (elements)
  int ew, ne, me;  // e tile: columns, pixels, 16-row m-tiles
  int pw, np, mp;  // d / p / e2 tile: columns, pixels, m-tiles
  int nt, mt;      // output tile: pixels, m-tiles
  int ld_d2;       // row stride of the d2 chunk
  int off_r1, off_r2, off_d2, smem;  // byte offsets, total bytes
};

bool make_stem_geo(int H, int W, StemConfig c, int smem_max, StemGeo* g) {
  if (c.to < 1 || c.tw < 1 || c.ec < 16 || c.ec % 16 || kC3 % c.ec ||
      (c.warps != 4 && c.warps != 8 && c.warps != 16))
    return false;
  g->H = H, g->W = W, g->H2 = H / 2, g->W2 = W / 2, g->H4 = H / 4, g->W4 = W / 4;
  g->to = c.to, g->tw = c.tw, g->ec = c.ec, g->chunks = kC3 / c.ec;
  g->warps = c.warps;
  g->tiles_w = (g->W4 + c.tw - 1) / c.tw;
  g->tiles_h = (g->H4 + c.to - 1) / c.to;
  g->ih = 4 * c.to + 7, g->iw = 4 * c.tw + 7;
  g->is = round_up(g->iw * kC0 + 7, 8);
  g->ew = 2 * c.tw + 3;
  g->ne = (2 * c.to + 3) * g->ew;
  g->me = round_up(g->ne, 16) / 16;
  g->pw = 2 * c.tw + 1;
  g->np = (2 * c.to + 1) * g->pw;
  g->mp = round_up(g->np, 16) / 16;
  g->nt = c.to * c.tw;
  g->mt = round_up(g->nt, 16) / 16;
  if (g->mt > 4 * c.warps) return false;  // at most four m-tiles of the project a warp
  g->ld_d2 = padded_ld(c.ec);
  const int b = int(sizeof(bf16));
  int r1 = g->ih * g->is * b;                                      // image tile
  r1 = r1 > g->mp * 16 * kLdD * b ? r1 : g->mp * 16 * kLdD * b;  // d
  r1 = r1 > g->np * c.ec * b ? r1 : g->np * c.ec * b;              // e2 chunk
  r1 = r1 > g->nt * kC4 * b ? r1 : g->nt * kC4 * b;                // output tile
  const int p_bytes = round_up(g->mp * 16 * kLdP * b, 128);
  int r2 = p_bytes + g->mt * 16 * g->ld_d2 * b;                     // p, d2 chunk
  r2 = r2 > g->ne * kC1 * b ? r2 : g->ne * kC1 * b;                // e
  g->off_r1 = round_up(kWeightElems * b, 128);
  g->off_r2 = g->off_r1 + round_up(r1, 128);
  g->off_d2 = g->off_r2 + p_bytes;
  g->smem = g->off_r2 + round_up(r2, 128);
  return g->smem <= smem_max;
}

// Starts the copies of a row-major (rows, cols) matrix into shared rows of
// `ld` elements, 16 bytes a copy.
__device__ __forceinline__ void stage_matrix(bf16* dst, int ld, const bf16* __restrict__ src,
                                             int rows, int cols) {
  const int vecs = cols / 8;
  for (int v = threadIdx.x; v < rows * vecs; v += blockDim.x) {
    const int r = v / vecs, cv = v - r * vecs;
    cp_async16(dst + r * ld + cv * 8, src + r * cols + cv * 8, true);
  }
}

__device__ __forceinline__ unsigned pack_bf16(unsigned short lo, unsigned short hi) {
  return unsigned(lo) | (unsigned(hi) << 16);
}

// (v0, v1) rounded to bf16, then clamped to [0, 6] (exact in bf16).
__device__ __forceinline__ __nv_bfloat162 relu6_pair(float v0, float v1) {
  return __hmin2(__hmax2(__floats2bfloat162_rn(v0, v1), __float2bfloat162_rn(0.0f)),
                 __float2bfloat162_rn(6.0f));
}

// One 16-deep step of a product on the tensor cores, added to `acc` on the
// CUDA cores: the tensor core sums the step's 16 products into a zero
// accumulator, and the steps meet in f32 adds in k order, so the plain
// version can take the same order (`fused_stem_block1_reference(...,
// k_groups=True)`).
__device__ __forceinline__ void mma_step(float (&acc)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_16816(d, a, b0, b1);
#pragma unroll
  for (int v = 0; v < 4; ++v) acc[v] += d[v];
}

template <int MTW>
__global__ void __launch_bounds__(kMaxWarps * 32)
stem_block1_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                        const bf16* __restrict__ b1, const bf16* __restrict__ wd1,
                        const bf16* __restrict__ bd1, const bf16* __restrict__ wp1,
                        const bf16* __restrict__ bp1, const bf16* __restrict__ w2,
                        const bf16* __restrict__ b2, const bf16* __restrict__ wd2,
                        const bf16* __restrict__ bd2, const bf16* __restrict__ wp2,
                        const bf16* __restrict__ bp2, bf16* __restrict__ out, const StemGeo g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nthreads = blockDim.x;
  const int q = lane & 3;
  bf16* ws = reinterpret_cast<bf16*>(smem);                // the weights
  bf16* img = reinterpret_cast<bf16*>(smem + g.off_r1);    // image tile, then d, e2, output
  bf16* ds = img;
  bf16* e2s = img;
  bf16* os = img;
  bf16* es = reinterpret_cast<bf16*>(smem + g.off_r2);     // e, then p
  bf16* ps = es;
  bf16* d2s = reinterpret_cast<bf16*>(smem + g.off_d2);    // d2 chunk (past p)
  const unsigned short* im16 = reinterpret_cast<const unsigned short*>(img);
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.0f, 0.0f);

  const int oy0 = (blockIdx.x / g.tiles_w) * g.to, ox0 = (blockIdx.x % g.tiles_w) * g.tw;
  const int r0 = 2 * oy0, c0 = 2 * ox0;  // origin of the d / p / e2 tile at H/2 x W/2
  const size_t image = blockIdx.y;

  // 0. the weights and the image tile (origin (4 oy0 - 2, 4 ox0 - 2)): one
  //    group of asynchronous copies.  Row l of the tile starts `shift(l)`
  //    values into its shared row.
  stage_matrix(ws + kOffW1, kLdW1, w1, 27, kC1);
  stage_matrix(ws + kOffWp1, kLdWp1, wp1, kC1, kC2);
  stage_matrix(ws + kOffW2, kLdW2, w2, kC2, kC3);
  stage_matrix(ws + kOffWp2, kLdWp2, wp2, kC3, kC4);
  stage_matrix(ws + kOffWd1, 9 * kC1, wd1, 1, 9 * kC1);
  stage_matrix(ws + kOffWd2, 9 * kC3, wd2, 1, 9 * kC3);
  stage_matrix(ws + kOffB1, kC1, b1, 1, kC1);
  stage_matrix(ws + kOffBd1, kC1, bd1, 1, kC1);
  stage_matrix(ws + kOffBp1, kC2, bp1, 1, kC2);
  stage_matrix(ws + kOffB2, kC3, b2, 1, kC3);
  stage_matrix(ws + kOffBd2, kC3, bd2, 1, kC3);
  stage_matrix(ws + kOffBp2, kC4, bp2, 1, kC4);
  const int gy0 = 4 * oy0 - 2, gx0 = 4 * ox0 - 2;
  const long long plane = (long long)g.H * g.W * kC0;
  const bf16* src = x + image * plane;
  const int w3 = (g.W * kC0) & 7;  // 0 or 4: how the shift moves from row to row
  const int s0 = int(((long long)gy0 * g.W + gx0) * kC0 & 7);
  {
    const int vpr = g.is / 8;
    for (int v = tid; v < g.ih * vpr; v += nthreads) {
      const int l = v / vpr, j = v - l * vpr;
      const int gy = gy0 + l;
      const long long e0 = ((long long)gy * g.W + gx0) * kC0;
      const long long a = e0 - (e0 & 7) + 8 * j;
      const bool inside = gy >= 0 && gy < g.H && a >= 0 && a + 8 <= plane;
      cp_async16(img + l * g.is + 8 * j, inside ? src + a : src, inside);
    }
  }
  cp_async_commit();
  for (int i = tid; i < 5 * kC1; i += nthreads)  // w1's rows 27..31: K padded with zeros
    ws[kOffW1 + (27 + i / kC1) * kLdW1 + i % kC1] = __float2bfloat16_rn(0.0f);
  cp_async_wait<0>();
  __syncthreads();
  if (gx0 < 0 || gx0 + g.iw > g.W) {  // a tile at the left or right edge: zero what lies outside
    for (int i = tid; i < g.ih * g.iw; i += nthreads) {
      const int l = i / g.iw, lx = i - l * g.iw;
      const int gx = gx0 + lx;
      if (gx >= 0 && gx < g.W) continue;
      bf16* px = img + l * g.is + ((s0 + l * w3) & 7) + lx * kC0;
#pragma unroll
      for (int c = 0; c < kC0; ++c) px[c] = __float2bfloat16_rn(0.0f);
    }
    __syncthreads();
  }

  // 1. stem conv on the tensor cores, origin (r0 - 1, c0 - 1): e(ly, lx) reads
  //    image rows 2 ly .. 2 ly + 2 of the tile.  K index k = 9 dy + 3 dx + cin.
  {
    unsigned b[2][4][2];  // w1 as 2 k-groups x 4 n-tiles, for the whole stage
#pragma unroll
    for (int kg = 0; kg < 2; ++kg)
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned r[4];
        ldsm_x4_trans(r, ws + kOffW1 + (kg * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdW1 +
                             np * 16 + (lane >> 4) * 8);
        b[kg][2 * np][0] = r[0], b[kg][2 * np][1] = r[1];
        b[kg][2 * np + 1][0] = r[2], b[kg][2 * np + 1][1] = r[3];
      }
    // the lane's eight k values of a fragment (k-group 0: 2q, 2q+1, 2q+8,
    // 2q+9; k-group 1: 16 more) as offsets from a pixel's first tap
    int koff[8];
    bool kval[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = (i >> 2) * 16 + 2 * q + (i & 1) + ((i >> 1) & 1) * 8;
      const int dy = k / 9;
      kval[i] = k < 27;
      koff[i] = kval[i] ? dy * g.is + ((s0 + dy * w3) & 7) + (k - 9 * dy) : 0;
    }
    for (int m = warp; m < g.me; m += g.warps) {
      unsigned a[2][4];
      const int pa = min(m * 16 + (lane >> 2), g.ne - 1);
      const int pb = min(m * 16 + (lane >> 2) + 8, g.ne - 1);
      const int ya = pa / g.ew, yb = pb / g.ew;
      const int base_a = 2 * ya * g.is + 2 * kC0 * (pa - ya * g.ew);
      const int base_b = 2 * yb * g.is + 2 * kC0 * (pb - yb * g.ew);
      unsigned short va[8], vb[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        va[i] = kval[i] ? im16[base_a + koff[i]] : 0;
        vb[i] = kval[i] ? im16[base_b + koff[i]] : 0;
      }
#pragma unroll
      for (int kg = 0; kg < 2; ++kg) {
        a[kg][0] = pack_bf16(va[4 * kg], va[4 * kg + 1]);
        a[kg][1] = pack_bf16(vb[4 * kg], vb[4 * kg + 1]);
        a[kg][2] = pack_bf16(va[4 * kg + 2], va[4 * kg + 3]);
        a[kg][3] = pack_bf16(vb[4 * kg + 2], vb[4 * kg + 3]);
      }
      float d[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int v = 0; v < 4; ++v) d[nt][v] = 0.0f;
#pragma unroll
        for (int kg = 0; kg < 2; ++kg) mma_step(d[nt], a[kg], b[kg][nt][0], b[kg][nt][1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = m * 16 + (lane >> 2) + h * 8;
        if (p >= g.ne) continue;
        const int ly = p / g.ew, lx = p - ly * g.ew;
        const int r = r0 - 1 + ly, c = c0 - 1 + lx;
        const bool inside = r >= 0 && r < g.H2 && c >= 0 && c < g.W2;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = nt * 8 + 2 * q;
          const __nv_bfloat162 bias = *reinterpret_cast<const __nv_bfloat162*>(ws + kOffB1 + col);
          *reinterpret_cast<__nv_bfloat162*>(es + p * kC1 + col) =
              inside ? relu6_pair(d[nt][2 * h] + __low2float(bias),
                                  d[nt][2 * h + 1] + __high2float(bias))
                     : zero2;
        }
      }
    }
  }
  __syncthreads();

  // 2. depthwise 3x3 stride 1 (taps in row-major order) on the CUDA cores, two
  //    channels a thread, origin (r0, c0): d(ly, lx) reads e rows ly .. ly + 2.
  //    A thread walks down one column with the 3 x 3 window in registers, so
  //    a row costs three loads, not nine.  The padding rows up to the
  //    m-tiles' 16 are zero.
  {
    const int col = 2 * (tid & 15);
    float k0[9], k1[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const __nv_bfloat162 kk =
          *reinterpret_cast<const __nv_bfloat162*>(ws + kOffWd1 + t * kC1 + col);
      k0[t] = __low2float(kk), k1[t] = __high2float(kk);
    }
    const __nv_bfloat162 bias = *reinterpret_cast<const __nv_bfloat162*>(ws + kOffBd1 + col);
    const int ph = 2 * g.to + 1;
    for (int lx = tid >> 4; lx < g.pw; lx += nthreads >> 4) {
      const bf16* src = es + lx * kC1 + col;  // e row 0, column lx
      float2 w[3][3];                         // e rows ly .. ly + 2, columns lx .. lx + 2
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          w[r][dx] = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(src + (r * g.ew + dx) * kC1));
      for (int ly = 0; ly < ph; ++ly) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          w[2][dx] = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(src + ((ly + 2) * g.ew + dx) * kC1));
        float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            a0 = fmaf(w[dy][dx].x, k0[dy * 3 + dx], a0);
            a1 = fmaf(w[dy][dx].y, k1[dy * 3 + dx], a1);
          }
        *reinterpret_cast<__nv_bfloat162*>(ds + (ly * g.pw + lx) * kLdD + col) =
            relu6_pair(a0 + __low2float(bias), a1 + __high2float(bias));
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) w[0][dx] = w[1][dx], w[1][dx] = w[2][dx];
      }
    }
    for (int i = tid; i < (g.mp * 16 - g.np) * 16; i += nthreads)
      *reinterpret_cast<__nv_bfloat162*>(ds + (g.np + (i >> 4)) * kLdD + 2 * (i & 15)) = zero2;
  }
  __syncthreads();

  // 3. project 32 -> 16 + bias -> round on the tensor cores; 0 outside the
  //    image and on the padding rows.  e is dead: the d2 chunk's padding rows
  //    (past p, where e lay) are zeroed once.
  {
    for (int i = tid; i < (g.mt * 16 - g.nt) * (g.ec / 2); i += nthreads)
      *reinterpret_cast<__nv_bfloat162*>(d2s + (g.nt + i / (g.ec / 2)) * g.ld_d2 +
                                         2 * (i % (g.ec / 2))) = zero2;
    unsigned b[2][4];
#pragma unroll
    for (int kg = 0; kg < 2; ++kg)
      ldsm_x4_trans(b[kg], ws + kOffWp1 +
                               (kg * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdWp1 +
                               (lane >> 4) * 8);
    for (int m = warp; m < g.mp; m += g.warps) {
      unsigned a[2][4];
#pragma unroll
      for (int kg = 0; kg < 2; ++kg)
        ldsm_x4(a[kg], ds + (m * 16 + (lane & 15)) * kLdD + kg * 16 + (lane >> 4) * 8);
      float d[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int kg = 0; kg < 2; ++kg) {
        mma_step(d[0], a[kg], b[kg][0], b[kg][1]);
        mma_step(d[1], a[kg], b[kg][2], b[kg][3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = m * 16 + (lane >> 2) + h * 8;
        const int ly = p / g.pw, lx = p - ly * g.pw;
        const bool inside = p < g.np && r0 + ly < g.H2 && c0 + lx < g.W2;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = nt * 8 + 2 * q;
          const __nv_bfloat162 bias = *reinterpret_cast<const __nv_bfloat162*>(ws + kOffBp1 + col);
          *reinterpret_cast<__nv_bfloat162*>(ps + p * kLdP + col) =
              inside ? __floats2bfloat162_rn(d[nt][2 * h] + __low2float(bias),
                                             d[nt][2 * h + 1] + __high2float(bias))
                     : zero2;
        }
      }
    }
  }
  __syncthreads();

  // 4. block 1, chunk by chunk of ec channels; the project's partial sums stay
  //    in registers: m-tiles warp, warp + warps, ... of the output tile.
  float acc[MTW][3][4];
#pragma unroll
  for (int j = 0; j < MTW; ++j)
#pragma unroll
    for (int nt = 0; nt < 3; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[j][nt][v] = 0.0f;
  for (int chunk = 0; chunk < g.chunks; ++chunk) {
    const int cb = chunk * g.ec;
    // 4a. expand 16 -> ec + bias -> round -> relu6 on the tensor cores; 0
    //     outside the image
    for (int m = warp; m < g.mp; m += g.warps) {
      unsigned a[4];
      ldsm_x4(a, ps + (m * 16 + (lane & 15)) * kLdP + (lane >> 4) * 8);
      int pr[2];
      bool inside[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = m * 16 + (lane >> 2) + h * 8;
        const int ly = p / g.pw, lx = p - ly * g.pw;
        pr[h] = p;
        inside[h] = p < g.np && r0 + ly < g.H2 && c0 + lx < g.W2;
      }
      for (int n0 = 0; n0 < g.ec; n0 += 16) {
        unsigned b[4];
        ldsm_x4_trans(b, ws + kOffW2 + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLdW2 + cb + n0 +
                             (lane >> 4) * 8);
        float d[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
        mma_16816(d[0], a, b[0], b[1]);
        mma_16816(d[1], a, b[2], b[3]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (pr[h] >= g.np) continue;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = n0 + j * 8 + 2 * q;
            const __nv_bfloat162 bias =
                *reinterpret_cast<const __nv_bfloat162*>(ws + kOffB2 + cb + col);
            *reinterpret_cast<__nv_bfloat162*>(e2s + pr[h] * g.ec + col) =
                inside[h] ? relu6_pair(d[j][2 * h] + __low2float(bias),
                                       d[j][2 * h + 1] + __high2float(bias))
                          : zero2;
          }
        }
      }
    }
    __syncthreads();

    // 4b. depthwise 3x3 stride 2 + bias -> round -> relu6 on the CUDA cores:
    //     d2(oy, ox) reads e2 rows 2 oy .. 2 oy + 2 of the tile.  A thread
    //     walks down one output column: row 2 oy + 2 is the next row's first.
    const int pairs = g.ec / 2;
    for (int i = tid; i < g.tw * pairs; i += nthreads) {
      const int ox = i / pairs, col = (i - ox * pairs) * 2;
      float k0[9], k1[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const __nv_bfloat162 kk =
            *reinterpret_cast<const __nv_bfloat162*>(ws + kOffWd2 + t * kC3 + cb + col);
        k0[t] = __low2float(kk), k1[t] = __high2float(kk);
      }
      const __nv_bfloat162 bias =
          *reinterpret_cast<const __nv_bfloat162*>(ws + kOffBd2 + cb + col);
      const bf16* src = e2s + 2 * ox * g.ec + col;  // e2 row 0, column 2 ox
      float2 w[3][3];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        w[0][dx] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + dx * g.ec));
      for (int oy = 0; oy < g.to; ++oy) {
#pragma unroll
        for (int r = 1; r < 3; ++r)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            w[r][dx] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                src + ((2 * oy + r) * g.pw + dx) * g.ec));
        float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            a0 = fmaf(w[dy][dx].x, k0[dy * 3 + dx], a0);
            a1 = fmaf(w[dy][dx].y, k1[dy * 3 + dx], a1);
          }
        *reinterpret_cast<__nv_bfloat162*>(d2s + (oy * g.tw + ox) * g.ld_d2 + col) =
            relu6_pair(a0 + __low2float(bias), a1 + __high2float(bias));
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) w[0][dx] = w[2][dx];
      }
    }
    __syncthreads();

    // 4c. the chunk's partial of the 96 -> 24 project, into the accumulators
    for (int k0 = 0; k0 < g.ec; k0 += 16) {
      const bf16* brow = ws + kOffWp2 + (cb + k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdWp2;
      unsigned b01[4], b2r[2];
      ldsm_x4_trans(b01, brow + (lane >> 4) * 8);
      ldsm_x2_trans(b2r, brow + 16);
#pragma unroll
      for (int j = 0; j < MTW; ++j) {
        const int m = warp + j * g.warps;
        if (m >= g.mt) break;
        unsigned a[4];
        ldsm_x4(a, d2s + (m * 16 + (lane & 15)) * g.ld_d2 + k0 + (lane >> 4) * 8);
        mma_step(acc[j][0], a, b01[0], b01[1]);
        mma_step(acc[j][1], a, b01[2], b01[3]);
        mma_step(acc[j][2], a, b2r[0], b2r[1]);
      }
    }
  }

  // 5. bias, round to bf16 into the output tile (the last e2 chunk is read) ...
#pragma unroll
  for (int j = 0; j < MTW; ++j) {
    const int m = warp + j * g.warps;
    if (m >= g.mt) break;
#pragma unroll
    for (int nt = 0; nt < 3; ++nt) {
      const int col = nt * 8 + 2 * q;
      const __nv_bfloat162 bias = *reinterpret_cast<const __nv_bfloat162*>(ws + kOffBp2 + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = m * 16 + (lane >> 2) + h * 8;
        if (p < g.nt)
          *reinterpret_cast<__nv_bfloat162*>(os + p * kC4 + col) = __floats2bfloat162_rn(
              acc[j][nt][2 * h] + __low2float(bias), acc[j][nt][2 * h + 1] + __high2float(bias));
      }
    }
  }
  __syncthreads();
  // ... then 16-byte stores
  bf16* dst = out + image * g.H4 * g.W4 * kC4;
  for (int v = tid; v < g.nt * (kC4 / 8); v += nthreads) {
    const int p = v / (kC4 / 8), cv = v - p * (kC4 / 8);
    const int oy = oy0 + p / g.tw, ox = ox0 + p % g.tw;
    if (oy < g.H4 && ox < g.W4)
      *reinterpret_cast<uint4*>(dst + (size_t(oy) * g.W4 + ox) * kC4 + cv * 8) =
          *reinterpret_cast<const uint4*>(os + p * kC4 + cv * 8);
  }
}

cudaError_t smem_optin(int* smem_max) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// The geometry for (shape, config); a config field of 0 takes kStemConfig's.
cudaError_t stem_geo(int H, int W, int to, int tw, int ec, int warps, StemGeo* g) {
  StemConfig c = kStemConfig;
  if (to > 0) c.to = to;
  if (tw > 0) c.tw = tw;
  if (ec > 0) c.ec = ec;
  if (warps > 0) c.warps = warps;
  int smem_max = 0;
  cudaError_t err = smem_optin(&smem_max);
  if (err != cudaSuccess) return err;
  return make_stem_geo(H, W, c, smem_max, g) ? cudaSuccess : cudaErrorInvalidValue;
}

template <int MTW>
cudaError_t launch_bf16_mtw(const void* const* p, void* out, int B, const StemGeo& g,
                            cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(stem_block1_bf16_kernel<MTW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(g.tiles_h * g.tiles_w, B);
  auto a = [&](int i) { return static_cast<const bf16*>(p[i]); };
  stem_block1_bf16_kernel<MTW><<<grid, g.warps * 32, g.smem, stream>>>(
      a(0), a(1), a(2), a(3), a(4), a(5), a(6), a(7), a(8), a(9), a(10), a(11), a(12),
      static_cast<bf16*>(out), g);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* const* p, void* out, int B, int H, int W, int to, int tw,
                        int ec, int warps, cudaStream_t stream) {
  StemGeo g;
  cudaError_t err = stem_geo(H, W, to, tw, ec, warps, &g);
  if (err != cudaSuccess) return err;
  if (B > 65535) return cudaErrorInvalidValue;  // gridDim.y limit
  switch ((g.mt + g.warps - 1) / g.warps) {  // the output tile's m-tiles a warp owns
    case 1: return launch_bf16_mtw<1>(p, out, B, g, stream);
    case 2: return launch_bf16_mtw<2>(p, out, B, g, stream);
    case 3: return launch_bf16_mtw<3>(p, out, B, g, stream);
    case 4: return launch_bf16_mtw<4>(p, out, B, g, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  to, tw, ec, warps: the bf16 kernel's
// output tile, chunk of block 1's channels and warps, 0 for the built-in
// choice (ignored in f32).  Returns a cudaError_t (0 on success).
extern "C" int stem_block1_launch(int dtype, const void* x, const void* w1, const void* b1,
                                  const void* wd1, const void* bd1, const void* wp1,
                                  const void* bp1, const void* w2, const void* b2,
                                  const void* wd2, const void* bd2, const void* wp2,
                                  const void* bp2, void* out, int B, int H, int W, int to,
                                  int tw, int ec, int warps, void* stream) {
  if (B < 1 || H < 4 || W < 4 || H % 4 != 0 || W % 4 != 0)
    return cudaErrorInvalidValue;  // the stride-2 padding rule
  const void* p[13] = {x, w1, b1, wd1, bd1, wp1, bp1, w2, b2, wd2, bd2, wp2, bp2};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(p, out, B, H, W, s);
  if (dtype == 1) return launch_bf16(p, out, B, H, W, to, tw, ec, warps, s);
  return cudaErrorInvalidValue;
}

// What the bf16 launcher picks for (H, W) and the given config (0: built-in),
// for reports: the output tile, the chunk, the warps and the bytes of
// dynamic shared memory.  Returns a cudaError_t (0 on success).
extern "C" int stem_block1_config(int H, int W, int* to, int* tw, int* ec, int* warps,
                                  int* smem) {
  StemGeo g;
  const cudaError_t err = stem_geo(H, W, *to, *tw, *ec, *warps, &g);
  if (err != cudaSuccess) return err;
  *to = g.to, *tw = g.tw, *ec = g.ec, *warps = g.warps;
  *smem = g.smem;
  return cudaSuccess;
}

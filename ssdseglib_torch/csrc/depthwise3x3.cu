// Depthwise 3x3 convolution of the folded serving forward for Hopper (sm_90a),
// with its padding, stride, dilation, bias and activation inside it.
//
// Replaces no Pallas kernel.  The JAX package leaves these convolutions to
// XLA, which fuses the padding, the bias and the activation into the
// convolution.  Eager PyTorch fuses none of it: cuDNN's grouped direct kernel
// runs the taps, `F.pad` copies the input of every stride-2 convolution on an
// even size (its SAME padding is 0 before and 1 after), and the bias add and
// the clamp are passes of their own.  On bf16 NHWC activations:
//
//     y[b, ho, wo, c] = act(bias[c] + sum_{i,j} k[c, i, j]
//                                     * x[b, ho s - pt + i d, wo s - pl + j d, c])
//
// x outside [0, H) x [0, W) reads as zero, so explicit pads (top, bottom,
// left, right) take the place of `F.pad`, and a row window of a split map
// (pads (0, 0, left, right)) runs unchanged.  act is one of four, by the
// launcher's code: 0 the identity and 1 clamp(0, cap), told apart by a
// warp-uniform flag in one instantiation (ACT 0), 2 max(0, y) and 3 the
// h-swish y min(max(y + 3, 0), 6) / 6, each an instantiation of its own
// (ACT 2, 3).  The h-swish multiplies by 1/6: a division's range check and
// slow-path branch on each value made its convs 2.1-3.2x slower on the H100
// at MobileNetV3-Large's b128 geometries (no spills either way).  Codes 0
// and 1 share the instantiation that MobileNetV2's convs ran before codes 2
// and 3 came: with all four as template cases, those convs read 2-11 %
// slower on the H100.  Products, sums and act in f32, rounded once to bf16.
//
// What bounds it on the H100: bytes.  It reads x and writes y once, against
// 18 operations an output element on the CUDA cores (at the serving path's
// b128 shapes: ~2.9 ms of bytes against ~0.5 ms of taps a forward).  So the
// design reads each input byte from device memory once and keeps many loads
// in flight:
//
// - a thread takes 8 channels (one 16-byte vector) of a TR x TW block of
//   outputs spaced d apart in both directions (d = 1 but for the atrous
//   convs); the outputs then share input rows and columns, whatever s and d:
//   output (i, j) of the block reads window row i s + ki and column j s + kj;
// - it walks down its TR output rows with the window's input rows in
//   registers as packed bf16, loading the s new rows of the next output row
//   before it computes this one; the nine taps and the bias stay in
//   registers as f32, and act is applied there before the store;
// - consecutive threads take consecutive vectors of one pixel, so every load
//   and store of a warp is whole 32-byte sectors; the columns that two
//   neighbouring blocks share come from L1 (`ld.global.nc`), the rows that
//   two neighbouring row groups share from L2, which they reach together;
// - no shared memory and no synchronisation: the bounds checks are the
//   padding.
//
// The block (TW, TR) is 4 x 4 at stride 1 and 2 x 4 at stride 2: the fastest
// of five a stride over the serving path's b128 shapes on the H100 (PERF.md).
//
// Layout: x (B, H, W, C) and y (B, Ho, Wo, C) NHWC contiguous bf16, 16-byte
// aligned, C a multiple of 8; taps k bf16, tap (i, j) of channel c at
// k[c kcs + i kis + j kjs] (a (C, 1, 3, 3) weight read in place); bias (C,)
// bf16 or null.

#include "common.cuh"

namespace {

using ssdseg::Vec;

constexpr int kThreads = 256;
constexpr int kV = 8;  // channels of a thread: one 16-byte vector of bf16

struct Dw3Geo {
  int H, W, C, Ho, Wo;
  int d, pt, pl;
  int cv;                      // vectors of a pixel: C / 8
  int col_groups, row_groups;  // blocks of TW columns, TR rows, spaced d
  long long items;             // B * row_groups * col_groups
  int kcs, kis, kjs;           // the taps' strides
  int has_cap;                 // ACT 0: clamp to [0, cap] (code 1)
  float cap;
};

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

template <int S, int TW, int TR, int ACT>
__global__ void __launch_bounds__(kThreads)
depthwise3x3_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                    const Dw3Geo g) {
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  const long long item = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (cv >= g.cv || item >= g.items) return;
  const int c = cv * kV;
  // item -> (image, row group, column group), columns fastest
  const int cg = int(item % g.col_groups);
  const long long rest = item / g.col_groups;
  const int rg = int(rest % g.row_groups);
  const int b = int(rest / g.row_groups);
  const int d = g.d;
  const int wo0 = cg / d * (TW * d) + cg % d;
  const int ho0 = rg / d * (TR * d) + rg % d;
  const int wi0 = wo0 * S - g.pl, hi0 = ho0 * S - g.pt;

  float kk[9][kV], bv[kV];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int p = 0; p < kV; ++p)
      kk[t][p] = __bfloat162float(k[(c + p) * g.kcs + (t / 3) * g.kis + (t % 3) * g.kjs]);
#pragma unroll
  for (int p = 0; p < kV; ++p) bv[p] = bias != nullptr ? __bfloat162float(bias[c + p]) : 0.0f;

  constexpr int NV = (TW - 1) * S + 3;  // input columns of the block
  constexpr int NR = (TR - 1) * S + 3;  // input rows of the block
  const size_t row_elems = size_t(g.W) * g.C;
  const __nv_bfloat16* xb = x + size_t(b) * g.H * row_elems + c;
  __nv_bfloat16* yb = y + size_t(b) * g.Ho * size_t(g.Wo) * g.C + c;
  int col[NV];
  bool col_in[NV];
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int wi = wi0 + u * d;
    col_in[u] = unsigned(wi) < unsigned(g.W);
    col[u] = col_in[u] ? wi * g.C : 0;
  }
  uint4 win[NR][NV];
  auto load_row = [&](int v) {
    const int hi = hi0 + v * d;
    const bool row_in = unsigned(hi) < unsigned(g.H);
    const __nv_bfloat16* p = xb + (row_in ? size_t(hi) * row_elems : 0);
#pragma unroll
    for (int u = 0; u < NV; ++u)
      win[v][u] = row_in && col_in[u] ? load16(p + col[u]) : make_uint4(0, 0, 0, 0);
  };

#pragma unroll
  for (int v = 0; v < 3; ++v) load_row(v);
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int ho = ho0 + i * d;
    if (ho >= g.Ho) break;
    if (i + 1 < TR) {  // the next output row's new input rows, before this row's taps
#pragma unroll
      for (int v = i * S + 3; v < (i + 1) * S + 3; ++v) load_row(v);
    }
#pragma unroll
    for (int j = 0; j < TW; ++j) {
      const int wo = wo0 + j * d;
      float acc[kV];
#pragma unroll
      for (int p = 0; p < kV; ++p) acc[p] = bv[p];
#pragma unroll
      for (int ki = 0; ki < 3; ++ki)
#pragma unroll
        for (int kj = 0; kj < 3; ++kj) {
          float f[kV];
          Vec<__nv_bfloat16>::unpack(win[i * S + ki][j * S + kj], f);
#pragma unroll
          for (int p = 0; p < kV; ++p) acc[p] = fmaf(kk[ki * 3 + kj][p], f[p], acc[p]);
        }
      if (wo < g.Wo) {
        if (ACT == 2) {
#pragma unroll
          for (int p = 0; p < kV; ++p) acc[p] = fmaxf(acc[p], 0.0f);
        } else if (ACT == 3) {
#pragma unroll
          for (int p = 0; p < kV; ++p)
            acc[p] = acc[p] * fminf(fmaxf(acc[p] + 3.0f, 0.0f), 6.0f) * (1.0f / 6.0f);
        } else if (g.has_cap) {
#pragma unroll
          for (int p = 0; p < kV; ++p) acc[p] = fminf(fmaxf(acc[p], 0.0f), g.cap);
        }
        const uint4 out = make_uint4(pack2(acc[0], acc[1]), pack2(acc[2], acc[3]),
                                     pack2(acc[4], acc[5]), pack2(acc[6], acc[7]));
        *reinterpret_cast<uint4*>(yb + (size_t(ho) * g.Wo + wo) * g.C) = out;
      }
    }
  }
}

// (TW, TR) of each stride
constexpr int kTW1 = 4, kTR1 = 4, kTW2 = 2, kTR2 = 4;

using Dw3Kernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                           __nv_bfloat16*, const Dw3Geo);

// the instantiation of stride S for act (0 the identity, 1 the clamp, 2 the
// ReLU, 3 the h-swish)
template <int S, int TW, int TR>
Dw3Kernel kernel_for(int act) {
  if (act == 2) return depthwise3x3_kernel<S, TW, TR, 2>;
  if (act == 3) return depthwise3x3_kernel<S, TW, TR, 3>;
  return depthwise3x3_kernel<S, TW, TR, 0>;
}

}  // namespace

// One launch.  x, k, bias (or null), y bf16 as the header says; (Ho, Wo) the
// output's size for the pads (pad_top, bottom, pad_left, right), which the
// caller computed; act 0 the identity, 1 clamp to [0, cap], 2 max(0, y), 3
// the h-swish.  Returns a cudaError_t (0 on success).
extern "C" int depthwise3x3_launch(const void* x, const void* k, int kcs, int kis, int kjs,
                                   const void* bias, void* y, int B, int H, int W, int C, int Ho,
                                   int Wo, int stride, int dilation, int pad_top, int pad_left,
                                   int act, float cap, void* stream) {
  if (stride < 1 || stride > 2 || B < 1 || H < 1 || W < 1 || C < kV || C % kV || Ho < 1 ||
      Wo < 1 || dilation < 1 || act < 0 || act > 3)
    return cudaErrorInvalidValue;
  const int tw = stride == 1 ? kTW1 : kTW2, tr = stride == 1 ? kTR1 : kTR2;
  Dw3Geo g;
  g.H = H, g.W = W, g.C = C, g.Ho = Ho, g.Wo = Wo;
  g.d = dilation, g.pt = pad_top, g.pl = pad_left;
  g.cv = C / kV;
  g.col_groups = (Wo + tw * dilation - 1) / (tw * dilation) * dilation;
  g.row_groups = (Ho + tr * dilation - 1) / (tr * dilation) * dilation;
  g.items = (long long)B * g.row_groups * g.col_groups;
  g.kcs = kcs, g.kis = kis, g.kjs = kjs;
  g.has_cap = act == 1, g.cap = cap;
  const int bx = g.cv < 128 ? g.cv : 128;
  const int by = kThreads / bx;
  const long long blocks = (g.items + by - 1) / by;
  const int chunks = (g.cv + bx - 1) / bx;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const Dw3Kernel kernel = stride == 1 ? kernel_for<1, kTW1, kTR1>(act)
                                       : kernel_for<2, kTW2, kTR2>(act);
  kernel<<<dim3(unsigned(blocks), chunks), dim3(bx, by), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y), g);
  return cudaGetLastError();
}

// Pointwise (1x1) convolution in int8 with the quantize step and the epilogue
// fused, for Hopper (sm_90a).
//
// Replaces ssdseglib_tpu/models/fused_inference.py::_conv_int8, which is not a
// Pallas kernel: there XLA fuses the activation quantize and the dequantize,
// bias and cast into the fusions around an s8 x s8 -> s32 convolution.  Here,
// on the NHWC view x (R, Ci) of a channels-last activation (bf16 or f32):
//
//     y[r, co] = relu6(f32(sum_ci q(x[r, ci]) * wq[co, ci]) * dequant[co] + bias[co])
//     q(v)     = clamp(rint(f32(v) * inv_x_scale), -127, 127) as s8
//
// with wq (Co, Ci) s8, dequant = f32(w_scale) * f32(x_scale) and bias (Co,)
// f32, inv_x_scale one f32 in device memory, y in x's dtype.  The bits are the
// plain version's (ops/int8_pointwise.py::int8_pointwise_reference): rint is
// round half to even (__float2int_rn, as jnp.round); the s32 sum is exact in
// any order and converts to f32 exactly while 127^2 * Ci < 2^24 (Ci <= 1024,
// checked by the wrapper); the epilogue is __fmul_rn then __fadd_rn, never
// contracted into an FMA; the clamp to [0, 6] runs in f32 before the one
// rounding to bf16, which gives the bits of rounding first and clamping
// after, as the JAX package does, because 0 and 6 are exact and rounding is
// monotone.
//
// What bounds it on the H100: device memory.  At the serving path's shapes
// (1x1 576 -> 256 at 19,200 rows, 256 -> 256 at 307,200) the int8 products
// need 5.7 and 40 G operations, 3 and 20 us at 1,979 TOPS, against 9.6 and 94
// us to read x and write y once in bf16.  So the design reads x from device
// memory once and writes y once, with nothing in between: each CTA takes
// kRows rows across all of Co; its threads load x 16 bytes at a time,
// quantize in registers and keep the s8 tile in shared memory for every
// chunk of Co; the s8 weights (at most 256 KB, from L2) stream through a
// double-buffered ring of (kCols x kDepth) chunks staged with cp.async; the
// products run on mma.sync m16n8k32 s8 x s8 -> s32; dequantize, bias, clamp
// and the cast are the epilogue, written from registers.
//
// Edges: a Ci that is not a multiple of 32 is zero-filled in shared memory (a
// zero s8 adds nothing); rows past R are masked; Co must be a multiple of 8
// (one mma column tile) and Ci a multiple of 8 (whole 16-byte loads of x and
// 8-byte copies of the weights), both checked here and by the wrapper.
//
// Layout: x (R, Ci) and y (R, Co) contiguous, wq (Co, Ci) contiguous s8; xq,
// when not null, receives the s8 activations (R, Ci), for the tests.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using ssdseg::Vec;
using ssdseg::cp_async_commit;
using ssdseg::cp_async_wait;
using ssdseg::round_up;

constexpr int kThreads = 256;  // 8 warps: 4 along the rows x 2 along the columns
constexpr int kRows = 128;     // rows of x a CTA takes
constexpr int kCols = 64;      // output channels of a weight chunk
constexpr int kDepth = 128;    // input channels (bytes) of a weight chunk
constexpr int kLdw = kDepth + 16;  // row stride of a weight chunk: 16 mod 32, no bank conflicts
constexpr int kUnroll = 4;     // 16-byte loads of x a thread has in flight
constexpr int kMaxCi = 1024;   // 127^2 * Ci < 2^24: the s32 sum is an exact f32

// s8 x s8 -> s32: d += a (16 x 32, row-major) * b (32 x 8, "col").
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Asynchronous copy of G (8 or 16) bytes to shared memory; zero-filled when
// `inside` is false (nothing is read).
template <int G> __device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool inside);
template <> __device__ __forceinline__ void cp_async<16>(void* smem, const void* gmem, bool inside) {
  ssdseg::cp_async16(smem, gmem, inside);
}
template <> __device__ __forceinline__ void cp_async<8>(void* smem, const void* gmem, bool inside) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(ssdseg::smem_addr(smem)),
               "l"(gmem), "r"(inside ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ unsigned quantize4(const float* f, float inv) {
  unsigned packed = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = min(max(__float2int_rn(__fmul_rn(f[j], inv)), -127), 127);
    packed |= (unsigned(q) & 0xffu) << (8 * j);  // the lower channel in the lower byte
  }
  return packed;
}

// The chunk (co0.., k0..) of the weights, kCols rows of kc (a multiple of 32)
// bytes, into a ring slot; rows past Co and bytes past Ci are zero-filled.
template <int G>
__device__ __forceinline__ void stage_weights(int8_t* slot, const int8_t* __restrict__ wq, int co0,
                                              int k0, int kc, int Ci, int Co) {
  const int per_row = kc / G;
  for (int i = threadIdx.x; i < kCols * per_row; i += kThreads) {
    const int n = i / per_row, k = k0 + (i % per_row) * G;
    const bool inside = co0 + n < Co && k < Ci;
    cp_async<G>(slot + n * kLdw + (k - k0), inside ? wq + size_t(co0 + n) * Ci + k : wq, inside);
  }
}

template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                                  float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float epilogue(int acc, float dequant, float bias) {
  const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), dequant), bias);
  return fminf(fmaxf(v, 0.0f), 6.0f);
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
int8_pointwise_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                      const float* __restrict__ inv_scale, const float* __restrict__ dequant,
                      const float* __restrict__ bias, T* __restrict__ y, int8_t* __restrict__ xq,
                      int R, int Ci, int Co) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Kp = round_up(Ci, 32), ldk = Kp + 16;  // ldk is 16 mod 32: no bank conflicts
  int8_t* xs = reinterpret_cast<int8_t*>(smem);    // (kRows, ldk) s8 activations
  int8_t* ring = xs + kRows * ldk;                 // 2 x (kCols, kLdw) s8 weights
  const int r0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // this warp's 32 x 32 tile of the CTA's 128 x 64
  const int n_k = (Kp + kDepth - 1) / kDepth;
  const int chunks = n_k * ((Co + kCols - 1) / kCols);

  // the first weight chunk flies while the activations are quantized
  stage_weights<G>(ring, wq, 0, 0, min(kDepth, Kp), Ci, Co);
  cp_async_commit();

  // x: read once, 16 bytes a thread, quantized in registers, kept as s8
  const float inv = *inv_scale;
  constexpr int n = Vec<T>::n;  // values of a 16-byte vector
  const int per_row = Ci / n, total = kRows * per_row;
  for (int base = tid; base < total; base += kThreads * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads, row = i / per_row;
      v[u] = i < total && r0 + row < R
                 ? __ldg(reinterpret_cast<const uint4*>(x + size_t(r0 + row) * Ci) + i % per_row)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads, row = i / per_row, col = (i % per_row) * n;
      if (i >= total) break;
      float f[n];
      Vec<T>::unpack(v[u], f);
      if constexpr (n == 8) {
        const uint2 q = make_uint2(quantize4(f, inv), quantize4(f + 4, inv));
        *reinterpret_cast<uint2*>(xs + row * ldk + col) = q;
        if (xq != nullptr && r0 + row < R)
          *reinterpret_cast<uint2*>(xq + size_t(r0 + row) * Ci + col) = q;
      } else {
        const unsigned q = quantize4(f, inv);
        *reinterpret_cast<unsigned*>(xs + row * ldk + col) = q;
        if (xq != nullptr && r0 + row < R)
          *reinterpret_cast<unsigned*>(xq + size_t(r0 + row) * Ci + col) = q;
      }
    }
  }
  // channels Ci .. Kp: zeros, 8 bytes at a time (Ci is a multiple of 8)
  const int pad = (Kp - Ci) / 8;
  for (int i = tid; i < kRows * pad; i += kThreads)
    *reinterpret_cast<uint2*>(xs + (i / pad) * ldk + Ci + (i % pad) * 8) = make_uint2(0u, 0u);

  int acc[2][4][4];
  for (int c = 0; c < chunks; ++c) {
    const int co0 = (c / n_k) * kCols, kb = c % n_k, k0 = kb * kDepth;
    const int kc = min(kDepth, Kp - k0);
    if (c + 1 < chunks) {  // the next chunk into the other slot, read two chunks ago
      const int k1 = ((c + 1) % n_k) * kDepth;
      stage_weights<G>(ring + ((c + 1) & 1) * kCols * kLdw, wq, ((c + 1) / n_k) * kCols, k1,
                       min(kDepth, Kp - k1), Ci, Co);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this chunk (and, the first time, the s8 tile) is visible
    if (kb == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
    }
    const int8_t* slot = ring + (c & 1) * kCols * kLdw;
#pragma unroll 4
    for (int ks = 0; ks < kc; ks += 32) {
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* pa = xs + (wm * 32 + mt * 16 + g) * ldk + k0 + ks + t * 4;
        a[mt][0] = lds32(pa);
        a[mt][1] = lds32(pa + 8 * ldk);
        a[mt][2] = lds32(pa + 16);
        a[mt][3] = lds32(pa + 8 * ldk + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (co0 + wn * 32 + nt * 8 >= Co) continue;  // a whole column tile past Co
        const int8_t* pb = slot + (wn * 32 + nt * 8 + g) * kLdw + ks + t * 4;
        const unsigned b0 = lds32(pb), b1 = lds32(pb + 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
      }
    }
    if (kb == n_k - 1) {  // this chunk of Co is summed: dequantize, bias, clamp, store
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = co0 + wn * 32 + nt * 8 + t * 2;
        if (col >= Co) continue;
        const float d0 = __ldg(dequant + col), d1 = __ldg(dequant + col + 1);
        const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r0 + wm * 32 + mt * 16 + g + h * 8;
            if (row < R)
              store2<T>(y + size_t(row) * Co + col, epilogue(acc[mt][nt][2 * h], d0, b0),
                        epilogue(acc[mt][nt][2 * h + 1], d1, b1));
          }
      }
    }
    __syncthreads();  // every warp is done with this slot before it is refilled
  }
}

template <typename T, int G>
cudaError_t launch(const void* x, const void* wq, const void* inv_scale, const void* dequant,
                   const void* bias, void* y, void* xq, int R, int Ci, int Co, size_t smem,
                   cudaStream_t stream) {
  auto kernel = int8_pointwise_kernel<T, G>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<(R + kRows - 1) / kRows, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(inv_scale), static_cast<const float*>(dequant),
      static_cast<const float*>(bias), static_cast<T*>(y), static_cast<int8_t*>(xq), R, Ci, Co);
  return cudaGetLastError();
}

}  // namespace

// dtype 0 = f32, 1 = bf16.  x (R, Ci), wq (Co, Ci) s8, inv_scale one f32,
// dequant and bias (Co,) f32 on the device; y (R, Co) out in x's dtype; xq
// (R, Ci) s8 out, or null.  Returns a cudaError_t (0 on success).
extern "C" int int8_pointwise_launch(int dtype, const void* x, const void* wq,
                                     const void* inv_scale, const void* dequant, const void* bias,
                                     void* y, void* xq, int R, int Ci, int Co, void* stream) {
  if (R < 1 || Ci < 8 || Ci % 8 || Ci > kMaxCi || Co < 8 || Co % 8 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const size_t smem = size_t(kRows) * (round_up(Ci, 32) + 16) + 2 * kCols * kLdw;
  auto s = static_cast<cudaStream_t>(stream);
  const bool wide = Ci % 16 == 0;  // 16-byte weight copies stay aligned
  if (dtype == 1)
    return wide ? launch<__nv_bfloat16, 16>(x, wq, inv_scale, dequant, bias, y, xq, R, Ci, Co,
                                            smem, s)
                : launch<__nv_bfloat16, 8>(x, wq, inv_scale, dequant, bias, y, xq, R, Ci, Co,
                                           smem, s);
  return wide ? launch<float, 16>(x, wq, inv_scale, dequant, bias, y, xq, R, Ci, Co, smem, s)
              : launch<float, 8>(x, wq, inv_scale, dequant, bias, y, xq, R, Ci, Co, smem, s);
}

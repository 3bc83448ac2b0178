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
// us to read x and write y once in bf16.  So the design keeps device memory
// busy from the first cycle to the last and reads nothing twice from it:
//
// - Persistent CTAs, one an SM (the grid is the SM count times what the
//   occupancy calculator admits), each with two consumer warpgroups and a
//   producer warpgroup that gives its registers to them (setmaxnreg).  The work is (chunk of Co, tile of 64 rows) items in a
//   static stride; consecutive items of a CTA alternate between its
//   warpgroups, so one warpgroup's epilogue runs beside the other's products
//   and the loads of both.
// - The weights stay in shared memory: a CTA copies its chunk of Co (128 or
//   256 output channels, in the 128-byte swizzled K-major layout wgmma reads
//   for B) once, with cp.async, while its first x tiles arrive.  Where the
//   whole of Co does not fit beside the ring (576 -> 256: 160 KB), Co is cut
//   into chunks of 128 held by different CTAs that walk the same tiles in
//   step, so a tile's second read comes from L2; where there are more chunks
//   than CTAs, a CTA loops over chunks and copies each once.
// - A ring of x tiles for each consumer warpgroup, 64 rows x 128 channels a
//   stage (16 KB in bf16), fed by TMA (boxes of 64 rows x 128 bytes, 128-byte
//   swizzle) from a lane of the producer's first warp behind full / empty
//   mbarriers.
//   A ring has one consumer, which takes its stages in order: an mbarrier's
//   parity then names the phase a wait is for.  TMA's out-of-bounds fill
//   gives the zero rows past R and the zero channels past Ci.
// - A consumer warpgroup quantizes a stage into an s8 tile (64 x 128 bytes,
//   swizzled, double-buffered), releases the stage, and runs wgmma
//   m64n128k32 s8 x s8 -> s32 on it against the resident weights,
//   accumulating over Ci in registers, while it quantizes the next stage.
// - Epilogue: dequantize, bias, clamp, one rounding, into a swizzled staging
//   tile that a TMA store writes out (clipped at R and Co) while the
//   warpgroup goes on.
//
// Edges: Ci a multiple of 8 (x's rows are whole 16-byte units for TMA; the
// weights are copied 8 bytes at a time) and at most 1024; Co a multiple of 8;
// both checked here and by the wrapper.  A Ci that is not a multiple of 32 is
// zero-filled up to the next 128 (a zero s8 adds nothing), so that every
// stage runs the same four k32 steps; the products run over 128 output
// channels at a time, and channels past Co are computed on zero weights and
// never stored.
//
// Layout: x (R, Ci) and y (R, Co) contiguous, 16-byte aligned; wq (Co, Ci)
// contiguous s8; xq, when not null, receives the s8 activations (R, Ci), for
// the tests.  ops/int8_pointwise.py::_plan computes the same plan as
// make_plan below (chip_smoke.py holds the two equal).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using namespace ssdseg;

constexpr int kThreads = 384;   // consumer warpgroups 0 and 1, then the producer warpgroup
constexpr int kTileRows = 64;   // rows of x a consumer warpgroup takes at a time (wgmma's M)
constexpr int kChunk = 128;     // channels of x a ring stage holds: one 128-byte row of s8
constexpr int kBlock = 128;     // output channels of one wgmma (N) and of a weight block
constexpr int kBox = 8192;      // bytes of a TMA box and of an s8 tile: 64 rows x 128 bytes
constexpr int kMaxStages = 8;
constexpr int kMaxCi = 1024;    // 127^2 * Ci < 2^24: the s32 sum is an exact f32
constexpr int kAlign = 1024;    // the 128-byte swizzle's atom

// The launch plan (ops/int8_pointwise.py::_plan is the same rules).
struct Plan {
  int nc;       // 128-channel blocks of Co a CTA holds resident: 1 or 2
  int n_k;      // ring stages a tile takes: ceil(Ci / 128)
  int kp32;     // the depth of x and the weights read: Ci rounded up to 32
  int stages;   // ring stages in all: (stages + 1) / 2 for warpgroup 0, the rest for
                // warpgroup 1, which takes no items when it has none
  int n_co;     // chunks of Co: ceil(Co / (128 nc))
  int n_tiles;  // tiles of 64 rows: ceil(R / 64)
  int grid;     // CTAs
  int smem;     // dynamic shared memory, bytes
};

__host__ __device__ constexpr int stage_bytes(int elem) { return kTileRows * kChunk * elem; }

// Shared memory besides the ring: alignment slack, the weights (n_k blocks of
// 128 nc rows x 128 bytes), two s8 tiles and a two-box staging tile per
// consumer warpgroup, dequant and bias, the ring's mbarriers.
__host__ __device__ constexpr int fixed_bytes(int nc, int n_k) {
  return kAlign + n_k * nc * kBlock * kChunk + 4 * kBox + 4 * kBox + 2 * nc * kBlock * 4 +
         16 * kMaxStages;
}

Plan make_plan(int R, int Ci, int Co, int elem, int sm_count, int smem_limit, int ctas_per_sm) {
  Plan p{};
  p.n_k = (Ci + kChunk - 1) / kChunk;
  p.kp32 = round_up(Ci, 32);
  const int stage = stage_bytes(elem);
  p.nc = Co > kBlock && fixed_bytes(2, p.n_k) + 2 * stage <= smem_limit ? 2 : 1;
  p.stages = (smem_limit - fixed_bytes(p.nc, p.n_k)) / stage;
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  p.smem = fixed_bytes(p.nc, p.n_k) + p.stages * stage;
  p.n_co = (Co + p.nc * kBlock - 1) / (p.nc * kBlock);
  p.n_tiles = (R + kTileRows - 1) / kTileRows;
  const int ctas = sm_count * ctas_per_sm;
  if (p.n_co <= ctas) {  // each CTA keeps one chunk; at least two tiles a CTA
    int groups = ctas / p.n_co;
    const int pairs = (p.n_tiles + 1) / 2;
    if (groups > pairs) groups = pairs;
    p.grid = groups * p.n_co;
  } else {
    p.grid = ctas;
  }
  return p;
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool inside) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(inside ? 8 : 0)
               : "memory");
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

// The 16 channels ca * 16 .. of row r of a ring stage (boxes of 128 bytes a
// row, 128-byte swizzle: 16-byte unit u of row r sits at unit u ^ (r % 8)),
// as f32.
template <typename T>
__device__ __forceinline__ void load16(const unsigned char* stage, int r, int ca,
                                       float (&f)[16]) {
  constexpr int kPer = 16 / sizeof(T), kBoxCols = 128 / sizeof(T);
  const int c = ca * 16, u0 = (c % kBoxCols) / kPer;
  const unsigned char* row = stage + (c / kBoxCols) * kBox + r * 128;
#pragma unroll
  for (int i = 0; i < int(sizeof(T)); ++i) {
    float part[kPer];
    Vec<T>::unpack(*reinterpret_cast<const uint4*>(row + (((u0 + i) ^ (r & 7)) << 4)), part);
#pragma unroll
    for (int e = 0; e < kPer; ++e) f[i * kPer + e] = part[e];
  }
}

template <typename T> __device__ __forceinline__ void store2(unsigned char* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(unsigned char* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(unsigned char* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float epilogue(int acc, float dequant, float bias) {
  const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), dequant), bias);
  return fminf(fmaxf(v, 0.0f), 6.0f);
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, 1)
int8_pointwise_kernel(__grid_constant__ const CUtensorMap xmap,
                      __grid_constant__ const CUtensorMap ymap, const int8_t* __restrict__ wq,
                      const float* __restrict__ inv_scale, const float* __restrict__ dequant,
                      const float* __restrict__ bias, int8_t* __restrict__ xq, int R, int Ci,
                      int Co, const Plan p) {
  constexpr int kElem = sizeof(T);
  constexpr int kBoxCols = 128 / kElem;             // channels of x or y in a box
  constexpr int kRows = NC * kBlock;                // output channels a CTA holds
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_addr(smem_raw);
  const unsigned pad = (kAlign - (raw & (kAlign - 1))) & (kAlign - 1);
  unsigned char* base = smem_raw + pad;
  const unsigned sbase = raw + pad;
  const int stage = stage_bytes(kElem);
  const int w_off = p.stages * stage;               // the weights: n_k blocks of kRows x 128 B
  const int a_off = w_off + p.n_k * kRows * kChunk;  // s8 tiles: 2 a warpgroup
  const int st_off = a_off + 4 * kBox;               // staging: 2 boxes a warpgroup
  const int tb_off = st_off + 4 * kBox;              // dequant, then bias (kRows each)
  const unsigned full = sbase + tb_off + 2 * kRows * 4, empty = full + 8 * p.stages;
  const float* dq_s = reinterpret_cast<const float*>(base + tb_off);
  const float* b_s = dq_s + kRows;

  // the warp's number, broadcast so that the compiler sees it uniform in the warp
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + 8 * s, 1);      // the producer's arrival, plus the stage's bytes
      mbar_init(empty + 8 * s, 128);   // every thread of the consuming warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  // this CTA's items: chunks of Co from chunk0 in steps of chunk_step, and
  // for each chunk the tiles from tile0 in steps of tile_step; item j goes
  // to warpgroup j % n_wg, whose ring holds stages first .. first + depth - 1
  const int G = gridDim.x;
  const bool grouped = p.n_co <= G;
  const int chunk0 = grouped ? blockIdx.x % p.n_co : blockIdx.x;
  const int chunk_step = grouped ? p.n_co : G;
  const int tile0 = grouped ? blockIdx.x / p.n_co : 0;
  const int tile_step = grouped ? G / p.n_co : 1;
  const int n_wg = p.stages >= 2 ? 2 : 1;

  if (warp >= 8) {  // the producer: lane w of its first warp feeds warpgroup w's ring
    setmaxnreg_dec<40>();
    if (warp == 8 && lane < n_wg) {
      const int first = lane == 0 ? 0 : (p.stages + 1) / 2;
      const int depth = lane == 0 ? (p.stages + 1) / 2 : p.stages / 2;
      int j = 0, g = 0;
      for (int chunk = chunk0; chunk < p.n_co; chunk += chunk_step)
        for (int tile = tile0; tile < p.n_tiles; tile += tile_step, ++j) {
          if (j % n_wg != lane) continue;
          for (int kc = 0; kc < p.n_k; ++kc, ++g) {
            const unsigned s = first + g % depth;
            mbar_wait(empty + 8 * s, ((g / depth) & 1) ^ 1);
            const int boxes =
                min(kChunk / kBoxCols, (Ci - kc * kChunk + kBoxCols - 1) / kBoxCols);
            mbar_arrive_expect_tx(full + 8 * s, boxes * kBox);
            for (int b = 0; b < boxes; ++b)
              tma_load_2d(sbase + s * stage + b * kBox, &xmap, kc * kChunk + b * kBoxCols,
                          tile * kTileRows, full + 8 * s);
          }
        }
    }
    return;
  }

  // the consumers
  setmaxnreg_inc<232>();
  const int wg = warp >> 2, lt = tid & 127;
  unsigned char* a_tile = base + a_off + wg * 2 * kBox;
  const unsigned a_addr = sbase + a_off + wg * 2 * kBox;
  unsigned char* staging = base + st_off + wg * 2 * kBox;
  const unsigned staging_addr = sbase + st_off + wg * 2 * kBox;
  const float inv = *inv_scale;
  // the accumulator fragment: thread lt holds rows r_lo and r_lo + 8 of the
  // tile, columns 8 j + 2 q and 8 j + 2 q + 1 of each 8-column block j
  const int r_lo = (lt >> 5) * 16 + (lane >> 2), q = lane & 3;
  int acc[NC][64];
#pragma unroll
  for (int nc = 0; nc < NC; ++nc)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[nc][i] = 0;

  const int first = wg == 0 ? 0 : (p.stages + 1) / 2;
  const int depth = wg == 0 ? (p.stages + 1) / 2 : p.stages / 2;
  int j = 0, g = 0;  // the CTA's items, this warpgroup's ring stages
  for (int chunk = chunk0; chunk < p.n_co; chunk += chunk_step) {
    const int co0 = chunk * kRows;
    if (chunk != chunk0) named_barrier(1, 256);  // both warpgroups are done with the last chunk
    {  // this chunk's weights, 8 bytes a copy, into the swizzled blocks; dequant and bias
      unsigned char* w_s = base + w_off;
      const int pieces = p.n_k * kChunk / 8;  // zeros past Ci
      for (int i = tid; i < kRows * pieces; i += 256) {
        const int n = i / pieces, k = (i - n * pieces) * 8;
        const bool inside = co0 + n < Co && k < Ci;
        cp_async8(w_s + (k / kChunk) * (kRows * kChunk) + n * kChunk +
                      ((((k % kChunk) >> 4) ^ (n & 7)) << 4) + (k & 8),
                  inside ? wq + size_t(co0 + n) * Ci + k : wq, inside);
      }
      cp_async_commit();
      float* tables = reinterpret_cast<float*>(base + tb_off);
      for (int c = tid; c < kRows; c += 256) {
        const bool inside = co0 + c < Co;
        tables[c] = inside ? dequant[co0 + c] : 0.0f;
        tables[kRows + c] = inside ? bias[co0 + c] : 0.0f;
      }
      cp_async_wait<0>();
      fence_proxy_async();
      named_barrier(1, 256);
    }

    for (int tile = tile0; tile < p.n_tiles; tile += tile_step, ++j) {
      if (j % n_wg != wg) continue;
      const int row0 = tile * kTileRows;
#pragma unroll
      for (int nc = 0; nc < NC; ++nc)
#pragma unroll
        for (int i = 0; i < 64; ++i) wgmma_pin(acc[nc][i]);
      for (int kc = 0; kc < p.n_k; ++kc) {
        const int s = first + g % depth;
        const int used = 2 * min(4, (p.kp32 - kc * kChunk) / 32);  // 16-channel units read
        unsigned char* a_s = a_tile + (kc & 1) * kBox;
        mbar_wait(full + 8 * s, (g / depth) & 1);
        // quantize: 16 channels a thread and pass, 8 threads a row; the units
        // past Ci rounded up to 32 (no box was loaded there) are zeros
#pragma unroll
        for (int it = 0; it < 4; ++it) {
          const int idx = it * 128 + lt, r = idx >> 3, ca = idx & 7;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (ca < used) {
            float f[16];
            load16<T>(base + s * stage, r, ca, f);
            v = make_uint4(quantize4(f, inv), quantize4(f + 4, inv), quantize4(f + 8, inv),
                           quantize4(f + 12, inv));
          }
          *reinterpret_cast<uint4*>(a_s + r * 128 + ((ca ^ (r & 7)) << 4)) = v;
          const int row = row0 + r, k = kc * kChunk + ca * 16;
          if (xq != nullptr && row < R) {  // Ci is a multiple of 8: whole 8-byte halves
            int8_t* out = xq + size_t(row) * Ci + k;
            if (k < Ci) *reinterpret_cast<uint2*>(out) = make_uint2(v.x, v.y);
            if (k + 8 < Ci) *reinterpret_cast<uint2*>(out + 8) = make_uint2(v.z, v.w);
          }
        }
        mbar_arrive(empty + 8 * s);  // the stage may be refilled
        fence_proxy_async();         // the s8 tile is visible to wgmma
        named_barrier(2 + wg, 128);
        wgmma_fence();
        const unsigned long long da = sw128_desc(a_addr + (kc & 1) * kBox);
        const unsigned w_block = sbase + w_off + kc * kRows * kChunk;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int nc = 0; nc < NC; ++nc)
            wgmma_m64n128k32_s8(acc[nc], da + 2 * ks,
                                sw128_desc(w_block + nc * kBlock * kChunk) + 2 * ks,
                                (kc | ks) != 0);
        wgmma_commit();
        wgmma_wait<1>();  // the s8 tile written next is no longer read
        ++g;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int nc = 0; nc < NC; ++nc)
#pragma unroll
        for (int i = 0; i < 64; ++i) wgmma_pin(acc[nc][i]);

      // epilogue: rounds of two boxes (128 bf16 or 64 f32 channels) through
      // the staging tile, each stored by TMA while the next one is computed
      constexpr int kRoundCols = 2 * kBoxCols;
#pragma unroll
      for (int nc = 0; nc < NC; ++nc) {
#pragma unroll
        for (int round = 0; round < kBlock / kRoundCols; ++round) {
          const int cb = nc * kBlock + round * kRoundCols;  // the round's first channel
          if (co0 + cb >= Co) break;
          if (lt == 0) bulk_wait_read<0>();  // the last round's store has read the staging
          named_barrier(2 + wg, 128);
#pragma unroll
          for (int jj = 0; jj < kRoundCols / 8; ++jj) {
            const int jb = round * (kRoundCols / 8) + jj;  // 8-column block of the 128
            const int cl = cb + jj * 8 + 2 * q;
            const float2 d = *reinterpret_cast<const float2*>(dq_s + cl);
            const float2 b = *reinterpret_cast<const float2*>(b_s + cl);
            const int byte = ((jj * 8) % kBoxCols + 2 * q) * kElem;
            unsigned char* at = staging + (jj * 8 / kBoxCols) * kBox + r_lo * 128 +
                                ((((byte >> 4) ^ (r_lo & 7)) << 4) | (byte & 15));
            store2<T>(at, epilogue(acc[nc][4 * jb], d.x, b.x),
                      epilogue(acc[nc][4 * jb + 1], d.y, b.y));
            store2<T>(at + 8 * 128, epilogue(acc[nc][4 * jb + 2], d.x, b.x),
                      epilogue(acc[nc][4 * jb + 3], d.y, b.y));
          }
          fence_proxy_async();
          named_barrier(2 + wg, 128);
          if (lt == 0) {
#pragma unroll
            for (int bx = 0; bx < 2; ++bx) {
              const int col = co0 + cb + bx * kBoxCols;
              if (col < Co) tma_store_2d(&ymap, staging_addr + bx * kBox, col, row0);
            }
            bulk_commit();
          }
        }
      }
    }
  }
  if (lt == 0) bulk_wait_all();
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query (the library links no libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major (rows, cols) tensor in boxes of 64 rows x 128 bytes, 128-byte
// swizzle, zero fill out of bounds.
bool tensor_map(CUtensorMap* map, EncodeTiled encode, CUtensorMapDataType type, int elem,
                const void* ptr, int rows, int cols) {
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * elem};
  const cuuint32_t box[2] = {cuuint32_t(128 / elem), cuuint32_t(kTileRows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// What a device and each instantiation need once: the SM count, the shared
// memory a block may opt into, the attribute set, the last occupancy read.
constexpr int kMaxDevices = 16;
struct DeviceState {
  int sm_count = 0, smem_limit = 0;
  bool attribute[2][2] = {};
  int occupancy_smem[2][2] = {}, occupancy[2][2] = {};
};
DeviceState devices[kMaxDevices];

// The plan for this shape on the current device, and the kernel for it.
template <typename T, int NC>
cudaError_t occupancy(DeviceState& dev, int d, int smem, int* ctas) {
  auto kernel = int8_pointwise_kernel<T, NC>;
  if (!dev.attribute[d][NC - 1]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           dev.smem_limit);
    if (err != cudaSuccess) return err;
    dev.attribute[d][NC - 1] = true;
  }
  if (dev.occupancy_smem[d][NC - 1] != smem) {
    cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, kThreads, size_t(smem));
    if (err != cudaSuccess) return err;
    dev.occupancy_smem[d][NC - 1] = smem;
    dev.occupancy[d][NC - 1] = *ctas;
  }
  *ctas = dev.occupancy[d][NC - 1];
  return cudaSuccess;
}

cudaError_t prepare(int dtype, int R, int Ci, int Co, Plan* plan, int* ctas_per_sm,
                    DeviceState** state) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceState& dev = devices[device];
  if (dev.sm_count == 0) {
    err = cudaDeviceGetAttribute(&dev.sm_count, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&dev.smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   device);
    if (err != cudaSuccess) {
      dev.sm_count = 0;
      return err;
    }
  }
  const int elem = dtype == 1 ? 2 : 4;
  // the smem and NC do not depend on the occupancy: plan with one CTA an SM
  // first, then read how many fit
  Plan p = make_plan(R, Ci, Co, elem, dev.sm_count, dev.smem_limit, 1);
  if (p.stages < 1) return cudaErrorInvalidValue;
  const int d = dtype == 1 ? 1 : 0;
  int ctas = 0;
  if (dtype == 1)
    err = p.nc == 2 ? occupancy<__nv_bfloat16, 2>(dev, d, p.smem, &ctas)
                    : occupancy<__nv_bfloat16, 1>(dev, d, p.smem, &ctas);
  else
    err = p.nc == 2 ? occupancy<float, 2>(dev, d, p.smem, &ctas)
                    : occupancy<float, 1>(dev, d, p.smem, &ctas);
  if (err != cudaSuccess) return err;
  if (ctas < 1) return cudaErrorInvalidConfiguration;
  *plan = make_plan(R, Ci, Co, elem, dev.sm_count, dev.smem_limit, ctas);
  *ctas_per_sm = ctas;
  *state = &dev;
  return cudaSuccess;
}

bool valid(int dtype, int R, int Ci, int Co) {
  return R >= 1 && Ci >= 8 && Ci % 8 == 0 && Ci <= kMaxCi && Co >= 8 && Co % 8 == 0 &&
         (dtype == 0 || dtype == 1);
}

template <typename T, int NC>
cudaError_t launch(const CUtensorMap& xmap, const CUtensorMap& ymap, const void* wq,
                   const void* inv_scale, const void* dequant, const void* bias, void* xq, int R,
                   int Ci, int Co, const Plan& p, cudaStream_t stream) {
  int8_pointwise_kernel<T, NC><<<p.grid, kThreads, p.smem, stream>>>(
      xmap, ymap, static_cast<const int8_t*>(wq), static_cast<const float*>(inv_scale),
      static_cast<const float*>(dequant), static_cast<const float*>(bias),
      static_cast<int8_t*>(xq), R, Ci, Co, p);
  return cudaGetLastError();
}

}  // namespace

// dtype 0 = f32, 1 = bf16.  x (R, Ci), wq (Co, Ci) s8, inv_scale one f32,
// dequant and bias (Co,) f32 on the device; y (R, Co) out in x's dtype; xq
// (R, Ci) s8 out, or null.  Returns a cudaError_t (0 on success).
extern "C" int int8_pointwise_launch(int dtype, const void* x, const void* wq,
                                     const void* inv_scale, const void* dequant, const void* bias,
                                     void* y, void* xq, int R, int Ci, int Co, void* stream) {
  if (!valid(dtype, R, Ci, Co)) return cudaErrorInvalidValue;
  Plan p;
  int ctas = 0;
  DeviceState* dev = nullptr;
  cudaError_t err = prepare(dtype, R, Ci, Co, &p, &ctas, &dev);
  if (err != cudaSuccess) return err;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const int elem = dtype == 1 ? 2 : 4;
  const CUtensorMapDataType type =
      dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap xmap, ymap;
  if (!tensor_map(&xmap, encode, type, elem, x, R, Ci) ||
      !tensor_map(&ymap, encode, type, elem, y, R, Co))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return p.nc == 2 ? launch<__nv_bfloat16, 2>(xmap, ymap, wq, inv_scale, dequant, bias, xq, R,
                                                Ci, Co, p, s)
                     : launch<__nv_bfloat16, 1>(xmap, ymap, wq, inv_scale, dequant, bias, xq, R,
                                                Ci, Co, p, s);
  return p.nc == 2
             ? launch<float, 2>(xmap, ymap, wq, inv_scale, dequant, bias, xq, R, Ci, Co, p, s)
             : launch<float, 1>(xmap, ymap, wq, inv_scale, dequant, bias, xq, R, Ci, Co, p, s);
}

// The plan int8_pointwise_launch takes for this shape on the current device:
// out[11] = nc, n_k, kp32, stages, n_co, n_tiles, grid, smem, SM count, the
// shared memory a block may opt into, CTAs an SM.  Returns a cudaError_t.
extern "C" int int8_pointwise_plan(int dtype, int R, int Ci, int Co, int* out) {
  if (!valid(dtype, R, Ci, Co)) return cudaErrorInvalidValue;
  Plan p;
  int ctas = 0;
  DeviceState* dev = nullptr;
  cudaError_t err = prepare(dtype, R, Ci, Co, &p, &ctas, &dev);
  if (err != cudaSuccess) return err;
  const int values[11] = {p.nc,   p.n_k,  p.kp32,        p.stages,        p.n_co, p.n_tiles,
                          p.grid, p.smem, dev->sm_count, dev->smem_limit, ctas};
  for (int i = 0; i < 11; ++i) out[i] = values[i];
  return cudaSuccess;
}

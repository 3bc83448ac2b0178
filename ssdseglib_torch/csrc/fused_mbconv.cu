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
// points as the TPU kernel, and the residual added in the I/O dtype.  The
// halo outside the image is the depthwise conv's zero padding of the
// EXPANDED tensor, so it is 0 and not relu6(b1).
//
// What bounds it on the H100: the bytes of x and out cross HBM once each,
// while the E-wide tensor (E = 6 * Cin) is six times larger than either and
// would otherwise be written and read twice.  The tiling keeps that tensor
// on chip: one CTA owns one image and one th x tw spatial tile and recomputes
// the expand on the tile plus a 1-pixel halo (the halo costs (th+2)(tw+2) /
// (th*tw) extra expand work instead of an HBM round trip).
//
// bfloat16, the serving dtype (`mbconv_bf16_kernel`).  The depthwise conv is
// per channel, so the block decomposes exactly along E: the CTA loads x on
// the tile + halo once, then walks E in chunks of EC channels (EC a multiple
// of 16 that divides E).  Per chunk:
//   1. expand on the tensor cores (mma.sync m16n8k16 bf16 -> f32, operands by
//      ldmatrix), halo pixels x EC, the halo's row count padded to 16;
//   2. bias, round, relu6 (0 outside the image) into a small shared tile;
//   3. the depthwise 3x3 on the CUDA cores (f32, taps in row-major order);
//   4. bias, round, relu6 into a second small shared tile;
//   5. the project partial on the tensor cores, accumulated in f32 registers
//      over all chunks as a (tile pixels x Cout) block, a warp per 16 pixel
//      rows and NREP 8-channel column tiles.
// The next chunk's slices of w1, w3, the taps and the biases are copied into
// a second buffer with cp.async while the current chunk computes; x arrives
// the same way.  Shared memory holds x's halo tile, two EC-wide tiles and the
// two weight buffers, so it no longer grows with E and the tile is chosen for
// the card per width (th, tw, EC, NREP: `bf16_config`, from an A/B on the
// H100 in PERF.md).  The epilogue adds the bias, rounds, adds the residual
// from the x tile in shared memory and stores with 16-byte writes.  The
// tensor-core instruction is Ampere's mma.sync; Hopper's wgmma is queued
// (ROADMAP.md).
//
// float32 (`mbconv_kernel<float>`, the f32 checks' path) keeps the CUDA-core
// design: the whole E-wide expanded tile in shared memory, the 1x1s as
// scalar FMAs, each weight load feeding kPixelsPerThread pixels.
//
// Layout: x (B, H, W, Cin) and out (B, H, W, Cout) NHWC contiguous;
// w1 (Cin, E), wd (9, E) [taps row-major], w3 (E, Cout), biases (E,)/(Cout,),
// all in the I/O dtype (float32 or bfloat16), 16-byte aligned for bf16.

#include "common.cuh"

namespace {

using ssdseg::cp_async16;
using ssdseg::cp_async_commit;
using ssdseg::cp_async_wait;
using ssdseg::from_f;
using ssdseg::to_f;

// f32 path: 512 threads x 8 pixels of register blocking per thread in the
// 1x1s (an A/B on the H100 over 256/512 threads and 4/8/16 pixels is in
// PERF.md).
constexpr int kThreads = 512;
constexpr int kPixelsPerThread = 8;

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

// Candidate tiles of the f32 path, largest first; the first that fits
// shared memory wins.
constexpr int kTiles[][2] = {{8, 16}, {8, 8}, {4, 8}, {4, 4}, {2, 4}, {2, 2}, {1, 2}, {1, 1}};

// Picks the f32 path's tile for (Cin, E) on the current device.
cudaError_t pick_tile(int cin, int e, int* th, int* tw, size_t* smem) {
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  for (const auto& t : kTiles) {
    *smem = smem_bytes(t[0], t[1], cin, e, sizeof(float));
    if (*smem <= size_t(smem_max)) {
      *th = t[0];
      *tw = t[1];
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidConfiguration;
}

cudaError_t launch_f32(const void* x, const void* w1, const void* b1, const void* wd,
                       const void* b2, const void* w3, const void* b3, void* out, int B, int H,
                       int W, int Cin, int E, int Cout, int residual, cudaStream_t stream) {
  int th = 0, tw = 0;
  size_t smem = 0;
  cudaError_t err = pick_tile(Cin, E, &th, &tw, &smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mbconv_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(((H + th - 1) / th) * ((W + tw - 1) / tw), B);
  mbconv_kernel<float><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(wd), static_cast<const float*>(b2),
      static_cast<const float*>(w3), static_cast<const float*>(b3), static_cast<float*>(out), H,
      W, Cin, E, Cout, th, tw, residual);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: E in chunks, 1x1s on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMaxWarps = 16;

// The instantiated NREP values (8-channel column tiles of the project output
// per warp), smallest first.
constexpr int kNreps[] = {1, 2, 3, 4, 5, 6, 8, 10};

// Row stride, in bf16 elements, of a shared tile whose rows hold n (a
// multiple of 8) values: padded so that the stride is an odd number of 16-byte
// units and the eight rows an ldmatrix reads fall in eight different bank
// groups.
__host__ __device__ inline int padded_ld(int n) { return (n / 8) % 2 == 0 ? n + 8 : n + 16; }

// Everything the bf16 kernel derives from (shape, tile): sizes, strides and
// the byte offsets of its shared-memory regions.  Built on the host.
struct Geo {
  int H, W, Cin, E, Cout, cin_p;  // cin_p: Cin padded to the mma depth (16)
  int th, tw, ec, nrep;           // the tile, the chunk of E, the column tiles a warp owns
  int wp, nh, mh;                 // halo width, halo pixels, halo rows padded to 16
  int nt, mt_tiles;               // tile pixels, their 16-row mma tiles
  int nco, warps, tiles_w, chunks;
  int ldx, ldw1, ldw3, lde, ldo;  // row strides (elements)
  int off_w1, off_w3, off_aux, off_e, off_d;  // byte offsets; the output tile reuses off_e
  int w1_buf, w3_buf, aux_buf;    // bytes of one buffer of each
  int smem;
};

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

struct Bf16Config {
  int th, tw, ec, nrep;
};

// The (th, tw, EC, NREP) of a width, from an A/B on the H100 (PERF.md,
// `chip_smoke.py --mbconv-variants`); other widths take 8 x 8 tiles, the
// largest EC of 64, 48, 32, 16 that divides E, and about 8 warps.
Bf16Config bf16_config(int Cin, int E, int Cout) {
  if (Cin == 24 && E == 144) return {15, 16, 48, 3};
  if (Cin == 32 && E == 192) return {10, 20, 48, 4};
  if (Cin == 64 && E == 384) return {10, 8, 64, 4};
  if (Cin == 96 && E == 576) return {10, 8, 64, 6};
  if (Cin == 160 && E == 960) return {5, 4, 48, 4};
  Bf16Config c{8, 8, 16, 0};
  constexpr int kChunks[] = {64, 48, 32};
  for (int ec : kChunks) {
    if (E % ec == 0) {
      c.ec = ec;
      break;
    }
  }
  const int nco = Cout / 8, mt_tiles = round_up(c.th * c.tw, 16) / 16;
  for (int nrep : kNreps) {
    c.nrep = nrep;
    if (mt_tiles * ((nco + nrep - 1) / nrep) <= 8) break;
  }
  return c;
}

// Fills g for the shape and config; false where the kernel cannot take them.
bool make_geo(int H, int W, int Cin, int E, int Cout, Bf16Config c, int smem_max, Geo* g) {
  if (Cin % 8 || Cout % 8 || E % 16 || c.ec % 16 || E % c.ec || c.th < 1 || c.tw < 1)
    return false;
  bool instantiated = false;
  for (int nrep : kNreps) instantiated |= nrep == c.nrep;
  if (!instantiated) return false;
  g->H = H, g->W = W, g->Cin = Cin, g->E = E, g->Cout = Cout;
  g->cin_p = round_up(Cin, 16);
  g->th = c.th, g->tw = c.tw, g->ec = c.ec, g->nrep = c.nrep;
  g->wp = c.tw + 2;
  g->nh = (c.th + 2) * g->wp;
  g->mh = round_up(g->nh, 16);
  g->nt = c.th * c.tw;
  g->mt_tiles = round_up(g->nt, 16) / 16;
  g->nco = Cout / 8;
  g->warps = g->mt_tiles * ((g->nco + c.nrep - 1) / c.nrep);
  if (g->warps > kMaxWarps) return false;
  g->tiles_w = (W + c.tw - 1) / c.tw;
  g->chunks = E / c.ec;
  g->ldx = padded_ld(g->cin_p);
  g->ldw1 = padded_ld(c.ec);
  g->ldw3 = padded_ld(Cout);
  g->lde = padded_ld(c.ec);
  g->ldo = padded_ld(Cout);
  const int b = int(sizeof(bf16));
  g->w1_buf = g->cin_p * g->ldw1 * b;
  g->w3_buf = c.ec * g->ldw3 * b;
  g->aux_buf = 11 * c.ec * b;  // 9 taps, b1, b2 of the chunk
  g->off_w1 = round_up(g->mh * g->ldx * b, 128);
  g->off_w3 = g->off_w1 + 2 * round_up(g->w1_buf, 128);
  g->off_aux = g->off_w3 + 2 * round_up(g->w3_buf, 128);
  g->off_e = g->off_aux + 2 * round_up(g->aux_buf, 128);
  g->off_d = g->off_e + round_up(g->nh * g->lde * b, 128);
  const int tiles_end = g->off_d + g->mt_tiles * 16 * g->lde * b;
  const int out_end = g->off_e + g->mt_tiles * 16 * g->ldo * b;
  g->smem = tiles_end > out_end ? tiles_end : out_end;
  return g->smem <= smem_max;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ldmatrix: four (or two) 8 x 8 b16 matrices from shared memory, each lane
// giving the address of one row; .trans hands out the transposes.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a (16 x 16, row-major) * b (16 x 8, "col"), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                          unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float relu6_rounded(float v) {
  return fminf(fmaxf(__bfloat162float(__float2bfloat16_rn(v)), 0.0f), 6.0f);
}

// Starts the copies of chunk `c`'s slices -- w1[:, c0:c0+EC], w3[c0:c0+EC, :],
// the taps wd[:, c0:c0+EC], b1 and b2 of the chunk -- into one buffer set.
__device__ __forceinline__ void start_chunk_copy(const Geo& g, int c,
                                                 const bf16* __restrict__ w1,
                                                 const bf16* __restrict__ wd,
                                                 const bf16* __restrict__ b1,
                                                 const bf16* __restrict__ b2,
                                                 const bf16* __restrict__ w3, bf16* w1s,
                                                 bf16* w3s, bf16* aux) {
  const int c0 = c * g.ec, vec_ec = g.ec / 8, vec_co = g.Cout / 8;
  for (int v = threadIdx.x; v < g.Cin * vec_ec; v += blockDim.x) {
    const int r = v / vec_ec, cv = v - r * vec_ec;
    cp_async16(w1s + r * g.ldw1 + cv * 8, w1 + size_t(r) * g.E + c0 + cv * 8, true);
  }
  for (int v = threadIdx.x; v < g.ec * vec_co; v += blockDim.x) {
    const int r = v / vec_co, cv = v - r * vec_co;
    cp_async16(w3s + r * g.ldw3 + cv * 8, w3 + size_t(c0 + r) * g.Cout + cv * 8, true);
  }
  for (int v = threadIdx.x; v < 11 * vec_ec; v += blockDim.x) {
    const int r = v / vec_ec, cv = v - r * vec_ec;
    const bf16* src = r < 9 ? wd + size_t(r) * g.E : (r == 9 ? b1 : b2);
    cp_async16(aux + r * g.ec + cv * 8, src + c0 + cv * 8, true);
  }
}

template <int NREP>
__global__ void __launch_bounds__(kMaxWarps * 32)
mbconv_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                   const bf16* __restrict__ b1, const bf16* __restrict__ wd,
                   const bf16* __restrict__ b2, const bf16* __restrict__ w3,
                   const bf16* __restrict__ b3, bf16* __restrict__ out, const Geo g,
                   int residual) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);                 // (mh, ldx): x on tile + halo
  bf16* w1s = reinterpret_cast<bf16*>(smem + g.off_w1);     // 2 x (cin_p, ldw1)
  bf16* w3s = reinterpret_cast<bf16*>(smem + g.off_w3);     // 2 x (ec, ldw3)
  bf16* aux = reinterpret_cast<bf16*>(smem + g.off_aux);    // 2 x (11, ec)
  bf16* es = reinterpret_cast<bf16*>(smem + g.off_e);       // (nh, lde): expanded chunk
  bf16* ds = reinterpret_cast<bf16*>(smem + g.off_d);       // (mt_tiles*16, lde): depthwise
  bf16* os = es;                                            // (mt_tiles*16, ldo): output
  const int w1_step = round_up(g.w1_buf, 128) / 2, w3_step = round_up(g.w3_buf, 128) / 2;
  const int aux_step = round_up(g.aux_buf, 128) / 2;        // buffer strides in elements

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nthreads = blockDim.x;
  const int y0 = (blockIdx.x / g.tiles_w) * g.th, x0 = (blockIdx.x % g.tiles_w) * g.tw;
  const size_t img = size_t(blockIdx.y) * g.H * g.W;
  const bf16 zero = __float2bfloat16_rn(0.0f);

  // x on the tile + halo (zeros outside the image), then chunk 0's weights:
  // one group of asynchronous copies
  const int vec_ci = g.Cin / 8;
  for (int v = tid; v < g.nh * vec_ci; v += nthreads) {
    const int p = v / vec_ci, cv = v - p * vec_ci;
    const int gy = y0 - 1 + p / g.wp, gx = x0 - 1 + p % g.wp;
    const bool inside = gy >= 0 && gy < g.H && gx >= 0 && gx < g.W;
    cp_async16(xs + p * g.ldx + cv * 8,
               inside ? x + (img + size_t(gy) * g.W + gx) * g.Cin + cv * 8 : x, inside);
  }
  start_chunk_copy(g, 0, w1, wd, b1, b2, w3, w1s, w3s, aux);
  cp_async_commit();
  // what no copy writes is zero: the channels of x past Cin and the rows of
  // w1 past Cin (the mma depth's padding), the halo's padding rows, and the
  // depthwise tile's padding rows
  for (int i = tid; i < g.mh * g.cin_p; i += nthreads) {
    const int p = i / g.cin_p, ch = i - p * g.cin_p;
    if (p >= g.nh || ch >= g.Cin) xs[p * g.ldx + ch] = zero;
  }
  for (int i = tid; i < 2 * (g.cin_p - g.Cin) * g.ec; i += nthreads) {
    const int b = i / ((g.cin_p - g.Cin) * g.ec), j = i % ((g.cin_p - g.Cin) * g.ec);
    w1s[b * w1_step + (g.Cin + j / g.ec) * g.ldw1 + j % g.ec] = zero;
  }
  for (int i = tid; i < (g.mt_tiles * 16 - g.nt) * g.ec; i += nthreads)
    ds[(g.nt + i / g.ec) * g.lde + i % g.ec] = zero;

  // the project accumulator: this warp's 16 tile rows x NREP column tiles
  const int pm = warp % g.mt_tiles, pn0 = (warp / g.mt_tiles) * NREP;
  float acc[NREP][4];
#pragma unroll
  for (int j = 0; j < NREP; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;

  const int e_units = (g.mh / 16) * (g.ec / 16);
  for (int c = 0; c < g.chunks; ++c) {
    cp_async_wait<0>();
    __syncthreads();  // chunk c has landed; every warp is done with chunk c - 1
    const int buf = c & 1;
    if (c + 1 < g.chunks) {  // overlaps with this chunk's work
      const int nb = buf ^ 1;
      start_chunk_copy(g, c + 1, w1, wd, b1, b2, w3, w1s + nb * w1_step, w3s + nb * w3_step,
                  aux + nb * aux_step);
    }
    cp_async_commit();
    const bf16* w1c = w1s + buf * w1_step;
    const bf16* w3c = w3s + buf * w3_step;
    const bf16* auxc = aux + buf * aux_step;

    // 1-2. expand on the tensor cores: 16 halo rows x 16 channels a unit
    for (int u = warp; u < e_units; u += g.warps) {
      const int m0 = (u / (g.ec / 16)) * 16, n0 = (u % (g.ec / 16)) * 16;
      float d[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      for (int k0 = 0; k0 < g.cin_p; k0 += 16) {
        unsigned a[4], b[4];
        ldsm_x4(a, xs + (m0 + (lane & 15)) * g.ldx + k0 + (lane >> 4) * 8);
        ldsm_x4_trans(b, w1c + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * g.ldw1 + n0 +
                             (lane >> 4) * 8);
        mma_16816(d[0], a, b[0], b[1]);
        mma_16816(d[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = m0 + (lane >> 2) + h * 8;
        if (p >= g.nh) continue;
        const int gy = y0 - 1 + p / g.wp, gx = x0 - 1 + p % g.wp;
        const bool inside = gy >= 0 && gy < g.H && gx >= 0 && gx < g.W;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + j * 8 + (lane & 3) * 2;
          const __nv_bfloat162 bias =
              *reinterpret_cast<const __nv_bfloat162*>(auxc + 9 * g.ec + col);
          const float v0 = inside ? relu6_rounded(d[j][2 * h] + __low2float(bias)) : 0.0f;
          const float v1 = inside ? relu6_rounded(d[j][2 * h + 1] + __high2float(bias)) : 0.0f;
          *reinterpret_cast<__nv_bfloat162*>(es + p * g.lde + col) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    __syncthreads();

    // 3-4. depthwise 3x3 on the CUDA cores, two channels a thread
    const int pairs = g.ec / 2;
    for (int i = tid; i < g.nt * pairs; i += nthreads) {
      const int p = i / pairs, col = (i - p * pairs) * 2;
      const int ty = p / g.tw, tx = p - ty * g.tw;
      float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const __nv_bfloat162 e2 = *reinterpret_cast<const __nv_bfloat162*>(
              es + ((ty + dy) * g.wp + tx + dx) * g.lde + col);
          const __nv_bfloat162 k2 =
              *reinterpret_cast<const __nv_bfloat162*>(auxc + (dy * 3 + dx) * g.ec + col);
          a0 = fmaf(__low2float(e2), __low2float(k2), a0);
          a1 = fmaf(__high2float(e2), __high2float(k2), a1);
        }
      const __nv_bfloat162 bias = *reinterpret_cast<const __nv_bfloat162*>(auxc + 10 * g.ec + col);
      *reinterpret_cast<__nv_bfloat162*>(ds + p * g.lde + col) = __floats2bfloat162_rn(
          relu6_rounded(a0 + __low2float(bias)), relu6_rounded(a1 + __high2float(bias)));
    }
    __syncthreads();

    // 5. project partial on the tensor cores, into the f32 accumulator
    for (int k0 = 0; k0 < g.ec; k0 += 16) {
      unsigned a[4];
      ldsm_x4(a, ds + (pm * 16 + (lane & 15)) * g.lde + k0 + (lane >> 4) * 8);
      const bf16* brow = w3c + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * g.ldw3;
#pragma unroll
      for (int j = 0; j < NREP; j += 2) {
        const int n = pn0 + j;
        if (n >= g.nco) break;
        if (j + 1 < NREP && n + 1 < g.nco) {
          unsigned b[4];
          ldsm_x4_trans(b, brow + n * 8 + (lane >> 4) * 8);
          mma_16816(acc[j], a, b[0], b[1]);
          mma_16816(acc[j + 1], a, b[2], b[3]);
        } else {
          unsigned b[2];
          ldsm_x2_trans(b, brow + n * 8);
          mma_16816(acc[j], a, b[0], b[1]);
        }
      }
    }
  }
  __syncthreads();  // the output tile reuses the expanded and depthwise tiles

  // epilogue: bias, round to bf16 into the output tile ...
#pragma unroll
  for (int j = 0; j < NREP; ++j) {
    const int n = pn0 + j;
    if (n >= g.nco) break;
    const int col = n * 8 + (lane & 3) * 2;
    const float bias0 = __bfloat162float(b3[col]), bias1 = __bfloat162float(b3[col + 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = pm * 16 + (lane >> 2) + h * 8;
      *reinterpret_cast<__nv_bfloat162*>(os + p * g.ldo + col) =
          __floats2bfloat162_rn(acc[j][2 * h] + bias0, acc[j][2 * h + 1] + bias1);
    }
  }
  __syncthreads();
  // ... then the residual in bf16 and 16-byte stores
  const int vec_co = g.Cout / 8;
  for (int v = tid; v < g.nt * vec_co; v += nthreads) {
    const int p = v / vec_co, cv = v - p * vec_co;
    const int ty = p / g.tw, tx = p - ty * g.tw;
    const int gy = y0 + ty, gx = x0 + tx;
    if (gy >= g.H || gx >= g.W) continue;
    uint4 o = *reinterpret_cast<const uint4*>(os + p * g.ldo + cv * 8);
    if (residual) {
      const uint4 r =
          *reinterpret_cast<const uint4*>(xs + ((ty + 1) * g.wp + tx + 1) * g.ldx + cv * 8);
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
      const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        o2[q] = __floats2bfloat162_rn(__low2float(o2[q]) + __low2float(r2[q]),
                                      __high2float(o2[q]) + __high2float(r2[q]));
    }
    *reinterpret_cast<uint4*>(out + (img + size_t(gy) * g.W + gx) * g.Cout + cv * 8) = o;
  }
}

cudaError_t smem_optin(int* smem_max) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

template <int NREP>
cudaError_t launch_bf16_nrep(const void* x, const void* w1, const void* b1, const void* wd,
                             const void* b2, const void* w3, const void* b3, void* out, int B,
                             const Geo& g, int residual, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mbconv_bf16_kernel<NREP>, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((g.H + g.th - 1) / g.th) * g.tiles_w, B);
  mbconv_bf16_kernel<NREP><<<grid, g.warps * 32, g.smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(wd), static_cast<const bf16*>(b2), static_cast<const bf16*>(w3),
      static_cast<const bf16*>(b3), static_cast<bf16*>(out), g, residual);
  return cudaGetLastError();
}

// The geometry for (shape, config); a config field of 0 takes bf16_config's.
cudaError_t bf16_geo(int H, int W, int Cin, int E, int Cout, int th, int tw, int ec, int nrep,
                     Geo* g) {
  Bf16Config c = bf16_config(Cin, E, Cout);
  if (th > 0 || tw > 0 || ec > 0 || nrep > 0) {
    if (th > 0) c.th = th;
    if (tw > 0) c.tw = tw;
    if (ec > 0) c.ec = ec;
    if (nrep > 0) c.nrep = nrep;
  }
  int smem_max = 0;
  cudaError_t err = smem_optin(&smem_max);
  if (err != cudaSuccess) return err;
  return make_geo(H, W, Cin, E, Cout, c, smem_max, g) ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t launch_bf16(const void* x, const void* w1, const void* b1, const void* wd,
                        const void* b2, const void* w3, const void* b3, void* out, int B, int H,
                        int W, int Cin, int E, int Cout, int residual, int th, int tw, int ec,
                        int nrep, cudaStream_t stream) {
  Geo g;
  cudaError_t err = bf16_geo(H, W, Cin, E, Cout, th, tw, ec, nrep, &g);
  if (err != cudaSuccess) return err;
  switch (g.nrep) {
#define SSDSEG_NREP_CASE(N) \
  case N:                   \
    return launch_bf16_nrep<N>(x, w1, b1, wd, b2, w3, b3, out, B, g, residual, stream);
    SSDSEG_NREP_CASE(1) SSDSEG_NREP_CASE(2) SSDSEG_NREP_CASE(3) SSDSEG_NREP_CASE(4)
    SSDSEG_NREP_CASE(5) SSDSEG_NREP_CASE(6) SSDSEG_NREP_CASE(8) SSDSEG_NREP_CASE(10)
#undef SSDSEG_NREP_CASE
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  th, tw, ec, nrep: the bf16 kernel's
// tile, chunk of E and column tiles per warp, 0 for the built-in choice
// (ignored in f32).  Returns a cudaError_t (0 on success).
extern "C" int fused_mbconv_launch(int dtype, const void* x, const void* w1, const void* b1,
                                   const void* wd, const void* b2, const void* w3,
                                   const void* b3, void* out, int B, int H, int W, int Cin,
                                   int E, int Cout, int residual, int th, int tw, int ec,
                                   int nrep, void* stream) {
  if (B > 65535) return cudaErrorInvalidValue;  // gridDim.y limit
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(x, w1, b1, wd, b2, w3, b3, out, B, H, W, Cin, E, Cout, residual, s);
  if (dtype == 1)
    return launch_bf16(x, w1, b1, wd, b2, w3, b3, out, B, H, W, Cin, E, Cout, residual, th, tw,
                       ec, nrep, s);
  return cudaErrorInvalidValue;
}

// What the launcher picks for (dtype, Cin, E, Cout), for reports: the tile,
// the chunk of E (E itself in f32), the threads of a CTA and its bytes of
// dynamic shared memory.  Returns a cudaError_t (0 on success).
extern "C" int fused_mbconv_tile(int dtype, int Cin, int E, int Cout, int* th, int* tw,
                                 int* ec, int* threads, int* smem) {
  if (dtype == 0) {
    size_t bytes = 0;
    const cudaError_t err = pick_tile(Cin, E, th, tw, &bytes);
    *ec = E, *threads = kThreads, *smem = int(bytes);
    return err;
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  Geo g;
  const cudaError_t err = bf16_geo(1, 1, Cin, E, Cout, 0, 0, 0, 0, &g);
  if (err != cudaSuccess) return err;
  *th = g.th, *tw = g.tw, *ec = g.ec, *threads = g.warps * 32, *smem = g.smem;
  return cudaSuccess;
}

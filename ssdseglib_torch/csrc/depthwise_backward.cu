// Backward of a SAME stride-1 3x3 depthwise convolution for Hopper (sm_90a):
// input gradient and weight gradient in one launch, one pass over x and dy.
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
// once, 3 n elem bytes, against 36 FLOPs an element on the CUDA cores (at the
// training path's (16, 240, 320, 32) bf16: 0.070 ms of bytes against 0.021 ms
// of FLOPs at 67 TFLOP/s).  A library route runs two convolutions and reads
// dy twice.  So the design keeps bytes in flight and touches each once:
//
// - persistent CTAs, as many as fit the card, `blockIdx.y` a chunk of at most
//   kMaxChunk channels; CTA i of a chunk walks the chunk's tr x tw tiles i,
//   i + G, ... over all images (G = CTAs of a chunk);
// - x and dy on the next tile plus its one-pixel halo arrive by 16-byte
//   cp.async (zero fill outside the image and past C: the convolution's
//   padding, so no padded copy is made) into the second of two buffers while
//   the CTA works on this one.  Both stay in the I/O dtype in shared memory;
// - each thread takes two channels of one column and walks down its rows
//   with the 3 x 3 windows of dy and x in registers, three rows a step so
//   that the windows rotate by name; dx is three independent tap-row sums,
//   rounded once; the nine taps of dk stay in registers over all the
//   thread's tiles;
// - dk in the same launch: each CTA sums its threads' taps in thread order
//   into one (9, cc) partial, and the chunk's CTAs meet in `finish`
//   (common.cuh), whose order is fixed by the grid: the same bits every run.
//
// Where C is not a multiple of the 16-byte vector (8 bf16, 4 f32) the rows are
// not 16-byte aligned: the CTA stages one tile at a time by scalar loads and
// a thread takes one channel.  The tile and the chunk are runtime arguments
// (the built-in choice comes from an A/B on the H100, PERF.md,
// `chip_smoke.py --dw-variants`).
//
// Layout: x, dy, dx (B, H, W, C) NHWC contiguous in the I/O dtype (float32 or
// bfloat16), 16-byte aligned; taps k in f32 or bf16, tap t = 3 i + j of channel
// c at k[t * kts + c * kcs] (a (3, 3, 1, C) kernel or the HWIO view of a
// (C, 1, 3, 3) weight, read in place); dk (9, C) f32;
// scratch and counters as depthwise_backward_scratch sizes them, the counters
// zero before the first launch (each launch leaves them zero).

#include "common.cuh"

namespace {

using ssdseg::cp_async16;
using ssdseg::cp_async_commit;
using ssdseg::cp_async_wait;
using ssdseg::finish;
using ssdseg::finish_counters;
using ssdseg::finish_group;
using ssdseg::from_f;
using ssdseg::next_pow2;
using ssdseg::to_f;
using ssdseg::Vec;

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;  // channels of a CTA at most
constexpr int kChunk = 32;     // the built-in chunk
constexpr int kTileRows = 16, kTileCols = 16;  // the built-in tile

// Where the CTAs work, and the shapes they derive from.  Built on the host.
struct DwGeo {
  int H, W, C;
  int tr, tw;    // tile rows and columns
  int cc;        // channels of a chunk: a power of two <= kMaxChunk
  int cc_log2;
  int chunks;
  int tiles_w, tiles_h, tiles;  // tiles of an image in each direction; tiles of a chunk
  int ctas;      // CTAs of a chunk
  int group;     // `finish` group of a chunk's CTAs
  int plane;     // bytes of one (tr + 2, tw + 2, cc) plane, a multiple of 16
  int smem;
  unsigned wp_magic;  // ceil(2^32 / (tw + 2)): a halo pixel's row by __umulhi
};

// Two channels of shared memory as f32.
__device__ __forceinline__ void load2(const float* p, float (&f)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  f[0] = v.x, f[1] = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float (&f)[2]) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  f[0] = __low2float(v), f[1] = __high2float(v);
}

// VEC: the tiles are double-buffered by cp.async and a stencil thread takes
// two channels; else one buffer, scalar loads and one channel.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
dw_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, const void* __restrict__ kern,
              int kern_bf16, int kts, int kcs, T* __restrict__ dx, float* __restrict__ dk,
              float* __restrict__ partials, int* __restrict__ counters, const DwGeo g) {
  constexpr int V = VEC ? Vec<T>::n : 1;  // channels a staging step
  constexpr int PV = VEC ? 2 : 1;         // channels a stencil thread
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ticket;
  const int tid = threadIdx.x;
  const int cc = g.cc, wp = g.tw + 2;
  const int npix = (g.tr + 2) * wp;
  const int chunk = blockIdx.y, c0 = chunk * cc;
  const int per_image = g.tiles_h * g.tiles_w;
  constexpr int kVLog2 = V == 8 ? 3 : V == 4 ? 2 : 0;
  const int cv_log2 = g.cc_log2 - kVLog2;  // channel vectors of a pixel: 1 << cv_log2

  // x then dy of tile t on the tile + halo into buffer b, zeros outside the
  // image and past C
  auto stage = [&](int t, int b) {
    const int image = t / per_image, ty = (t % per_image) / g.tiles_w, tx = t % g.tiles_w;
    const size_t img = size_t(image) * g.H * g.W;
    T* xs = reinterpret_cast<T*>(smem + size_t(2 * b) * g.plane);
    T* gs = reinterpret_cast<T*>(smem + size_t(2 * b + 1) * g.plane);
    for (int v = tid; v < npix << cv_log2; v += kThreads) {
      const int pix = v >> cv_log2, j = v & ((1 << cv_log2) - 1);
      const int ly = __umulhi(pix, g.wp_magic), lx = pix - ly * wp;
      const int gy = ty * g.tr - 1 + ly, gx = tx * g.tw - 1 + lx, c = c0 + j * V;
      const bool inside = gy >= 0 && gy < g.H && gx >= 0 && gx < g.W && c < g.C;
      const size_t idx = inside ? (img + size_t(gy) * g.W + gx) * g.C + c : 0;
      if constexpr (VEC) {
        cp_async16(xs + v * V, x + idx, inside);
        cp_async16(gs + v * V, dy + idx, inside);
      } else {
        xs[v] = inside ? x[idx] : from_f<T>(0.0f);
        gs[v] = inside ? dy[idx] : from_f<T>(0.0f);
      }
    }
  };

  // the thread's stencil channels, their taps and dk sums (over all tiles)
  const int ng_log2 = g.cc_log2 - (PV == 2 ? 1 : 0);  // channel groups: 1 << ng_log2
  const int ngroups = 1 << ng_log2;
  const int ch = (tid & (ngroups - 1)) * PV, c = c0 + ch;
  float kk[9][PV], acc[9][PV];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int p = 0; p < PV; ++p) {
      const size_t ki = size_t(t) * kts + size_t(c + p) * kcs;
      kk[t][p] = c + p >= g.C ? 0.0f
                 : kern_bf16  ? __bfloat162float(static_cast<const __nv_bfloat16*>(kern)[ki])
                              : static_cast<const float*>(kern)[ki];
      acc[t][p] = 0.0f;
    }
  const int row = wp * cc;  // elements between two halo rows

  int tile = blockIdx.x;
  if constexpr (VEC) {
    if (tile < g.tiles) stage(tile, 0);
    cp_async_commit();
  }
  for (int it = 0; tile < g.tiles; ++it, tile += gridDim.x) {
    const int image = tile / per_image, ty = (tile % per_image) / g.tiles_w;
    const int y0 = ty * g.tr, x0 = (tile % g.tiles_w) * g.tw;
    const size_t img = size_t(image) * g.H * g.W;
    const int b = VEC ? it & 1 : 0;
    if constexpr (VEC) {
      if (tile + int(gridDim.x) < g.tiles) stage(tile + gridDim.x, b ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // this tile has landed; the next one is in flight
    } else {
      stage(tile, 0);
    }
    __syncthreads();
    const T* xs = reinterpret_cast<const T*>(smem + size_t(2 * b) * g.plane);
    const T* gs = reinterpret_cast<const T*>(smem + size_t(2 * b + 1) * g.plane);

    // A thread keeps PV channels of one column and walks down its rows with
    // the 3 x 3 windows of dy and x in registers.  kThreads is a multiple of
    // the channel groups, so a thread's channels never change.
    if (c < g.C) {
      for (int l = tid; l < g.tw * ngroups; l += kThreads) {
        const int q = (l >> ng_log2) + 1;  // column of the centre pixel in the halo tile
        const int gx = x0 + q - 1;
        if (gx >= g.W) break;
        const int base = (q - 1) * cc + ch;  // halo row 0, column q - 1
        float g0[3][PV], g1[3][PV], g2[3][PV], xa[3][PV], xb[3][PV], xc[3][PV];
        auto load = [&](float (&gw)[3][PV], float (&xw)[3][PV], int r) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const int at = base + r * row + j * cc;
            if constexpr (PV == 2) {
              load2(gs + at, gw[j]);
              load2(xs + at, xw[j]);
            } else {
              gw[j][0] = to_f<T>(gs[at]);
              xw[j][0] = to_f<T>(xs[at]);
            }
          }
        };
        // row r of the tile from halo rows r - 1 (ga, xa_), r (gb, xb_), r + 1
        // (gc, xc_): one independent dx sum per tap row, then the three added
        auto step = [&](const float (&ga)[3][PV], const float (&gb)[3][PV],
                        const float (&gc)[3][PV], const float (&xa_)[3][PV],
                        const float (&xb_)[3][PV], const float (&xc_)[3][PV], int r) {
          float v[PV];
#pragma unroll
          for (int p = 0; p < PV; ++p) {
            // tap (i, j) reads dy at row r + 1 - i, column q + 1 - j
            float s0 = kk[0][p] * gc[2][p], s1 = kk[3][p] * gb[2][p], s2 = kk[6][p] * ga[2][p];
            s0 = fmaf(kk[1][p], gc[1][p], s0), s1 = fmaf(kk[4][p], gb[1][p], s1);
            s2 = fmaf(kk[7][p], ga[1][p], s2);
            s0 = fmaf(kk[2][p], gc[0][p], s0), s1 = fmaf(kk[5][p], gb[0][p], s1);
            s2 = fmaf(kk[8][p], ga[0][p], s2);
            v[p] = (s0 + s1) + s2;
            // tap (i, j) reads x at row r + i - 1, column q + j - 1
            const float gcen = gb[1][p];
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              acc[j][p] = fmaf(xa_[j][p], gcen, acc[j][p]);
              acc[3 + j][p] = fmaf(xb_[j][p], gcen, acc[3 + j][p]);
              acc[6 + j][p] = fmaf(xc_[j][p], gcen, acc[6 + j][p]);
            }
          }
          T* out = dx + (img + size_t(y0 + r - 1) * g.W + gx) * g.C + c;
          if constexpr (PV == 2) {
            if constexpr (sizeof(T) == 2)
              *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v[0], v[1]);
            else
              *reinterpret_cast<float2*>(out) = make_float2(v[0], v[1]);
          } else {
            *out = from_f<T>(v[0]);
          }
        };
        const int rows = min(g.tr, g.H - y0);
        load(g0, xa, 0);
        load(g1, xb, 1);
        int r = 1;
        for (; r + 2 <= rows; r += 3) {  // three rows: the windows rotate by name
          load(g2, xc, r + 1);
          step(g0, g1, g2, xa, xb, xc, r);
          load(g0, xa, r + 2);
          step(g1, g2, g0, xb, xc, xa, r + 1);
          load(g1, xb, r + 3);
          step(g2, g0, g1, xc, xa, xb, r + 2);
        }
        for (; r <= rows; ++r) {
          load(g2, xc, r + 1);
          step(g0, g1, g2, xa, xb, xc, r);
#pragma unroll
          for (int j = 0; j < 3; ++j)
#pragma unroll
            for (int p = 0; p < PV; ++p) {
              g0[j][p] = g1[j][p], g1[j][p] = g2[j][p];
              xa[j][p] = xb[j][p], xb[j][p] = xc[j][p];
            }
        }
      }
    }
    __syncthreads();  // this buffer is free for the copy two tiles on
  }

  // the threads that share a channel group, summed in thread order, into this
  // CTA's (9, cc) partial; then the chunk's CTAs meet in `finish`
  if constexpr (VEC) cp_async_wait<0>();  // nothing may still land in the buffers
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int p = 0; p < PV; ++p) red[(t * PV + p) * kThreads + tid] = acc[t][p];
  __syncthreads();
  const int M = 9 * cc;
  float* chunk_partials = partials + size_t(chunk) * gridDim.x * M;
  for (int o = tid; o < M; o += kThreads) {
    const int t = o >> g.cc_log2, cl = o & (cc - 1);
    const int grp = cl / PV, p = cl - grp * PV;
    float s = 0.0f;
    for (int i = grp; i < kThreads; i += ngroups) s += red[(t * PV + p) * kThreads + i];
    chunk_partials[size_t(blockIdx.x) * M + o] = s;
  }
  finish(chunk_partials, counters + chunk * finish_counters(gridDim.x, g.group), gridDim.x,
         blockIdx.x, M, g.group, ticket, [&](int e, float total) {
           const int t = e >> g.cc_log2, cl = e & (cc - 1);
           if (c0 + cl < g.C) dk[t * g.C + c0 + cl] = total;
         });
}

// The geometry for (shape, tile, chunk) on the current device: shared memory
// from the tile, CTAs a chunk from the kernel's occupancy, or `ctas` when
// positive (what an earlier call found for the same arguments: the queries
// are skipped).
template <typename T, bool VEC>
cudaError_t make_geo(int B, int H, int W, int C, int tr, int tw, int chunk, int ctas, DwGeo* g) {
  if (tr < 1 || tw < 1 || chunk < 1 || chunk > kMaxChunk) return cudaErrorInvalidValue;
  g->H = H, g->W = W, g->C = C, g->tr = tr, g->tw = tw;
  g->cc = next_pow2(C < chunk ? C : chunk);
  if (VEC && g->cc < Vec<T>::n) g->cc = Vec<T>::n;  // a whole vector a staging step
  g->cc_log2 = 0;
  while ((1 << g->cc_log2) < g->cc) ++g->cc_log2;
  g->wp_magic = unsigned((0x100000000ULL + tw + 1) / (tw + 2));
  g->chunks = (C + g->cc - 1) / g->cc;
  g->tiles_w = (W + tw - 1) / tw;
  g->tiles_h = (H + tr - 1) / tr;
  const long long tiles = (long long)B * g->tiles_h * g->tiles_w;
  if (tiles > 0x7fffffff || g->chunks > 65535) return cudaErrorInvalidValue;
  g->tiles = int(tiles);
  const size_t plane = (size_t(tr + 2) * (tw + 2) * g->cc * sizeof(T) + 15) / 16 * 16;
  const size_t buffers = (VEC ? 2 : 1) * 2 * plane;           // x and dy, one or two tiles
  const size_t red = size_t(9) * (VEC ? 2 : 1) * kThreads * 4;  // the threads' dk sums
  const size_t bytes = buffers > red ? buffers : red;
  g->plane = int(plane);
  g->smem = int(bytes);
  // refused past the device's opt-in shared memory
  cudaError_t err = cudaFuncSetAttribute(
      dw_bwd_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, g->smem);
  if (err != cudaSuccess) return err;
  if (ctas <= 0) {
    int device = 0, sms = 0, resident = 0;
    err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, dw_bwd_kernel<T, VEC>,
                                                        kThreads, g->smem);
    if (err != cudaSuccess) return err;
    if (resident < 1) return cudaErrorInvalidConfiguration;
    ctas = resident * sms / g->chunks;
  }
  g->ctas = ctas < 1 ? 1 : ctas < g->tiles ? ctas : g->tiles;
  g->group = finish_group(g->ctas);
  return cudaSuccess;
}

template <typename T>
bool vec_path(int C) { return C % Vec<T>::n == 0; }

template <typename T>
cudaError_t geometry(int B, int H, int W, int C, int tr, int tw, int chunk, int ctas,
                     DwGeo* g) {
  if (tr <= 0) tr = kTileRows;
  if (tw <= 0) tw = kTileCols;
  if (chunk <= 0) chunk = kChunk;
  return vec_path<T>(C) ? make_geo<T, true>(B, H, W, C, tr, tw, chunk, ctas, g)
                        : make_geo<T, false>(B, H, W, C, tr, tw, chunk, ctas, g);
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, const void* kern, int kern_bf16, int kts,
                   int kcs, void* dx, float* dk, float* partials, int* counters, int B, int H,
                   int W, int C, int tr, int tw, int chunk, int ctas, cudaStream_t stream) {
  DwGeo g;
  cudaError_t err = geometry<T>(B, H, W, C, tr, tw, chunk, ctas, &g);
  if (err != cudaSuccess) return err;
  auto kernel = vec_path<T>(C) ? dw_bwd_kernel<T, true> : dw_bwd_kernel<T, false>;
  kernel<<<dim3(g.ctas, g.chunks), kThreads, g.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), kern, kern_bf16, kts, kcs,
      static_cast<T*>(dx), dk, partials, counters, g);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int W, int C) { return B < 1 || H < 1 || W < 1 || C < 1; }

}  // namespace

// The scratch of a launch below with the same arguments: *floats f32 values
// and *counters int32 counters (zero before the first launch; each launch
// leaves them zero); geo, when not null, receives (tile rows, tile columns,
// chunk, CTAs a chunk, shared bytes a CTA).  tr, tw, chunk: 0 for the
// built-in choice.  Returns a cudaError_t (0 on success).
extern "C" int depthwise_backward_scratch(int dtype, int B, int H, int W, int C, int tr, int tw,
                                          int chunk, long long* floats, int* counters, int* geo) {
  if (bad_shape(B, H, W, C) || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
  DwGeo g;
  const cudaError_t err = dtype == 0 ? geometry<float>(B, H, W, C, tr, tw, chunk, 0, &g)
                                     : geometry<__nv_bfloat16>(B, H, W, C, tr, tw, chunk, 0, &g);
  if (err != cudaSuccess) return err;
  *floats = (long long)g.chunks * g.ctas * 9 * g.cc;
  *counters = g.chunks * finish_counters(g.ctas, g.group);
  if (geo != nullptr) {
    geo[0] = g.tr, geo[1] = g.tw, geo[2] = g.cc, geo[3] = g.ctas, geo[4] = g.smem;
  }
  return cudaSuccess;
}

// One launch.  dtype: 0 = float32, 1 = bfloat16 (x, dy, dx); kern_bf16: the
// taps' dtype (0 f32, 1 bf16), tap t of channel c at kern[t * kts + c * kcs];
// dk (9, C) f32 out; ctas: the CTAs a chunk that depthwise_backward_scratch
// gave for the same arguments on this device, or 0 to find them again.
// Returns a cudaError_t (0 on success).
extern "C" int depthwise_backward_launch(int dtype, const void* x, const void* dy,
                                         const void* kern, int kern_bf16, int kts, int kcs,
                                         void* dx, void* dk, void* scratch, void* counters, int B,
                                         int H, int W, int C, int tr, int tw, int chunk, int ctas,
                                         void* stream) {
  if (bad_shape(B, H, W, C)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto dkf = static_cast<float*>(dk);
  auto pf = static_cast<float*>(scratch);
  auto ct = static_cast<int*>(counters);
  if (dtype == 0)
    return launch<float>(x, dy, kern, kern_bf16, kts, kcs, dx, dkf, pf, ct, B, H, W, C, tr, tw,
                         chunk, ctas, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dy, kern, kern_bf16, kts, kcs, dx, dkf, pf, ct, B, H, W, C,
                                 tr, tw, chunk, ctas, s);
  return cudaErrorInvalidValue;
}

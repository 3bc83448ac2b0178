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
//              A = gamma * inv, Bc = A * (dbeta / N), D = A * (dgamma / N)
//     dx     = corr3x3(du, flipped k);  dk[i,j] = sum x[t+i-1, w+j-1] * du[t,w]
//
// Rounding points, shared with the plain PyTorch version: z is computed in
// f32 with separately rounded multiply and add (no fused multiply-add), cast
// to the I/O dtype and compared there; mean, inv, A and beta are the very
// tensors the forward computed z with, so a bf16 run masks exactly the
// elements the forward clipped.  Everything else is f32, dx is rounded once.
//
// What bounds it on the H100: bytes.  dbeta and dgamma must be known before
// any du, and u plus dy at the training path's shape (157 MB in bf16) do not
// fit the 50 MB L2, so u and dy cross device memory twice: 6 reads or writes
// of an activation-sized tensor in all (pass 1: u, dy; pass 2: x, u, dy, dx).
// xhat, the mask, dz and du are recomputed per tile and live only in shared
// memory, so none of the chain's intermediates crosses device memory.
//
// Two launches, and no other device work between or after them:
//   pass 1 (`chain_sums_kernel`): a CTA walks a contiguous range of pixels,
//     16 bytes of u and of dy a thread a step (V = 8 bf16 or 4 f32 channels;
//     one channel a step where C is not a multiple of V), and sums dz and
//     dz * xhat per channel; the CTAs' partials meet in `finish` (common.cuh),
//     whose last CTA writes dbeta, dgamma and Bc, D;
//   pass 2 (`chain_bwd_kernel`): persistent CTAs, as many as fit the card,
//     each walking every G-th tr x tw tile of one chunk of at most 32
//     channels.  x, u and dy on the next tile plus its one-pixel halo arrive
//     by cp.async (16 bytes a copy, zero fill outside the image) into the
//     second of two buffers while the CTA works on this one.  du is computed
//     from the shared copy in place of u and dy (a vector of du takes the 32
//     bytes that held the same channels of u and dy); outside the image du is
//     ZERO, not -Bc: there it is the padding of the correlation.  Then each
//     thread takes two channels of one column and walks down its rows with
//     the 3 x 3 windows of du and x in registers (three rows a step, so the
//     windows rotate by name), writing dx and adding the nine taps of dk to
//     sums it keeps over all its tiles; the chunk's CTAs meet in `finish`,
//     which writes dk.
// Under data parallelism (several ranks, each holding a slice of the batch)
// dbeta and dgamma are sums over the GLOBAL batch, so the cross-rank sum has
// to fall between the two passes.  The split entry points run them apart:
// `chain_backward_sums` is pass 1 alone, writing the rank's (dbeta, dgamma)
// and no coefficients; the caller all-reduces them on the stream; then
// `chain_backward_apply` is pass 2 on the global sums and the global pixel
// count N, forming Bc and D at its head, per CTA, from the same expression
// pass 1's `finish` uses, so a group of one gives the two-launch path's bits.
// On a mesh that splits the image rows (`parallel/spatial.py`) the chain
// runs on a rank's window: x, u and dy hold the rank's own rows plus one halo
// row at each end, dy zero in the halo rows (so pass 1 sums the own rows
// only), and `chain_backward_apply` confines du to the own rows [lo, hi)
// of the window: du is the BatchNorm gradient of the own rows, nonzero where
// dz is zero, so zero rows of dy alone would leave -Bc - D * xhat in the halo.
// dx then covers the window (its halo rows go back to their owners) and dk
// sums the own rows' products.
// Every sum is taken in an order fixed by the grid, so the bits repeat from
// run to run.  Where C is not a multiple of V the rows are not 16-byte
// aligned and both passes take their scalar paths.  The tile (tr, tw) is a
// runtime argument (the built-in choice comes from an A/B on the H100,
// PERF.md, `chip_smoke.py --chain-variants`).
//
// Layout: x, u, dy, dx (B, H, W, C) NHWC contiguous in the I/O dtype (float32
// or bfloat16), 16-byte aligned; taps k in f32 or bf16, tap t of channel c at
// k[t * kts + c * kcs]; mean, inv, A, beta (C,) f32; sums (2, C) f32 = dbeta,
// dgamma; dk (9, C) f32; scratch and counters as chain_backward_scratch sizes
// them, the counters zero before the first launch (each launch leaves them
// zero).

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
constexpr int kMaxChunk = 32;    // channels of a pass-2 CTA
constexpr int kSumsCtas = 528;   // pass 1's grid at most (4 an SM)
constexpr int kSumsMinRows = 256;
constexpr int kTileRows = 12, kTileCols = 16;  // the built-in pass-2 tile

struct Coef {
  const float *mean, *inv, *a, *beta;
};

struct ChannelCoef {
  float mean, inv, a, beta;
};

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

// Bc = A * (dbeta / N) or D = A * (dgamma / N): pass 1's `finish` and the
// head of the split pass 2 form them alike.
__device__ __forceinline__ float bc_or_d(float a, float total, float n) {
  return __fmul_rn(a, __fdiv_rn(total, n));
}

// V channels (V = 1: one) of element `idx` of u and dy, as f32.
template <typename T, int V>
__device__ __forceinline__ void load_u_dy(const T* __restrict__ u, const T* __restrict__ dy,
                                          size_t idx, float (&uf)[V], float (&gf)[V]) {
  if constexpr (V == 1) {
    uf[0] = to_f<T>(u[idx]);
    gf[0] = to_f<T>(dy[idx]);
  } else {
    Vec<T>::unpack(*reinterpret_cast<const uint4*>(u + idx), uf);
    Vec<T>::unpack(*reinterpret_cast<const uint4*>(dy + idx), gf);
  }
}

// Pass 1: dbeta = sum dz and dgamma = sum dz * xhat over pixels [p0, p1) of
// the CTA, V channels a thread; then `finish` writes sums = (dbeta, dgamma)
// and, unless bcd is null (the split path), bcd = (Bc, D).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
chain_sums_kernel(const T* __restrict__ u, const T* __restrict__ dy, Coef cf,
                  float* __restrict__ sums, float* __restrict__ bcd,
                  float* __restrict__ partials, int* __restrict__ counters, long long P, int C,
                  long long rows_per_cta, int group) {
  __shared__ float red[2 * V * kThreads];
  __shared__ int ticket;
  const int tid = threadIdx.x;
  const int G = C / V;                       // channel vectors of a pixel
  const int cw = G < kThreads ? G : kThreads;  // vectors one step covers
  const int step = kThreads / cw;            // pixels one step covers
  const int lanes = step * cw;
  const long long p0 = blockIdx.x * rows_per_cta;
  const long long p1 = p0 + rows_per_cta < P ? p0 + rows_per_cta : P;
  float* mine = partials + size_t(blockIdx.x) * 2 * C;
  for (int g0 = 0; g0 < G; g0 += cw) {
    const int g = g0 + tid % cw;
    const bool active = tid < lanes && g < G;
    float s[V], t[V];
    ChannelCoef k[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s[j] = t[j] = 0.0f;
      const int c = active ? g * V + j : 0;
      k[j] = {cf.mean[c], cf.inv[c], cf.a[c], cf.beta[c]};
    }
    if (active) {
#pragma unroll 4
      for (long long p = p0 + tid / cw; p < p1; p += step) {
        float uf[V], gf[V];
        load_u_dy<T, V>(u, dy, size_t(p) * C + g * V, uf, gf);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float dz, xhat;
          dz_xhat<T>(uf[j], gf[j], k[j], &dz, &xhat);
          s[j] += dz;
          t[j] = fmaf(dz, xhat, t[j]);
        }
      }
    }
    // the threads that share a channel vector, summed in thread order
#pragma unroll
    for (int j = 0; j < V; ++j) {
      red[j * kThreads + tid] = s[j];
      red[(V + j) * kThreads + tid] = t[j];
    }
    __syncthreads();
    for (int o = tid; o < 2 * cw * V; o += kThreads) {
      const int which = o / (cw * V), r = o - which * cw * V;
      const int gl = r / V, j = r - gl * V;
      if (g0 + gl >= G) continue;
      float acc = 0.0f;
      for (int i = gl; i < lanes; i += cw) acc += red[(which * V + j) * kThreads + i];
      mine[which * C + (g0 + gl) * V + j] = acc;
    }
    __syncthreads();
  }
  const float n = float(P);
  finish(partials, counters, int(gridDim.x), int(blockIdx.x), 2 * C, group, ticket,
         [&](int e, float total) {
           const int c = e < C ? e : e - C;
           sums[e] = total;
           if (bcd != nullptr) bcd[e] = bc_or_d(cf.a[c], total, n);
         });
}

// Where the pass-2 CTAs work, and the shapes they derive from.  Built on the
// host.
struct ChainGeo {
  int B, H, W, C;
  int lo, hi;     // the rows whose du is computed; du is zero outside them
  int tr, tw;     // tile rows and columns
  int cc;         // channels of a chunk: a power of two <= kMaxChunk
  int chunks;
  int tiles_w, tiles_h, tiles;  // tiles of an image in each direction; tiles of a chunk
  int ctas;       // CTAs of a chunk: CTA i walks tiles i, i + ctas, ...
  int group;      // `finish` group of a chunk's CTAs
  int buf;        // bytes of one tile buffer
  int smem;
  unsigned wp_magic;  // ceil(2^32 / (tw + 2)): a halo pixel's row by __umulhi
  int cc_log2;
};

// Bytes of the x tile, rounded up to 16 so that what follows is aligned.
__host__ __device__ inline size_t x_bytes(size_t elems, size_t elem) {
  return (elems * elem + 15) / 16 * 16;
}

// Bytes of the chunk's six coefficient rows, rounded up to 16.
__host__ __device__ inline size_t coef_bytes(int cc) { return (size_t(6) * cc * 4 + 15) / 16 * 16; }

// Pass 2: a persistent CTA walks the tiles of one channel chunk.  For each,
// du on the tile + halo in shared memory, then dx and this CTA's running dk
// sums; `finish` over the chunk's CTAs writes dk.  bcd holds (Bc, D) when
// sums_n is 0; in the split path it holds the global (dbeta, dgamma) over
// sums_n pixels, and the CTA forms Bc and D from them.  VEC: the next
// tile's x, u and dy arrive by cp.async (16 bytes a copy) into the second
// buffer while this one is worked on, and the stencil takes two channels a
// thread; else one channel, scalar loads.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
chain_bwd_kernel(const T* __restrict__ x, const T* __restrict__ u, const T* __restrict__ dy,
                 const void* __restrict__ kern, int kern_bf16, int kts, int kcs, Coef cf,
                 const float* __restrict__ bcd, float sums_n, T* __restrict__ dx,
                 float* __restrict__ dk, float* __restrict__ partials, int* __restrict__ counters,
                 const ChainGeo g) {
  constexpr int V = VEC ? Vec<T>::n : 1;  // channels a staging step
  constexpr int PV = VEC ? 2 : 1;         // channels a stencil thread
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ticket;
  const int tid = threadIdx.x;
  const int cc = g.cc, wp = g.tw + 2;
  const int npix = (g.tr + 2) * wp;
  const int chunk = blockIdx.y, c0 = chunk * cc;
  float* cfs = reinterpret_cast<float*>(smem);  // (6, cc): mean, inv, A, beta, Bc, D
  unsigned char* bufs = smem + coef_bytes(cc);  // VEC: two tile buffers
  const size_t xb = x_bytes(size_t(npix) * cc, sizeof(T));
  // du of (pixel, channel): a vector of V channels takes 32 bytes (8 floats)
  // in VEC, so a pixel's du spans 8 cc / V floats; dense in the scalar path
  const int dps = VEC ? 8 * cc / V : cc;
  const int per_image = g.tiles_h * g.tiles_w;
  constexpr int kVLog2 = V == 8 ? 3 : V == 4 ? 2 : 0;
  const int cv_log2 = g.cc_log2 - kVLog2;  // channel vectors of a pixel: 1 << cv_log2

  for (int i = tid; i < 6 * cc; i += kThreads) {  // 0 past C
    const int r = i / cc, c = c0 + i - r * cc;
    const float* src = r == 0 ? cf.mean : r == 1 ? cf.inv : r == 2 ? cf.a : r == 3 ? cf.beta
                                                                               : bcd + (r - 4) * g.C;
    const bool from_sums = r >= 4 && sums_n != 0.0f;  // the split path's Bc and D
    cfs[i] = c >= g.C ? 0.0f : from_sums ? bc_or_d(cf.a[c], src[c], sums_n) : src[c];
  }

  // x, u, dy of tile t on the tile + halo into buffer b, 16 bytes a copy,
  // zeros outside the image and past C; u and dy of a vector side by side
  auto stage = [&](int t, int b) {
    const int image = t / per_image, ty = (t % per_image) / g.tiles_w, tx = t % g.tiles_w;
    const size_t img = size_t(image) * g.H * g.W;
    unsigned char* buf = bufs + size_t(b) * g.buf;
    T* xs = reinterpret_cast<T*>(buf);
    unsigned char* uds = buf + xb;
    for (int v = tid; v < npix << cv_log2; v += kThreads) {
      const int pix = v >> cv_log2, j = v & ((1 << cv_log2) - 1);
      const int ly = __umulhi(pix, g.wp_magic), lx = pix - ly * wp;
      const int gy = ty * g.tr - 1 + ly, gx = tx * g.tw - 1 + lx, c = c0 + j * V;
      const bool inside = gy >= 0 && gy < g.H && gx >= 0 && gx < g.W && c < g.C;
      const size_t idx = inside ? (img + size_t(gy) * g.W + gx) * g.C + c : 0;
      cp_async16(xs + pix * cc + j * V, x + idx, inside);
      cp_async16(uds + size_t(v) * 32, u + idx, inside);
      cp_async16(uds + size_t(v) * 32 + 16, dy + idx, inside);
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
    for (int k = 0; k < PV; ++k) {
      const size_t ki = size_t(t) * kts + size_t(c + k) * kcs;
      kk[t][k] = c + k >= g.C ? 0.0f
                 : kern_bf16  ? __bfloat162float(static_cast<const __nv_bfloat16*>(kern)[ki])
                              : static_cast<const float*>(kern)[ki];
      acc[t][k] = 0.0f;
    }
  const int du_ch = VEC ? 8 * (ch / V) + ch % V : ch;  // du offset of the first channel
  const int row_du = wp * dps, row_x = wp * cc;      // one halo row further

  int tile = blockIdx.x;
  if constexpr (VEC) {
    if (tile < g.tiles) stage(tile, 0);
    cp_async_commit();
  }
  __syncthreads();  // the coefficients
  for (int k = 0; tile < g.tiles; ++k, tile += gridDim.x) {
    const int image = tile / per_image, ty = (tile % per_image) / g.tiles_w;
    const int y0 = ty * g.tr, x0 = (tile % g.tiles_w) * g.tw;
    const size_t img = size_t(image) * g.H * g.W;
    unsigned char* buf = bufs + (VEC ? size_t(k & 1) * g.buf : 0);
    T* xs = reinterpret_cast<T*>(buf);
    unsigned char* uds = buf + xb;
    float* du = reinterpret_cast<float*>(uds);
    if constexpr (VEC) {
      if (tile + int(gridDim.x) < g.tiles) stage(tile + gridDim.x, (k & 1) ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // this tile has landed; the next one is in flight
      __syncthreads();
      // du in place of u and dy: each thread reads its vector, then writes
      // it; a thread keeps one channel vector, so its coefficients stay put
      const int cv = 1 << cv_log2, j = tid & (cv - 1);
      float co[6][V];
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int q = 0; q < V; q += 4) {
          const float4 f = *reinterpret_cast<const float4*>(cfs + r * cc + j * V + q);
          co[r][q] = f.x, co[r][q + 1] = f.y, co[r][q + 2] = f.z, co[r][q + 3] = f.w;
        }
      for (int pix = tid >> cv_log2; pix < npix; pix += kThreads >> cv_log2) {
        const int ly = __umulhi(pix, g.wp_magic), lx = pix - ly * wp;
        const int gy = y0 - 1 + ly, gx = x0 - 1 + lx;
        const bool inside = gy >= g.lo && gy < g.hi && gx >= 0 && gx < g.W;
        unsigned char* vec = uds + size_t(pix * cv + j) * 32;
        float uf[V], gf[V], d[V];
        Vec<T>::unpack(*reinterpret_cast<const uint4*>(vec), uf);
        Vec<T>::unpack(*reinterpret_cast<const uint4*>(vec + 16), gf);
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const ChannelCoef cq = {co[0][q], co[1][q], co[2][q], co[3][q]};
          float dz, xhat;
          dz_xhat<T>(uf[q], gf[q], cq, &dz, &xhat);
          d[q] = inside ? __fsub_rn(__fsub_rn(__fmul_rn(cq.a, dz), co[4][q]),
                                    __fmul_rn(co[5][q], xhat))
                        : 0.0f;  // outside the image (or the valid rows): the padding
        }
        float4* dst = reinterpret_cast<float4*>(vec);
#pragma unroll
        for (int q = 0; q < V; q += 4) dst[q / 4] = make_float4(d[q], d[q + 1], d[q + 2], d[q + 3]);
      }
    } else {
      for (int i = tid; i < npix * cc; i += kThreads) {
        const int pix = i >> g.cc_log2, chi = i & (cc - 1);
        const int ly = __umulhi(pix, g.wp_magic), lx = pix - ly * wp;
        const int gy = y0 - 1 + ly, gx = x0 - 1 + lx, ci = c0 + chi;
        const bool inside = gy >= 0 && gy < g.H && gx >= 0 && gx < g.W && ci < g.C;
        T xv = from_f<T>(0.0f);
        float d = 0.0f;  // outside the image (or the valid rows): the correlation's padding
        if (inside) {
          const size_t idx = (img + size_t(gy) * g.W + gx) * g.C + ci;
          xv = x[idx];
        }
        if (inside && gy >= g.lo && gy < g.hi) {
          const size_t idx = (img + size_t(gy) * g.W + gx) * g.C + ci;
          const ChannelCoef co = {cfs[chi], cfs[cc + chi], cfs[2 * cc + chi], cfs[3 * cc + chi]};
          float dz, xhat;
          dz_xhat<T>(to_f<T>(u[idx]), to_f<T>(dy[idx]), co, &dz, &xhat);
          d = __fsub_rn(__fsub_rn(__fmul_rn(co.a, dz), cfs[4 * cc + chi]),
                        __fmul_rn(cfs[5 * cc + chi], xhat));
        }
        xs[i] = xv;
        du[i] = d;
      }
    }
    __syncthreads();

    // the two convolution gradients from shared memory:
    //     dx[t,w,c]  = sum_{i,j} k[i,j,c] * du[t+1-i, w+1-j, c]
    //     dk[i,j,c] += x[t+i-1, w+j-1, c] * du[t,w,c]
    // A thread keeps PV channels of one column and walks down its rows with
    // the 3 x 3 windows of du and x in registers.  kThreads is a multiple of
    // the channel groups, so a thread's channels never change.
    if (c < g.C) {
      for (int l = tid; l < g.tw * ngroups; l += kThreads) {
        const int q = (l >> ng_log2) + 1;  // column of the centre pixel in the halo tile
        const int gx = x0 + q - 1;
        if (gx >= g.W) break;
        const float* gs = du + (q - 1) * dps + du_ch;  // halo row 0, column q - 1
        const T* xr = xs + (q - 1) * cc + ch;
        float g0[3][PV], g1[3][PV], g2[3][PV], xa[3][PV], xb_[3][PV], xc[3][PV];
        auto load = [&](float (&gw)[3][PV], float (&xw)[3][PV], int r) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            if constexpr (PV == 2) {
              const float2 d2 = *reinterpret_cast<const float2*>(gs + r * row_du + j * dps);
              gw[j][0] = d2.x, gw[j][1] = d2.y;
              if constexpr (sizeof(T) == 2) {
                const __nv_bfloat162 v =
                    *reinterpret_cast<const __nv_bfloat162*>(xr + r * row_x + j * cc);
                xw[j][0] = __low2float(v), xw[j][1] = __high2float(v);
              } else {
                const float2 v = *reinterpret_cast<const float2*>(xr + r * row_x + j * cc);
                xw[j][0] = v.x, xw[j][1] = v.y;
              }
            } else {
              gw[j][0] = gs[r * row_du + j * dps];
              xw[j][0] = to_f<T>(xr[r * row_x + j * cc]);
            }
          }
        };
        // row r of the tile from halo rows r - 1 (ga, xa_), r (gb, xb2), r + 1
        // (gc, xc2): one independent dx sum per tap row, then the three added
        auto step = [&](const float (&ga)[3][PV], const float (&gb)[3][PV],
                        const float (&gcw)[3][PV], const float (&xa_)[3][PV],
                        const float (&xb2)[3][PV], const float (&xc2)[3][PV], int r) {
          float v[PV];
#pragma unroll
          for (int k = 0; k < PV; ++k) {
            float p0 = kk[0][k] * gcw[2][k], p1 = kk[3][k] * gb[2][k], p2 = kk[6][k] * ga[2][k];
            p0 = fmaf(kk[1][k], gcw[1][k], p0), p1 = fmaf(kk[4][k], gb[1][k], p1);
            p2 = fmaf(kk[7][k], ga[1][k], p2);
            p0 = fmaf(kk[2][k], gcw[0][k], p0), p1 = fmaf(kk[5][k], gb[0][k], p1);
            p2 = fmaf(kk[8][k], ga[0][k], p2);
            v[k] = (p0 + p1) + p2;
            const float gc = gb[1][k];
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              acc[j][k] = fmaf(xa_[j][k], gc, acc[j][k]);
              acc[3 + j][k] = fmaf(xb2[j][k], gc, acc[3 + j][k]);
              acc[6 + j][k] = fmaf(xc2[j][k], gc, acc[6 + j][k]);
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
        load(g1, xb_, 1);
        int r = 1;
        for (; r + 2 <= rows; r += 3) {  // three rows: the windows rotate by name
          load(g2, xc, r + 1);
          step(g0, g1, g2, xa, xb_, xc, r);
          load(g0, xa, r + 2);
          step(g1, g2, g0, xb_, xc, xa, r + 1);
          load(g1, xb_, r + 3);
          step(g2, g0, g1, xc, xa, xb_, r + 2);
        }
        for (; r <= rows; ++r) {
          load(g2, xc, r + 1);
          step(g0, g1, g2, xa, xb_, xc, r);
#pragma unroll
          for (int j = 0; j < 3; ++j)
#pragma unroll
            for (int k = 0; k < PV; ++k) {
              g0[j][k] = g1[j][k], g1[j][k] = g2[j][k];
              xa[j][k] = xb_[j][k], xb_[j][k] = xc[j][k];
            }
        }
      }
    }
    __syncthreads();  // this buffer is free for the copy two tiles on
  }

  // the threads that share a channel group, summed in thread order, into this
  // CTA's (9, cc) partial; then the chunk's CTAs meet in `finish`
  if constexpr (VEC) cp_async_wait<0>();  // nothing may still land in the buffers
  float* red = reinterpret_cast<float*>(bufs);
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int k = 0; k < PV; ++k) red[(t * PV + k) * kThreads + tid] = acc[t][k];
  __syncthreads();
  const int M = 9 * cc;
  float* chunk_partials = partials + size_t(chunk) * gridDim.x * M;
  for (int o = tid; o < M; o += kThreads) {
    const int t = o / cc, cl = o - t * cc;
    const int grp = cl / PV, k = cl - grp * PV;
    float s = 0.0f;
    for (int i = grp; i < kThreads; i += ngroups) s += red[(t * PV + k) * kThreads + i];
    chunk_partials[size_t(blockIdx.x) * M + o] = s;
  }
  finish(chunk_partials, counters + chunk * finish_counters(gridDim.x, g.group), gridDim.x,
         blockIdx.x, M, g.group, ticket, [&](int e, float total) {
           const int t = e / cc, cl = e - t * cc;
           if (c0 + cl < g.C) dk[t * g.C + c0 + cl] = total;
         });
}

// The geometry for (shape, tile) on the current device: shared memory from
// the tile, CTAs a chunk from the occupancy of pass 2's kernel.
template <typename T, bool VEC>
cudaError_t make_chain_geo(int B, int H, int W, int C, int tr, int tw, ChainGeo* g) {
  if (tr < 1 || tw < 1) return cudaErrorInvalidValue;
  g->B = B, g->H = H, g->W = W, g->C = C, g->tr = tr, g->tw = tw;
  g->lo = 0, g->hi = H;
  g->cc = next_pow2(C < kMaxChunk ? C : kMaxChunk);
  g->cc_log2 = 0;
  while ((1 << g->cc_log2) < g->cc) ++g->cc_log2;
  g->wp_magic = unsigned((0x100000000ULL + tw + 1) / (tw + 2));
  g->chunks = (C + g->cc - 1) / g->cc;
  g->tiles_w = (W + tw - 1) / tw;
  g->tiles_h = (H + tr - 1) / tr;
  const long long tiles = (long long)B * g->tiles_h * g->tiles_w;
  if (tiles > 0x7fffffff || g->chunks > 65535) return cudaErrorInvalidValue;
  g->tiles = int(tiles);
  // a buffer: x on the tile + halo, then u and dy (VEC; du in their place)
  // or du (f32); VEC has two
  const size_t halo = size_t(tr + 2) * (tw + 2) * g->cc;
  const size_t buf = x_bytes(halo, sizeof(T)) + (VEC ? halo * 2 * sizeof(T) : halo * 4);
  const size_t tile = (VEC ? 2 : 1) * buf;
  const size_t red = size_t(9) * (VEC ? 2 : 1) * kThreads * 4;
  const size_t bytes = coef_bytes(g->cc) + (tile > red ? tile : red);
  int device = 0, smem_max = 0, sms = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (bytes > size_t(smem_max)) return cudaErrorInvalidValue;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  g->buf = int(buf);
  g->smem = int(bytes);
  err = cudaFuncSetAttribute(chain_bwd_kernel<T, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, g->smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, chain_bwd_kernel<T, VEC>,
                                                      kThreads, g->smem);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  const int ctas = resident * sms / g->chunks;
  g->ctas = ctas < 1 ? 1 : ctas < g->tiles ? ctas : g->tiles;
  g->group = finish_group(g->ctas);
  return cudaSuccess;
}

// Pass 1's split of the P pixels: rows per CTA and CTAs.
void sums_split(long long P, long long* rows, int* n) {
  const long long want = (P + kSumsMinRows - 1) / kSumsMinRows;
  const int ctas = int(want < kSumsCtas ? want : kSumsCtas);
  *rows = (P + ctas - 1) / ctas;
  *n = int((P + *rows - 1) / *rows);
}

template <typename T>
cudaError_t geometry(int B, int H, int W, int C, int tr, int tw, ChainGeo* g) {
  if (tr <= 0) tr = kTileRows;
  if (tw <= 0) tw = kTileCols;
  return C % Vec<T>::n == 0 ? make_chain_geo<T, true>(B, H, W, C, tr, tw, g)
                            : make_chain_geo<T, false>(B, H, W, C, tr, tw, g);
}

// Pass 1 on P pixels: sums (dbeta, dgamma) and, unless bcd is null, (Bc, D).
template <typename T>
cudaError_t launch_sums(const void* u, const void* dy, Coef cf, float* sums, float* bcd,
                        float* partials, int* counters, long long P, int C,
                        cudaStream_t stream) {
  constexpr int V = Vec<T>::n;
  long long rows = 0;
  int n1 = 0;
  sums_split(P, &rows, &n1);
  auto tu = static_cast<const T*>(u);
  auto tdy = static_cast<const T*>(dy);
  if (C % V == 0)
    chain_sums_kernel<T, V><<<n1, kThreads, 0, stream>>>(tu, tdy, cf, sums, bcd, partials,
                                                         counters, P, C, rows, finish_group(n1));
  else
    chain_sums_kernel<T, 1><<<n1, kThreads, 0, stream>>>(tu, tdy, cf, sums, bcd, partials,
                                                         counters, P, C, rows, finish_group(n1));
  return cudaGetLastError();
}

// Pass 2 on geometry g, with bcd and sums_n as `chain_bwd_kernel` takes them;
// the counters are the whole scratch's (pass 2's follow pass 1's).
template <typename T>
cudaError_t launch_apply(const void* x, const void* u, const void* dy, const void* kern,
                         int kern_bf16, int kts, int kcs, Coef cf, const float* bcd, float sums_n,
                         void* dx, float* dk, float* partials, int* counters, const ChainGeo& g,
                         cudaStream_t stream) {
  long long rows = 0;
  int n1 = 0;
  sums_split((long long)g.B * g.H * g.W, &rows, &n1);
  int* counters2 = counters + finish_counters(n1, finish_group(n1));
  auto kernel = g.C % Vec<T>::n == 0 ? chain_bwd_kernel<T, true> : chain_bwd_kernel<T, false>;
  kernel<<<dim3(g.ctas, g.chunks), kThreads, g.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(u), static_cast<const T*>(dy), kern,
      kern_bf16, kts, kcs, cf, bcd, sums_n, static_cast<T*>(dx), dk, partials, counters2, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* u, const void* dy, const void* kern, int kern_bf16,
                   int kts, int kcs, Coef cf, void* dx, float* dk, float* sums, float* scratch,
                   int* counters, int B, int H, int W, int C, int tr, int tw,
                   cudaStream_t stream) {
  ChainGeo g;
  cudaError_t err = geometry<T>(B, H, W, C, tr, tw, &g);
  if (err != cudaSuccess) return err;
  float* bcd = scratch;
  float* partials = scratch + 2 * C;
  err = launch_sums<T>(u, dy, cf, sums, bcd, partials, counters, (long long)B * H * W, C, stream);
  if (err != cudaSuccess) return err;
  return launch_apply<T>(x, u, dy, kern, kern_bf16, kts, kcs, cf, bcd, 0.0f, dx, dk, partials,
                         counters, g, stream);
}

// The split path's pass 2 (`chain_backward_apply`), du on rows [lo, hi).
template <typename T>
cudaError_t launch_split_apply(const void* x, const void* u, const void* dy, const void* kern,
                               int kern_bf16, int kts, int kcs, Coef cf, const float* sums,
                               float n, void* dx, float* dk, float* scratch, int* counters, int B,
                               int H, int W, int C, int tr, int tw, int lo, int hi,
                               cudaStream_t stream) {
  ChainGeo g;
  const cudaError_t err = geometry<T>(B, H, W, C, tr, tw, &g);
  if (err != cudaSuccess) return err;
  g.lo = lo, g.hi = hi;
  return launch_apply<T>(x, u, dy, kern, kern_bf16, kts, kcs, cf, sums, n, dx, dk,
                         scratch + 2 * C, counters, g, stream);
}

bool bad_shape(int B, int H, int W, int C) { return B < 1 || H < 1 || W < 1 || C < 1; }

}  // namespace

// The scratch of a launch below with the same arguments: *floats f32 values
// and *counters int32 counters (zero before the first launch; each launch
// leaves them zero).  tr, tw: pass 2's tile, 0 for the built-in choice.
// Returns a cudaError_t (0 on success).
extern "C" int chain_backward_scratch(int dtype, int B, int H, int W, int C, int tr, int tw,
                                      long long* floats, int* counters) {
  if (bad_shape(B, H, W, C) || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
  ChainGeo g;
  const cudaError_t err = dtype == 0 ? geometry<float>(B, H, W, C, tr, tw, &g)
                                     : geometry<__nv_bfloat16>(B, H, W, C, tr, tw, &g);
  if (err != cudaSuccess) return err;
  long long rows = 0;
  int n1 = 0;
  sums_split((long long)B * H * W, &rows, &n1);
  const long long p1 = (long long)n1 * 2 * C, p2 = (long long)g.chunks * g.ctas * 9 * g.cc;
  *floats = 2LL * C + (p1 > p2 ? p1 : p2);
  *counters =
      finish_counters(n1, finish_group(n1)) + g.chunks * finish_counters(g.ctas, g.group);
  return cudaSuccess;
}

// Both passes, two launches.  dtype: 0 = float32, 1 = bfloat16 (x, u, dy,
// dx); kern_bf16: the taps' dtype (0 f32, 1 bf16), tap t of channel c at
// kern[t * kts + c * kcs]; mean, inv, a, beta: the forward's (C,) f32
// coefficients; dk (9, C), sums (2, C) f32 out.  Returns a cudaError_t (0 on
// success).
extern "C" int chain_backward_launch(int dtype, const void* x, const void* u, const void* dy,
                                     const void* kern, int kern_bf16, int kts, int kcs,
                                     const void* mean, const void* inv, const void* a,
                                     const void* beta, void* dx, void* dk, void* sums,
                                     void* scratch, void* counters, int B, int H, int W, int C,
                                     int tr, int tw, void* stream) {
  if (bad_shape(B, H, W, C)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const Coef cf = {static_cast<const float*>(mean), static_cast<const float*>(inv),
                   static_cast<const float*>(a), static_cast<const float*>(beta)};
  auto dkf = static_cast<float*>(dk);
  auto sf = static_cast<float*>(sums);
  auto scr = static_cast<float*>(scratch);
  auto ct = static_cast<int*>(counters);
  if (dtype == 0)
    return launch<float>(x, u, dy, kern, kern_bf16, kts, kcs, cf, dx, dkf, sf, scr, ct, B, H, W,
                         C, tr, tw, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, u, dy, kern, kern_bf16, kts, kcs, cf, dx, dkf, sf, scr, ct,
                                 B, H, W, C, tr, tw, s);
  return cudaErrorInvalidValue;
}

// The split path's pass 1: the rank's (dbeta, dgamma) into sums (2, C) f32,
// nothing else.  Scratch and counters as for `chain_backward_launch`.
extern "C" int chain_backward_sums(int dtype, const void* u, const void* dy, const void* mean,
                                   const void* inv, const void* a, const void* beta, void* sums,
                                   void* scratch, void* counters, int B, int H, int W, int C,
                                   void* stream) {
  if (bad_shape(B, H, W, C)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const Coef cf = {static_cast<const float*>(mean), static_cast<const float*>(inv),
                   static_cast<const float*>(a), static_cast<const float*>(beta)};
  auto sf = static_cast<float*>(sums);
  auto partials = static_cast<float*>(scratch) + 2 * C;
  auto ct = static_cast<int*>(counters);
  const long long P = (long long)B * H * W;
  if (dtype == 0) return launch_sums<float>(u, dy, cf, sf, nullptr, partials, ct, P, C, s);
  if (dtype == 1)
    return launch_sums<__nv_bfloat16>(u, dy, cf, sf, nullptr, partials, ct, P, C, s);
  return cudaErrorInvalidValue;
}

// The split path's pass 2: dx and dk from the GLOBAL sums (2, C) f32 =
// (dbeta, dgamma) over n_total pixels of all ranks, du confined to rows
// [lo, hi) (a window's own rows; 0, H for the whole map).  Arguments
// otherwise as for `chain_backward_launch`.
extern "C" int chain_backward_apply(int dtype, const void* x, const void* u, const void* dy,
                                    const void* kern, int kern_bf16, int kts, int kcs,
                                    const void* mean, const void* inv, const void* a,
                                    const void* beta, const void* sums, long long n_total,
                                    void* dx, void* dk, void* scratch, void* counters, int B,
                                    int H, int W, int C, int tr, int tw, int lo, int hi,
                                    void* stream) {
  if (bad_shape(B, H, W, C) || n_total < 1 || lo < 0 || hi > H || lo >= hi)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const Coef cf = {static_cast<const float*>(mean), static_cast<const float*>(inv),
                   static_cast<const float*>(a), static_cast<const float*>(beta)};
  auto gs = static_cast<const float*>(sums);
  auto dkf = static_cast<float*>(dk);
  auto scr = static_cast<float*>(scratch);
  auto ct = static_cast<int*>(counters);
  const float n = float(n_total);
  if (dtype == 0)
    return launch_split_apply<float>(x, u, dy, kern, kern_bf16, kts, kcs, cf, gs, n, dx, dkf, scr,
                                     ct, B, H, W, C, tr, tw, lo, hi, s);
  if (dtype == 1)
    return launch_split_apply<__nv_bfloat16>(x, u, dy, kern, kern_bf16, kts, kcs, cf, gs, n, dx,
                                             dkf, scr, ct, B, H, W, C, tr, tw, lo, hi, s);
  return cudaErrorInvalidValue;
}

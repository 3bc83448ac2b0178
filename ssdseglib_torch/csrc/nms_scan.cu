// Greedy NMS selection scan over score-sorted candidates for Hopper (sm_90a).
//
// Replaces ssdseglib_tpu/ops/nms_pallas.py::_nms_scan_kernel (the Pallas TPU
// kernel).  Per row (one batch element and class), over K candidates sorted by
// descending score:
//
//     for i = 0 .. K-1:
//         take[i] = valid[i] and not suppressed[i] and count < max_keep
//         if take[i]: count += 1; suppressed[j] |= iou[i, j] > threshold, j > i
//
// with the comparison strict and in f32 (NaN compares false), exactly the
// plain version's `iou[..., i, :] > threshold`, so the two agree bit for bit.
// The threshold is read from device memory: a serving path keeps it as a 0-d
// tensor and changes it without a host synchronisation.
//
// What bounds it on the H100: the K x K f32 IoU matrix of every row crosses
// HBM once (K * K * 4 bytes a row); the arithmetic is one compare per element.
// Beyond that bound the scan is a chain of dependent steps, which the design
// keeps short.  One CTA owns one row.  Phase one: every warp streams IoU rows
// with coalesced loads and turns them into bit words by warp vote, K * K / 8
// bytes of shared memory (8 KB at K = 256), and the validity bytes into K / 32
// words.  Phase two: one warp holds the suppressed set in registers (lane l
// owns words l and l + 32) and jumps from one taken candidate to the next:
// the lowest set bit of `valid & ~suppressed` is the next candidate the
// sequential scan would take, so the walk has one step per TAKEN candidate,
// at most max_keep, not K.  A taken i ORs in row i's words whole: bits at or
// below i are already decided, so masking them off would change nothing.
//
// K is limited by the bit matrix in shared memory (K * ceil(K / 32) * 4 bytes
// within the 227 KB a block may use): K <= 1344.
//
// Layout: iou (R, K, K) f32, valid (R, K) bytes (0 / 1), keep (R, K) bytes
// out, all contiguous; R = every leading dimension flattened.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kLoadsInFlight = 8;  // IoU words a warp loads before it votes on any
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
nms_scan_kernel(const float* __restrict__ iou, const unsigned char* __restrict__ valid,
                const float* __restrict__ threshold, unsigned char* __restrict__ keep, int K,
                int max_keep) {
  extern __shared__ uint32_t smem[];
  const int words = (K + 31) / 32;
  uint32_t* over = smem;                        // (K, words): bit j of row i = iou[i, j] > thr
  uint32_t* valid_bits = smem + size_t(K) * words;  // (words,)

  const size_t row = blockIdx.x;
  iou += row * K * K;
  valid += row * K;
  keep += row * K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float thr = *threshold;

  // Phase one: the bit matrix, the validity words, and keep = 0.
  for (int j = tid; j < K; j += kThreads) keep[j] = 0;
  for (int w = warp; w < words; w += kWarps) {
    const int j = w * 32 + lane;
    const unsigned bits = __ballot_sync(kFull, j < K && valid[j] != 0);
    if (lane == 0) valid_bits[w] = bits;
  }
  for (int i = warp; i < K; i += kWarps) {
    const float* src = iou + size_t(i) * K;
    for (int w0 = 0; w0 < words; w0 += kLoadsInFlight) {
      float v[kLoadsInFlight];
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int j = (w0 + u) * 32 + lane;
        v[u] = j < K ? src[j] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int j = (w0 + u) * 32 + lane;
        const unsigned bits = __ballot_sync(kFull, j < K && v[u] > thr);
        if (lane == 0 && w0 + u < words) over[size_t(i) * words + w0 + u] = bits;
      }
    }
  }
  __syncthreads();
  if (warp != 0) return;

  // Phase two: one warp walks the taken candidates.
  uint32_t open0 = lane < words ? valid_bits[lane] : 0u;  // valid & ~suppressed, word lane
  uint32_t open1 = lane + 32 < words ? valid_bits[lane + 32] : 0u;  // word lane + 32
  for (int count = 0; count < max_keep; ++count) {
    unsigned lanes = __ballot_sync(kFull, open0 != 0u);
    int slot = 0;
    if (lanes == 0u) {
      lanes = __ballot_sync(kFull, open1 != 0u);
      slot = 1;
    }
    if (lanes == 0u) break;  // nothing valid is left unsuppressed
    const int owner = __ffs(lanes) - 1;
    const uint32_t word = __shfl_sync(kFull, slot ? open1 : open0, owner);
    const int bit = __ffs(word) - 1;
    const int i = (slot * 32 + owner) * 32 + bit;
    if (lane == 0) keep[i] = 1;
    const uint32_t* taken = over + size_t(i) * words;
    if (lane < words) open0 &= ~taken[lane];
    if (lane + 32 < words) open1 &= ~taken[lane + 32];
    if (lane == owner) {  // i itself, whatever iou[i, i] says
      if (slot) open1 &= ~(1u << bit);
      else open0 &= ~(1u << bit);
    }
  }
}

size_t smem_bytes(int K) {
  const size_t words = (K + 31) / 32;
  return (size_t(K) * words + words) * sizeof(uint32_t);
}

}  // namespace

// iou (rows, K, K) f32, valid (rows, K) bytes, threshold one f32 on the device,
// keep (rows, K) bytes out.  Returns a cudaError_t (0 on success); a K whose bit
// matrix does not fit the block's shared memory is refused here.
extern "C" int nms_scan_launch(const void* iou, const void* valid, const void* threshold,
                               void* keep, int rows, int K, int max_keep, void* stream) {
  if (rows < 1 || K < 1 || K > 2048) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  nms_scan_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(iou), static_cast<const unsigned char*>(valid),
      static_cast<const float*>(threshold), static_cast<unsigned char*>(keep), K, max_keep);
  return cudaGetLastError();
}

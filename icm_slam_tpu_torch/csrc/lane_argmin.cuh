// Lane-split argmin of squared distances: the device functions K1
// (assoc_sums.cu) and K2 (nearest_landmark.cu) share.
//
// Both TPU kernels (icm_slam_tpu/ops/assoc_sums_pallas.py and
// icm_slam_tpu/ops/assoc_pallas.py, `_kernel` in each) carry a running
// (min, argmin) of d2 = dx*dx + dy*dy over the map's columns, first
// minimum winning.  A 2-wide contraction in f32 that must round like
// PyTorch's separate multiply and add (--fmad=false) gives the tensor
// cores nothing to do, and the operands are kilobytes, so on this card the
// function is bound by instruction issue and, where points are few, by the
// length of one thread's dependent chain over the columns.
//
// What this header does about the chain: S lanes of one warp share a
// point.  Lane s scans columns s, s+S, ... of a staged chunk in increasing
// order with a strict `<`, so it holds the first minimum of its own
// columns; a __shfl_xor_sync butterfly then combines (d2, index) pairs,
// the smaller d2 winning and, on equal d2, the smaller index.  That is the
// first-minimum rule of a serial scan and of torch.min, so labels stay
// exact on ties whichever lanes the tied columns fall into.  A lane that
// saw no column holds (+inf, 0) and loses to any finite d2; when every d2
// is +inf the label is 0, as in the serial scan.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, the
// kernel's own duration from a CUDA-graph replay): one frame of 181 points
// against 1024 live columns took 20.6-21.2 us with one thread per point
// (one block, a chain of 1024) and takes 2.4 us with S = 32 (23 blocks,
// chains of 32), 1.1 us above the card's launch floor; its published-peak
// bound of 0.014 us is under any launch.  K1's argmin pass with S = 8 is
// part of the 14 -> 9.2 us of assoc_sums.cu.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace icm {

// Clamp the device-side live count into [0, width].
__device__ __forceinline__ int live_columns(const int* nact_ptr, int width) {
  return min(max(*nact_ptr, 0), width);
}

// Stage columns [base, base + n) of the (L, 2) map into shared memory as
// float2, all threads of the block taking part, by asynchronous copies
// (cp.async): a thread's copies are all in flight at once, where a load
// followed by a store made every pass of the loop wait for device memory.
// A row is 8 bytes and the wrappers refuse a map whose first row does not
// start on an 8-byte boundary, so every copy is aligned.  `stage_wait` must
// come before the barrier that publishes the chunk.
__device__ __forceinline__ void stage_columns(const float* __restrict__ map,
                                              int base, int n, float2* sm) {
  const float2* src = reinterpret_cast<const float2*>(map) + base;
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    __pipeline_memcpy_async(&sm[j], &src[j], sizeof(float2));
  __pipeline_commit();
}

__device__ __forceinline__ void stage_wait() { __pipeline_wait_prior(0); }

// One column against one point: d2 rounded as PyTorch rounds the separate
// subtractions, products and sum, and the strict `<` of the running pair.
// kSqrt compares sqrtf(d2) instead (IEEE-rounded: nvcc's default
// -prec-sqrt=true, and no fast math), so `best` is then a distance.
template <bool kSqrt = false>
__device__ __forceinline__ void take_column(float px, float py, float2 m,
                                            int j, float& best, int& arg) {
  const float dx = px - m.x;
  const float dy = py - m.y;
  const float d2 = dx * dx + dy * dy;
  const float key = kSqrt ? sqrtf(d2) : d2;
  if (key < best) {
    best = key;
    arg = j;
  }
}

// Lane `s` of S scans its columns of the staged chunk; `base` is the
// chunk's first column in the table.
template <int S, bool kSqrt = false>
__device__ __forceinline__ void scan_columns(float px, float py,
                                             const float2* sm, int n,
                                             int base, int s, float& best,
                                             int& arg) {
#pragma unroll 4
  for (int j = s; j < n; j += S)
    take_column<kSqrt>(px, py, sm[j], base + j, best, arg);
}

// Combine the S lanes of a point (S consecutive lanes, S a power of two
// up to 32; every lane of the warp must call it).
template <int S>
__device__ __forceinline__ void combine_lanes(float& best, int& arg) {
#pragma unroll
  for (int off = S / 2; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
    if (ob < best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
}

}  // namespace icm

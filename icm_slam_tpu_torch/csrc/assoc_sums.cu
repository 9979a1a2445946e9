// Fused association + per-frame landmark sums (K1).
//
// Replaces the Pallas TPU kernel `associate_and_sums`
// (icm_slam_tpu/ops/assoc_sums_pallas.py, `_kernel` and its wrapper).
//
// For each beam point (t, b): the argmin over the first `nact` of K map
// columns of d2 = dx*dx + dy*dy (the first minimum wins, label 0 and
// d2 = +inf when no column is live) and that squared minimum.  For each
// frame t and column k: [sum px*w, sum py*w, sum w] over the beams
// labelled k, with w = mask & (d2min <= thr2).
//
// What bounds it on the H100: bytes.  At the main path's shape (T = 1833
// frames, B = 48 beams, K = 128 columns) a call moves 4.3 MB, 2.8 MB of it
// the (T, 3, K) sums, nearly all zeros; that layout is the TPU kernel's
// contract and stays.  The arithmetic is 11 M distance evaluations in f32
// without FMA (--fmad=false keeps d2 bitwise against PyTorch's separate
// multiply and add), two thirds of the bytes' time at the published peaks.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, own
// duration from a CUDA-graph replay): 9.1-9.4 us with all 128 columns live
// (14% of the 1.3 us bound) and 5.3-5.5 us with the 6 a run leaves (24%),
// against 13.9-14.4 and 8.4-8.7 us for one thread per beam and per column.
// What is left is the argmin pass at ~10 instructions per beam and column
// (4 us of the 9) and, with few live columns, one pass of 1833 blocks
// through launch, staging, a warp's placement and 2.8 MB of stores, each
// step waiting for the one before; the launch floor alone is 1.1-1.3 us.
//
// Design: one block of 128 threads per frame, so no sum crosses a block.
// The frame's beams, its mask and the live columns are staged in shared
// memory up front, the columns by asynchronous copies: a block waits for
// device memory on the way in and not again in every round.
// - Argmin pass: 8 lanes of a warp share a beam (lane_argmin.cuh), 16
//   beams a round, so all 128 threads work and a lane's chain is nact / 8
//   long; one thread per beam kept 48 of 128 threads busy on chains of
//   nact.
// - Sums pass: it starts from the beams, not from the columns.  Warp 0
//   takes 32 beams a round, in beam order; __match_any_sync groups the
//   lanes whose gated beams carry the same label, and the lowest lane of
//   each group adds its members, in lane order, onto that column's three
//   sums in shared memory.  One owner per column and round, rounds in
//   order: no atomics, every column's adds run in beam order, and the sums
//   are the same from run to run.  That replaces K * B compares per frame
//   by B.
// - The block then writes its 3 * K sums to device memory, 16 bytes a
//   thread where K is a multiple of 4.
// nact is read from device memory (a 0-d tensor), so the caller never
// syncs to pass it; the gate thr2 is a plain float.
//
// Worlds.  A fleet of W same-shape worlds (solver/icm.py::run_batched) is
// one launch: the grid is (T, W), block (t, w) runs frame t of world w
// against world w's columns (`map_ws` floats apart) and world w's live
// count (nact[w]).  No block straddles two worlds, so each world's slice
// of the result is bitwise what a launch on that world alone gives.  A
// single world is W = 1.

#include <cuda_runtime.h>
#include <math.h>

#include "lane_argmin.cuh"

namespace {

constexpr int kLanes = 8;  // lanes per beam in the argmin pass

// Shared memory: 3 * K sums (rounded up to 16 bytes), K staged columns as
// float2, then x, y and the gated label of each of the B beams.
__host__ __device__ inline size_t sums_bytes(int K) {
  return (static_cast<size_t>(K) * 12 + 15) / 16 * 16;
}

__global__ void assoc_sums_kernel(const float* __restrict__ pts,
                                  const float* __restrict__ map,
                                  const unsigned char* __restrict__ mask,
                                  const int* __restrict__ nact_ptr,
                                  int T, int B, int K, long long map_ws,
                                  float thr2,
                                  int* __restrict__ lab,
                                  float* __restrict__ d2min,
                                  float* __restrict__ sums) {
  extern __shared__ float4 smem4[];
  float* ssum = reinterpret_cast<float*>(smem4);
  float2* smap = reinterpret_cast<float2*>(
      reinterpret_cast<char*>(smem4) + sums_bytes(K));
  float* bx = reinterpret_cast<float*>(smap + K);
  float* by = bx + B;
  int* bl = reinterpret_cast<int*>(by + B);

  // t counts frames over all worlds: the frame's beams, labels and sums
  // lie at t; its world's columns and live count at blockIdx.y
  const size_t t = static_cast<size_t>(blockIdx.y) * T + blockIdx.x;
  map += static_cast<size_t>(blockIdx.y) * map_ws;
  nact_ptr += blockIdx.y;
  // the frame's beams and mask are on their way before nact is waited for
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const size_t i = t * B + b;
    const float2 p = reinterpret_cast<const float2*>(pts)[i];
    bx[b] = p.x;
    by[b] = p.y;
    bl[b] = mask[i] != 0 ? 0 : -1;
  }
  for (int k = threadIdx.x; k < 3 * K; k += blockDim.x) ssum[k] = 0.0f;
  const int nact = icm::live_columns(nact_ptr, K);
  icm::stage_columns(map, 0, nact, smap);
  icm::stage_wait();
  __syncthreads();

  const int s = threadIdx.x % kLanes;
  const int per_round = blockDim.x / kLanes;
  for (int b0 = 0; b0 < B; b0 += per_round) {
    const int b = b0 + threadIdx.x / kLanes;
    const bool valid = b < B;
    const float px = valid ? bx[b] : 0.0f;
    const float py = valid ? by[b] : 0.0f;
    float best = INFINITY;
    int arg = 0;
    icm::scan_columns<kLanes>(px, py, smap, valid ? nact : 0, 0, s, best,
                              arg);
    icm::combine_lanes<kLanes>(best, arg);
    if (valid && s == 0) {
      const size_t i = t * B + b;
      lab[i] = arg;
      d2min[i] = best;
      bl[b] = (bl[b] == 0 && best <= thr2) ? arg : -1;
    }
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    for (int b0 = 0; b0 < B; b0 += 32) {
      const int b = b0 + lane;
      const int l = b < B ? bl[b] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, l);
      if (l >= 0 && lane == __ffs(peers) - 1) {
        float sx = ssum[l], sy = ssum[K + l], sw = ssum[2 * K + l];
        for (unsigned m = peers; m != 0; m &= m - 1) {
          const int q = b0 + __ffs(m) - 1;
          sx += bx[q];
          sy += by[q];
          sw += 1.0f;
        }
        ssum[l] = sx;
        ssum[K + l] = sy;
        ssum[2 * K + l] = sw;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  float* out = sums + t * 3 * K;
  if (K % 4 == 0) {
    float4* out4 = reinterpret_cast<float4*>(out);
    for (int k = threadIdx.x; k < 3 * K / 4; k += blockDim.x)
      out4[k] = smem4[k];
  } else {
    for (int k = threadIdx.x; k < 3 * K; k += blockDim.x) out[k] = ssum[k];
  }
}

}  // namespace

// `threads` and `shmem` come from ops/assoc_sums.py::launch_plan; a plan
// whose shared memory does not hold the layout above, or a world stride
// that would misalign the float2 columns, is refused with
// cudaErrorInvalidValue before anything is launched.  pts (W, T, B, 2),
// mask (W, T, B), nact (W,), lab and d2min (W, T, B), sums (W, T, 3, K)
// are contiguous; world w's K columns start at map + w * map_ws.
extern "C" int icm_assoc_sums(const float* pts, const float* map,
                              const unsigned char* mask, const int* nact,
                              int W, int T, int B, int K, long long map_ws,
                              float thr2, int threads, int shmem, int* lab,
                              float* d2min, float* sums,
                              cudaStream_t stream) {
  if (T == 0 || W == 0) return 0;
  const size_t need = sums_bytes(K) + static_cast<size_t>(K) * 8
                      + static_cast<size_t>(B) * 12;
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || shmem < 0 ||
      static_cast<size_t>(shmem) < need || shmem > 48 * 1024 || W < 0 ||
      W > 65535 || map_ws < 0 || map_ws % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  assoc_sums_kernel<<<dim3(T, W), threads, shmem, stream>>>(
      pts, map, mask, nact, T, B, K, map_ws, thr2, lab, d2min, sums);
  return static_cast<int>(cudaGetLastError());
}

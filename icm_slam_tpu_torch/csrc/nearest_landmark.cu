// Nearest live landmark of every beam point (K2).
//
// Replaces the Pallas TPU kernel `nearest_landmark`
// (icm_slam_tpu/ops/assoc_pallas.py, `_kernel` and its wrapper).
//
// For each point: the argmin over the first `nact` of L map columns of
// d2 = dx*dx + dy*dy, the first minimum winning (the rule of torch.min),
// and sqrt(max(min d2, 0)); +inf and label 0 when no column is live.
//
// What bounds it on the H100: operations, and they are not matrix work.
// The contraction is 2 wide and must stay f32 without FMA (--fmad=false),
// or a label flips against PyTorch's separate multiply and add: wgmma has
// nothing to multiply.  Points, map and outputs are under 1.5 MB and sit in
// L2: TMA has nothing to hide.  So the card is reached through occupancy,
// registers and shared memory, and the limit is instruction issue: 5
// arithmetic instructions and a minimum per point and column, where the
// published peak counts an FMA as two.  Measured on an NVIDIA H100 80GB
// HBM3 at 700 W (chip_smoke.py, own duration from a CUDA-graph replay), at
// 1833 x 48 points against 1024 live columns: 27.5-28.7 us, 24% of the
// 6.7 us published-peak bound and ~58% of the ~16 us that 6 instructions
// per point and column cost at the card's full issue rate; one thread per
// point with a compare and two selects per column took 42.7-43.4 us.  One
// frame (181 points): 2.4 us against 20.6-21.2 us.  Against the first 128
// columns of a table (the non-quirk sweep), where the grouped kernel turns
// to its column-by-column scan: 6.8-7.0 us against 7.1-7.2 us.  With the
// 4-40 live columns a run leaves, every shape is within 1.2 us of the launch
// floor (1.1-1.3 us), the batched ones 2.6 us at nact = 40.  PERF.md holds
// every row.
//
// Design.  The live columns are staged in shared memory as float2, whole
// when they fit the plan's chunk, else chunk by chunk.  The launch plan is
// chosen in Python (ops/assoc.py::launch_plan) from the number of points:
//
// - few points (one frame, 181 of them): `split<S>`, the S = 32 lanes of a
//   warp per point (lane_argmin.cuh).  One frame becomes dozens of blocks
//   on as many SMs, and each lane's dependent chain is nact / S long, where
//   one thread per point gave one block on one SM and a chain of nact.
// - many points (a whole run, 88k): `grouped`, one thread per point.  One
//   16-byte shared load brings two columns (two and four points a thread,
//   to share a load among them, were tried and were no faster).  The
//   running minimum is carried by fminf alone over a group of 32
//   columns; a group that lowered it is remembered, and the index is looked
//   up once per chunk, in that group only, by recomputing its 32 distances
//   (bitwise the same without FMA) and taking the smallest index that
//   equals the minimum: the first-minimum rule again.  That takes the
//   compare and the two selects per column out of the loop.  Lanes start
//   the lookup at different columns of their groups, so that groups 256
//   bytes apart do not meet in one shared-memory bank.  The columns beyond
//   a chunk's last whole group are scanned one by one with a strict `<`,
//   after the lookup, and so is a whole chunk of fewer than 128 columns,
//   where the lookup would cost more than the groups save.
//
// nact is read from device memory (a 0-d tensor), so the caller never
// syncs to pass it.  A split kernel's lanes fetch the table's first S
// columns while nact is on its way, and with nact <= S (the live counts a
// run leaves are 4-6) they are done after one wait for device memory.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "lane_argmin.cuh"

namespace {

constexpr int kGroup = 32;  // columns per group of the grouped kernel
// A chunk of fewer columns than this is scanned one by one: the lookup
// costs as much as ~50 columns of the plain scan, and the groups save a
// third, so below ~130 columns the plain scan is the shorter.
constexpr int kGroupedFrom = 128;

template <int S>
__global__ void nearest_landmark_split(const float* __restrict__ pts,
                                       const float* __restrict__ map,
                                       const int* __restrict__ nact_ptr,
                                       int n_pts, int L, int chunk,
                                       int* __restrict__ lab,
                                       float* __restrict__ dist) {
  extern __shared__ float4 smem4[];
  float2* sm = reinterpret_cast<float2*>(smem4);
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long i = tid / S;
  const int s = threadIdx.x % S;
  float2 p = make_float2(0.0f, 0.0f);
  if (i < n_pts) p = reinterpret_cast<const float2*>(pts)[i];
  // Lane s reads column s straight from device memory while nact is still
  // on its way; with nact <= S that is the whole scan, after one wait for
  // device memory and with no barrier.  A wider live table is staged.
  float2 first = make_float2(0.0f, 0.0f);
  if (s < L) first = reinterpret_cast<const float2*>(map)[s];
  const int nact = icm::live_columns(nact_ptr, L);
  float best = INFINITY;
  int arg = 0;
  if (nact <= S) {
    if (s < nact) icm::take_column(p.x, p.y, first, s, best, arg);
  } else {
    for (int base = 0; base < nact; base += chunk) {
      const int n = min(chunk, nact - base);
      __syncthreads();  // the previous chunk is no longer read
      icm::stage_columns(map, base, n, sm);
      icm::stage_wait();
      __syncthreads();
      icm::scan_columns<S>(p.x, p.y, sm, n, base, s, best, arg);
    }
  }
  icm::combine_lanes<S>(best, arg);
  if (s == 0 && i < n_pts) {
    lab[i] = arg;
    dist[i] = sqrtf(fmaxf(best, 0.0f));
  }
}

__global__ void nearest_landmark_grouped(const float* __restrict__ pts,
                                         const float* __restrict__ map,
                                         const int* __restrict__ nact_ptr,
                                         int n_pts, int L, int chunk,
                                         int* __restrict__ lab,
                                         float* __restrict__ dist) {
  extern __shared__ float4 smem4[];
  float2* sm = reinterpret_cast<float2*>(smem4);
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float2 p = make_float2(0.0f, 0.0f);
  if (i < n_pts) p = reinterpret_cast<const float2*>(pts)[i];
  const int nact = icm::live_columns(nact_ptr, L);
  const unsigned rot = threadIdx.x % kGroup;
  float best = INFINITY;
  int arg = 0;
  for (int base = 0; base < nact; base += chunk) {
    const int n = min(chunk, nact - base);
    const int n_full = n >= kGroupedFrom ? n / kGroup * kGroup : 0;
    __syncthreads();  // the previous chunk is no longer read
    icm::stage_columns(map, base, n, sm);
    icm::stage_wait();
    __syncthreads();
    // whole groups: the minimum alone, and which group lowered it last
    int grp = -1;
    for (int jb = 0; jb < n_full; jb += kGroup) {
      float gmin = INFINITY;
#pragma unroll
      for (int q = 0; q < kGroup / 2; ++q) {
        const float4 m = smem4[jb / 2 + q];  // columns jb+2q and jb+2q+1
        const float dx0 = p.x - m.x;
        const float dy0 = p.y - m.y;
        const float dx1 = p.x - m.z;
        const float dy1 = p.y - m.w;
        const float d0 = dx0 * dx0 + dy0 * dy0;
        const float d1 = dx1 * dx1 + dy1 * dy1;
        gmin = fminf(gmin, fminf(d0, d1));
      }
      if (gmin < best) {
        best = gmin;
        grp = jb;
      }
    }
    // the index, from the one group of this chunk that holds the minimum
    if (grp >= 0) {
      int a = INT_MAX;
#pragma unroll 8
      for (int q = 0; q < kGroup; ++q) {
        const int j = grp + static_cast<int>((rot + q) % kGroup);
        const float2 m = sm[j];
        const float dx = p.x - m.x;
        const float dy = p.y - m.y;
        const float d2 = dx * dx + dy * dy;
        if (d2 == best && j < a) a = j;
      }
      if (a != INT_MAX) arg = base + a;
    }
    // the columns beyond the last whole group, one by one
    icm::scan_columns<1>(p.x, p.y, sm + n_full, n - n_full, base + n_full, 0,
                         best, arg);
  }
  if (i < n_pts) {
    lab[i] = arg;
    dist[i] = sqrtf(fmaxf(best, 0.0f));
  }
}

}  // namespace

// The plan (lanes per point, blocks, threads per block, bytes of shared
// memory) comes from ops/assoc.py::launch_plan; a plan this file has no
// kernel for, or one that does not cover the points, is refused with
// cudaErrorInvalidValue before anything is launched.
extern "C" int icm_nearest_landmark(const float* pts, const float* map,
                                    const int* nact, int n_pts, int L,
                                    int lanes, int blocks, int threads,
                                    int shmem, int* lab, float* dist,
                                    cudaStream_t stream) {
  if (n_pts == 0) return 0;
  if (blocks <= 0 || threads < 32 || threads > 1024 || threads % 32 != 0 ||
      shmem < kGroup * 8 || shmem % (kGroup * 8) != 0 || shmem > 48 * 1024 ||
      static_cast<long long>(blocks) * threads <
          static_cast<long long>(n_pts) * lanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = shmem / 8;
#define ICM_LAUNCH(kernel)                                                  \
  kernel<<<blocks, threads, shmem, stream>>>(pts, map, nact, n_pts, L,      \
                                             chunk, lab, dist)
  if (lanes == 32) {
    ICM_LAUNCH(nearest_landmark_split<32>);
  } else if (lanes == 1) {
    ICM_LAUNCH(nearest_landmark_grouped);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ICM_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

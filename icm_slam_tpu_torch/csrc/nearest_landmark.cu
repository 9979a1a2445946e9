// Nearest live landmark of every beam point (K2).
//
// Replaces the Pallas TPU kernel `nearest_landmark`
// (icm_slam_tpu/ops/assoc_pallas.py, `_kernel` and its wrapper).
//
// For each point: the argmin over the first `nact` of L map columns of
// d2 = dx*dx + dy*dy, with a strict `<` so the first minimum wins (the
// rule of torch.argmin), and sqrt(max(min d2, 0)); +inf and label 0 when
// no column is live.
//
// What bounds it on the H100: the distance loop.  At the uncapped branch's
// shapes (T * B = 1833 * 48 = 88k points, L = 1024 columns) it is ~90 M
// distance evaluations (~0.3 GFLOP) over ~0.7 MB of inputs and outputs, so
// FP32 issue and shared-memory reads bound it, not device memory; the
// JAX path materialised the (T, B, L) distance tensor instead.
//
// Design: one thread per point, 256 threads per block.  The live columns
// are staged through shared memory in chunks of 256, each chunk read once
// per block and then broadcast to every thread; each thread keeps a
// running (min, argmin) in registers.  nact is read from device memory (a
// 0-d tensor), so the caller never syncs to pass it.  Compiled with
// --fmad=false, so d2 rounds like the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;

__global__ void nearest_landmark_kernel(const float* __restrict__ pts,
                                        const float* __restrict__ map,
                                        const int* __restrict__ nact_ptr,
                                        int n_pts, int L,
                                        int* __restrict__ lab,
                                        float* __restrict__ dist) {
  __shared__ float mx[kChunk];
  __shared__ float my[kChunk];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int nact = min(max(*nact_ptr, 0), L);
  float px = 0.0f, py = 0.0f;
  if (i < n_pts) {
    px = pts[2 * static_cast<size_t>(i)];
    py = pts[2 * static_cast<size_t>(i) + 1];
  }
  float best = INFINITY;
  int arg = 0;
  for (int base = 0; base < nact; base += kChunk) {
    const int n = min(kChunk, nact - base);
    __syncthreads();  // the previous chunk is no longer read
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      mx[j] = map[2 * (base + j)];
      my[j] = map[2 * (base + j) + 1];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float dx = px - mx[j];
      const float dy = py - my[j];
      const float d2 = dx * dx + dy * dy;
      if (d2 < best) {
        best = d2;
        arg = base + j;
      }
    }
  }
  if (i < n_pts) {
    lab[i] = arg;
    dist[i] = sqrtf(fmaxf(best, 0.0f));
  }
}

}  // namespace

extern "C" int icm_nearest_landmark(const float* pts, const float* map,
                                    const int* nact, int n_pts, int L,
                                    int* lab, float* dist,
                                    cudaStream_t stream) {
  if (n_pts == 0) return 0;
  const int blocks = (n_pts + kThreads - 1) / kThreads;
  nearest_landmark_kernel<<<blocks, kThreads, 0, stream>>>(pts, map, nact,
                                                           n_pts, L, lab,
                                                           dist);
  return static_cast<int>(cudaGetLastError());
}

// The map filter's sequential relabel walk (K3).
//
// Replaces the relabel `lax.while_loop` of the JAX map filter
// (icm_slam_tpu/mapping/landmark_map.py, `filter_map`: `relabel_body` and
// `relabel_walk`), which runs on the device inside the fused refine loop.
// No Pallas kernel: XLA runs the loop there; torch eager has no device
// loop, and the walk on the host cost a device-to-host copy and a host sync
// in every sweep.
//
// For each world w, lab starts as 0..K-1; for i = 0 .. n[w]-1 in order,
// where close[i], every row whose label equals lab[nn[i]] takes lab[i],
// both values read before the update.  Integer-only, so the result is
// bitwise JAX's walk and the plain version's
// (ops/relabel.py::relabel_walk_plain).
//
// What bounds it on the H100: latency.  The walk is order-dependent: step
// i reads what step i-1 wrote, so it is n sequential steps, as JAX's
// while_loop is on the TPU.  The bytes (nn and close in, the labels out,
// 9 bytes a row: ~1 KB at K=128) and the K compares a close row costs are
// nothing to the card.  What the design does about the latency:
//
// - One block a world, the labels and nn in shared memory (8 bytes a row:
//   16 KB at K=2048), so a step is two dependent shared loads and one pass
//   of the block over the K labels.
// - The close rows below n are found once, by one ballot a warp into a bit
//   mask in shared memory; the walk visits the set bits (__ffs), so rows
//   that are not close cost nothing: in steady state a map has few or no
//   near-duplicates, and the walk is then the load and the store.
// - A close row whose two labels are already equal changes nothing and is
//   skipped with no barrier.  Any other costs two __syncthreads: every
//   thread has read the two labels before any writes, and every write is
//   seen before the next step reads.  Each thread takes K / blockDim rows.
//
// n is read from device memory (a (W,) tensor), so the caller never syncs
// to pass it, and the launch can be captured in a CUDA graph.

#include <cuda_runtime.h>

namespace {

__global__ void relabel_walk_kernel(const int* __restrict__ nn,
                                    const unsigned char* __restrict__ close,
                                    const int* __restrict__ n_ptr, int K,
                                    int* __restrict__ lab_out) {
  extern __shared__ int smem[];
  const int n_words = (K + 31) / 32;
  int* lab = smem;                                   // K labels
  int* nns = smem + K;                               // K neighbours
  unsigned* words = reinterpret_cast<unsigned*>(smem + 2 * K);  // close bits
  const size_t w = blockIdx.x;
  nn += w * K;
  close += w * K;
  lab_out += w * K;
  const int n = min(max(n_ptr[w], 0), K);
  const int lane = threadIdx.x & 31;
  // blockDim.x is a multiple of 32, so each warp's rows j .. j + 31 are
  // one word of the mask
  for (int base = 0; base < K; base += blockDim.x) {
    const int j = base + threadIdx.x;
    bool c = false;
    if (j < K) {
      lab[j] = j;
      nns[j] = min(max(nn[j], 0), K - 1);
      c = j < n && close[j] != 0;
    }
    const unsigned bits = __ballot_sync(0xffffffffu, c);
    if (lane == 0 && j < K) words[j >> 5] = bits;
  }
  __syncthreads();
  for (int q = 0; q < n_words; ++q) {
    unsigned bits = words[q];
    while (bits) {
      const int i = q * 32 + __ffs(bits) - 1;
      bits &= bits - 1;
      const int tgt = lab[nns[i]];
      const int src = lab[i];
      if (tgt == src) continue;  // the same for every thread: no barrier
      __syncthreads();           // every thread has read tgt and src
      for (int j = threadIdx.x; j < K; j += blockDim.x)
        if (lab[j] == tgt) lab[j] = src;
      __syncthreads();           // the writes are seen by the next step
    }
  }
  for (int j = threadIdx.x; j < K; j += blockDim.x) lab_out[j] = lab[j];
}

}  // namespace

// nn (W, K) int32, close (W, K) bytes (a torch bool), n (W,) int32 and lab
// (W, K) int32 are contiguous; one block of `threads` threads a world with
// `shmem` bytes of dynamic shared memory (ops/relabel.py::launch_plan).  A
// plan that does not fit the block or the shared memory is refused with
// cudaErrorInvalidValue before anything is launched.
extern "C" int icm_relabel_walk(const int* nn, const unsigned char* close,
                                const int* n, int W, int K, int threads,
                                int shmem, int* lab, cudaStream_t stream) {
  if (W == 0 || K == 0) return 0;
  if (W < 0 || K < 0 || threads < 32 || threads > 1024 || threads % 32 != 0 ||
      shmem < (2 * K + (K + 31) / 32) * 4 || shmem > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        relabel_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  relabel_walk_kernel<<<W, threads, shmem, stream>>>(nn, close, n, K, lab);
  return static_cast<int>(cudaGetLastError());
}

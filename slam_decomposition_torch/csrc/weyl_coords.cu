// The magic-basis eigenphases of a batch of 2Q unitaries: the k
// assignment's coordinates (coverage.monodromy_ks_batch ->
// weyl.monodromy_coords -> weyl.gamma_eigenphases).
//
// Replaces no TPU kernel: the JAX package's ops/eig.joint_diag is XLA
// operations, with no Pallas kernel. The port's plain chain runs the
// sweeps as ~4000 small torch launches a batch (12 sweeps x 6 pivots, each an
// angle and three in-place Givens applications), ~14 us of host dispatch
// each while the card waits, for ~8 kflop of arithmetic a target.
//
// Bound on this card: operations. A target reads 256 B (U, complex128)
// and writes 32 B (4 phases, f64), and needs ~8.4k f64 operations
// (utils/mfu.py GAMMA_FLOPS, a transcendental counted 8): ~25 us of f64
// work against ~9 us of device memory at 100000 targets.
//
// Design: one target a thread, 128 a block; the body (weyl_coords.cuh)
// keeps X and Y (20 doubles) in registers. A block's U tiles come through
// shared memory so the global loads are coalesced: the block's threads
// copy its 128 x 256 contiguous bytes 16 B at a time into rows of 17
// complex entries (16 and one of padding, so a thread's reads of its own
// row fall on other banks than its neighbours'); the body then forms
// 2 M = 2 B^dag U_s B in place in its row. At most 128 registers a thread
// (4 blocks of 128 an SM), 34 KB of static shared memory a block.

#include "weyl_coords.cuh"

namespace slam_weyl {

constexpr int kThreads = 128;  // targets a block
constexpr int kRow = 17;       // complex entries of a target's row in the tile

__global__ void __launch_bounds__(kThreads, 4)
    gamma_eigenphases_kernel(const double2* __restrict__ U, double* __restrict__ phases, int n) {
  __shared__ double2 tile[kThreads * kRow];
  const long long base = (long long)blockIdx.x * kThreads;
  const int count = n - base < kThreads ? (int)(n - base) : kThreads;
  const double2* src = U + base * 16;
  for (int i = threadIdx.x; i < 16 * count; i += kThreads) tile[(i >> 4) * kRow + (i & 15)] = src[i];
  __syncthreads();
  if ((int)threadIdx.x >= count) return;
  double out[4];
  gamma_eigenphases(reinterpret_cast<Z*>(tile + threadIdx.x * kRow), out);
  double2* dst = reinterpret_cast<double2*>(phases + (base + threadIdx.x) * 4);
  dst[0] = make_double2(out[0], out[1]);
  dst[1] = make_double2(out[2], out[3]);
}

}  // namespace slam_weyl

// U (n, 4, 4) complex128, contiguous -> phases (n, 4) f64. Launches on
// `stream` and returns the launch's error code.
extern "C" cudaError_t slam_gamma_eigenphases(const void* U, void* phases, int n, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaError_t err = slam::use_device_of(U);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + slam_weyl::kThreads - 1) / slam_weyl::kThreads), block(slam_weyl::kThreads);
  slam_weyl::gamma_eigenphases_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double2*>(U), static_cast<double*>(phases), n);
  return cudaGetLastError();
}

// resident blocks per SM on the current device, threads per block and
// static shared memory a block
extern "C" cudaError_t slam_gamma_eigenphases_occupancy(int* blocks, int* threads, int* smem) {
  *threads = slam_weyl::kThreads;
  *smem = (int)(sizeof(double2) * slam_weyl::kThreads * slam_weyl::kRow);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, slam_weyl::gamma_eigenphases_kernel,
                                                       slam_weyl::kThreads, 0);
}

// Fused Adam warm start over the u3 / constant-gate chain, f32.
//
// Replaces: slam_decomposition_tpu/ops/pallas_chain.py:make_adam_chain
// (kernel body :701-745): adam_iters Adam steps per lane on the square cost
// 1 - (|tr(T^dag U(x))|^2 + 4)/20 with the gradient taken inside the kernel.
//
// Bound on this card: operations. One step is a forward chain, the prefix
// products and a reverse sweep of small complex products (~6.0k / 8.5k
// f32 operations at k=2 / 3, utils/mfu.py's model); device memory sees one
// read of (x0, T) and one write of x per lane. The earlier design, one
// thread per lane, could not hold x, m, v, the gradient, the layers and
// the prefix products in 255 registers and spilled (628 / 1708 B) at 12.5%
// occupancy.
//
// Design (adam_team.cuh): a team of 4 threads per lane, 32 lanes per
// block. Thread c holds row c of the reverse sweep's products and the
// Adam state of parameters c, c + 4, ... in registers and its column of
// the prefix products in shared memory, with the angles, their sines and
// cosines and the target; at 96 registers 20 warps per SM are resident
// and 40000 lanes take 1.9 waves. The team exchanges 2 floats (the trace)
// and 6 floats per layer (the gradient) per step by shuffles. The gate
// products skip sqiSwap's zeros (chain_common.cuh GateNz); the [1/bias1,
// 1/bias2, lr] schedule is read from a small device array like the TPU
// kernel's SMEM. A second instance (Cost) ends with one more forward chain
// and writes the lane's square cost at the final x (the TPU kernel's
// with_cost, pallas_chain.py:707-719, :744-745); the default instance does
// not pay for it. From K = 5 the 32 lanes' workspaces (1.5 KB each at
// K = 5, 3.1 KB at K = 12) and the gate lists take 51 to 102 KB a block,
// past the 48 KB of static shared memory: those instances take it as
// dynamic shared memory, which leaves 4 blocks (16 warps) an SM at K = 5,
// 3 (12 warps) at K = 6..8 and 2 (8 warps) at K = 9..12.

#include "adam_chain.cuh"

// K = 7..12 come from adam_chain_deep.cu
SLAM_ADAM_DEPTH(extern, 7)
SLAM_ADAM_DEPTH(extern, 8)
SLAM_ADAM_DEPTH(extern, 9)
SLAM_ADAM_DEPTH(extern, 10)
SLAM_ADAM_DEPTH(extern, 11)
SLAM_ADAM_DEPTH(extern, 12)

// K = 13..79: the depth-generic program (adam_chain_generic.cu)
extern "C" cudaError_t slam_adam_chain_generic(const void* x0, const void* tgt, const void* gates,
                                               const void* sched, int iters, int k, int L, void* xout,
                                               void* fout, void* stream);

// x0 (L, 6(k+1)) f32, tgt (L, 4, 4) complex64, gates (k, 4, 4) complex64,
// sched (iters, 3) f32 -> xout (L, 6(k+1)) f32 and, unless fout is null,
// fout (L,) f32, the square cost at xout. Launches on `stream` and returns
// the launch's error code; k must be 1, ..., 79 (1..12 run their instance,
// 13..79 the depth-generic program).
extern "C" cudaError_t slam_adam_chain(const void* x0, const void* tgt, const void* gates,
                                       const void* sched, int iters, int k, int L,
                                       void* xout, void* fout, void* stream) {
  if (k > slam::kInstMaxK) return slam_adam_chain_generic(x0, tgt, gates, sched, iters, k, L, xout, fout, stream);
  if (L <= 0) return cudaSuccess;
  cudaError_t err = slam::use_device_of(x0);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + slam_adam::kLanes - 1) / slam_adam::kLanes), block(slam_adam::kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(x0);
  const float* t = static_cast<const float*>(tgt);
  const float* g = static_cast<const float*>(gates);
  const float* sc = static_cast<const float*>(sched);
  float* o = static_cast<float*>(xout);
  float* f = static_cast<float*>(fout);
  return slam::by_k(k, [&](auto K) {
    return slam_adam::launch<decltype(K)::value>(grid, block, s, a, t, g, sc, iters, L, o, f);
  });
}

// resident blocks per SM of the default k-instance on the current device,
// its threads per block, its shared memory a block and whether that is
// dynamic
extern "C" cudaError_t slam_adam_chain_occupancy(int k, int* blocks, int* threads, int* smem, int* dynamic) {
  *threads = slam_adam::kThreads;
  return slam::by_k(k, [&](auto K) { return slam_adam::occupancy<decltype(K)::value>(blocks, smem, dynamic); });
}

// the shared memory an SM of the current device holds and the part of it
// reserved for each resident block
extern "C" cudaError_t slam_smem_per_sm(int* per_sm, int* reserved_per_block) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(reserved_per_block, cudaDevAttrReservedSharedMemoryPerBlock, dev);
}

extern "C" const char* slam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

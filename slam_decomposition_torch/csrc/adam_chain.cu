// Fused Adam warm start over the u3 / constant-gate chain, f32.
//
// Replaces: slam_decomposition_tpu/ops/pallas_chain.py:make_adam_chain
// (kernel body :701-745): adam_iters Adam steps per lane on the square cost
// 1 - (|tr(T^dag U(x))|^2 + 4)/20 with the gradient taken inside the kernel.
//
// Bound on this card: arithmetic per lane. One step costs a forward chain,
// the prefix products and a reverse sweep of 4x4 complex products (~2.5k
// f32 FMAs at K=3) and touches no device memory: x, m, v and the target
// live in registers / local memory for all steps, device memory sees one
// read of (x0, T) and one write of x per lane. With one thread per lane the
// kernel spills the prefix products to local memory (L1-resident).
//
// Design: one thread per lane on a 1-D grid; K (2 or 3) is a template
// parameter so every loop over layers unrolls; the K gates sit in shared
// memory; the gradient is derived by hand (chain_common.cuh overlap_grad)
// instead of the TPU kernel's traced jax.grad; the [1/bias1, 1/bias2, lr]
// schedule is read from a small device array like the TPU kernel's SMEM.

#include "chain_common.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(slam::kBlock)
    adam_chain_kernel(const float* __restrict__ x0, const float* __restrict__ tgt,
                      const float* __restrict__ gates, const float* __restrict__ sched,
                      int iters, int L, float* __restrict__ xout) {
  __shared__ slam::M4<float> sG[K];
  slam::load_gates<float, K>(gates, sG, threadIdx.x, blockDim.x);
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < L) slam::adam_lane_io<K>(x0, tgt, sG, sched, iters, lane, xout);
}

}  // namespace

// x0 (L, 6(k+1)) f32, tgt (L, 4, 4) complex64, gates (k, 4, 4) complex64,
// sched (iters, 3) f32 -> xout (L, 6(k+1)) f32. Launches on `stream` and
// returns the launch's error code; k must be 2 or 3.
extern "C" cudaError_t slam_adam_chain(const void* x0, const void* tgt, const void* gates,
                                       const void* sched, int iters, int k, int L,
                                       void* xout, void* stream) {
  if (L <= 0) return cudaSuccess;
  cudaError_t err = slam::use_device_of(x0);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + slam::kBlock - 1) / slam::kBlock), block(slam::kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(x0);
  const float* t = static_cast<const float*>(tgt);
  const float* g = static_cast<const float*>(gates);
  const float* sc = static_cast<const float*>(sched);
  float* o = static_cast<float*>(xout);
  if (k == 2) adam_chain_kernel<2><<<grid, block, 0, s>>>(a, t, g, sc, iters, L, o);
  else if (k == 3) adam_chain_kernel<3><<<grid, block, 0, s>>>(a, t, g, sc, iters, L, o);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

extern "C" const char* slam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// High-precision Levenberg-Marquardt polish over the u3 / constant-gate
// chain, with the certificate.
//
// Replaces: slam_decomposition_tpu/ops/pallas_chain.py:make_polish_chain
// (body polish_block :417-563): lm_iters LM iterations from the best
// restart, angles first reduced mod 4 pi (:629-630). The TPU kernel ran
// the residual and trial step in double-single (~2^-47) because the TPU
// has no f64; here they run in native f64. J, the normal equations and CG
// stay f32, as in the plain reference (JAX gauss_newton.lm_one). The
// kernel also returns the final accepted ||r||^2 = f in f64; the solver
// certifies on cost = 0.2 f - f^2/80.
//
// Bound on this card: the f64 residual evaluations (H100 runs f64 at half
// the f32 rate) and, as in lm_chain.cu, local-memory traffic for J and A.
// At the main path's 10k lanes one thread per lane leaves most warp slots
// of the card empty, so latency rather than throughput sets the time.
//
// Design: the LM lane body of lm_chain.cu instantiated with a double
// residual type (chain_common.cuh lm_lane<double, K>); the K gates are held
// in shared memory in both f64 (residual) and f32 (Jacobian).

#include "chain_common.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(slam::kBlock)
    polish_chain_kernel(const double* __restrict__ x0, const double* __restrict__ tgt,
                        const double* __restrict__ gates, int iters, int L,
                        double* __restrict__ xout, double* __restrict__ fout) {
  __shared__ slam::M4<double> sG[K];
  __shared__ slam::M4<float> sG32[K];
  slam::load_gates<double, K>(gates, sG, threadIdx.x, blockDim.x);
  __syncthreads();
  slam::gates_to_f32<K>(sG, sG32, threadIdx.x, blockDim.x);
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < L) slam::polish_lane_io<K>(x0, tgt, sG, sG32, iters, lane, xout, fout);
}

}  // namespace

// x0 (L, 6(k+1)) f64, tgt (L, 4, 4) complex128, gates (k, 4, 4) complex128
// -> xout (L, 6(k+1)) f64, fout (L,) f64. k must be 2 or 3.
extern "C" cudaError_t slam_polish_chain(const void* x0, const void* tgt, const void* gates,
                                         int iters, int k, int L, void* xout, void* fout,
                                         void* stream) {
  if (L <= 0) return cudaSuccess;
  cudaError_t err = slam::use_device_of(x0);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + slam::kBlock - 1) / slam::kBlock), block(slam::kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double* a = static_cast<const double*>(x0);
  const double* t = static_cast<const double*>(tgt);
  const double* g = static_cast<const double*>(gates);
  double* xo = static_cast<double*>(xout);
  double* fo = static_cast<double*>(fout);
  if (k == 2) polish_chain_kernel<2><<<grid, block, 0, s>>>(a, t, g, iters, L, xo, fo);
  else if (k == 3) polish_chain_kernel<3><<<grid, block, 0, s>>>(a, t, g, iters, L, xo, fo);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// resident blocks per SM of the k-instance on the current device, and its
// threads per block
extern "C" cudaError_t slam_polish_chain_occupancy(int k, int* blocks, int* threads) {
  *threads = slam::kBlock;
  if (k == 2) return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, polish_chain_kernel<2>, slam::kBlock, 0);
  if (k == 3) return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, polish_chain_kernel<3>, slam::kBlock, 0);
  return cudaErrorInvalidValue;
}

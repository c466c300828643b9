// f32 Levenberg-Marquardt ranking pass over the u3 / constant-gate chain.
//
// Replaces: slam_decomposition_tpu/ops/pallas_chain.py:make_lm_chain
// (body lm_block :201-268): lm_iters LM iterations per lane on the 32-real
// phase-aligned residual r = vec(U - e^{i phi} T); J (32 x n) in forward
// mode, normal equations from the upper triangle, n + 8 CG iterations on
// J^T J + lam I, accept iff ||r||^2 drops, lam x0.3 / x8 clipped to
// [1e-14, 1e3]. Returns x and the final ||r||^2 = 8 - 2|tr|.
//
// Bound on this card: per-lane state, not arithmetic. A lane holds J
// (32 x n f32, 768 values at n = 24) and A (n x n), far beyond the 255
// registers of a thread, so J, A and the CG vectors live in local memory
// (L1 / L2 backed). The arithmetic per iteration (~25k FMAs for J, ~10k
// for A, ~20k for CG at n = 24) is small against the card's f32 rate.
//
// Design: one thread per lane on a 1-D grid, K as a template parameter.
// J is computed from prefix / suffix products of the chain
// (chain_common.cuh jacobian), including d(e^{i phi})/dx, which the TPU
// kernel got from jax.linearize through rsqrt. The loops over J's columns
// and over CG stay rolled to keep code size and compile time small.

#include "chain_common.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(slam::kBlock)
    lm_chain_kernel(const float* __restrict__ x0, const float* __restrict__ tgt,
                    const float* __restrict__ gates, int iters, int L,
                    float* __restrict__ xout, float* __restrict__ fout) {
  __shared__ slam::M4<float> sG[K];
  slam::load_gates<float, K>(gates, sG, threadIdx.x, blockDim.x);
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < L) slam::lm_lane_io<K>(x0, tgt, sG, iters, lane, xout, fout);
}

}  // namespace

// x0 (L, 6(k+1)) f32, tgt (L, 4, 4) complex64, gates (k, 4, 4) complex64
// -> xout (L, 6(k+1)) f32, fout (L,) f32. k must be 2 or 3.
extern "C" cudaError_t slam_lm_chain(const void* x0, const void* tgt, const void* gates,
                                     int iters, int k, int L, void* xout, void* fout,
                                     void* stream) {
  if (L <= 0) return cudaSuccess;
  cudaError_t err = slam::use_device_of(x0);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + slam::kBlock - 1) / slam::kBlock), block(slam::kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(x0);
  const float* t = static_cast<const float*>(tgt);
  const float* g = static_cast<const float*>(gates);
  float* xo = static_cast<float*>(xout);
  float* fo = static_cast<float*>(fout);
  if (k == 2) lm_chain_kernel<2><<<grid, block, 0, s>>>(a, t, g, iters, L, xo, fo);
  else if (k == 3) lm_chain_kernel<3><<<grid, block, 0, s>>>(a, t, g, iters, L, xo, fo);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

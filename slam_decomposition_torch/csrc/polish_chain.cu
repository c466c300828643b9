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
// Bound on this card: operations. A lane needs what an LM lane needs for
// J, A, b and CG in f32 (lm_chain.cu) and one f64 chain per residual
// (~2.4k / ~3.5k f64 operations at k=2 / 3, at half the f32 rate) against
// ~0.5 KB of device memory read and written per lane for all iterations.
// The earlier design, one thread per lane, kept J (32 x n) and A (n x n)
// in local memory (6.5 / 9.6 KB a thread) at 255 registers with spills,
// and at the main path's 10000 lanes filled 2.4 warps per SM: latency,
// not throughput, set its time.
//
// Design (lm_team.cuh, its program with a double residual): one warp per
// lane, four lanes per block, the workspace in shared memory (the f32 LM's
// ~5.6 KB a lane at k=3 plus ~1.7 KB of f64 state: x, the trial x, the
// target, the chain, its sines and cosines). The f64 residual needs the
// chain alone: threads 0-3 build one column each through the sparse gate
// lists, every thread one entry of r, ||r||^2 is a butterfly sum of
// doubles. The f32 prefix and suffix products that J needs are built at
// float(x) only on iterations that rebuild J. Near convergence the CG's
// right-hand side leaves f32's normal range (b^T b ~ 1e-26 and falling),
// where every division takes its slow path, so the polish runs CG on b
// scaled by a power of two (exact; lm_team.cuh). 10000 lanes are 2500
// blocks, 3.8 waves at 5 resident blocks.

#include "lm_team.cuh"

namespace {

constexpr int kLanes = 4;  // lanes (warps) per block
constexpr int kThreads = kLanes * slam::kLmTeam;
// resident blocks per SM the register budget must allow: 5 caps a thread
// at 96 registers (20 warps per SM) and still builds without spills; at 4
// (118 / 125 registers used, 16 warps) the kernel ran 3-6% slower on an H100
constexpr int kMinBlocks = 5;

template <int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    polish_chain_kernel(const double* __restrict__ x0, const double* __restrict__ tgt,
                        const double* __restrict__ gates, int iters, int L,
                        double* __restrict__ xout, double* __restrict__ fout) {
  __shared__ slam::GateNz<float> sG[K];
  __shared__ slam::GateNz<double> sGd[K];
  __shared__ slam::LmWs<double, K> ws[kLanes];
  for (int idx = threadIdx.x; idx < 8 * K; idx += blockDim.x) {
    slam::gate_nz_entry(gates, sG, idx);
    slam::gate_nz_entry(gates, sGd, idx);
  }
  __syncthreads();
  const int w = threadIdx.x / slam::kLmTeam;
  const int lane = blockIdx.x * kLanes + w;
  slam::DevTeam<slam::kLmTeam, slam::LmThread<double, K>> tm(threadIdx.x % slam::kLmTeam);
  slam::lm_team_io<double, K>(tm, ws[w], sG, sGd, x0, tgt, iters, lane < L ? lane : L - 1, lane < L, xout,
                              fout);
}

template <int K> cudaError_t occupancy(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, polish_chain_kernel<K>, kThreads, 0);
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
  const dim3 grid((L + kLanes - 1) / kLanes), block(kThreads);
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
  *threads = kThreads;
  if (k == 2) return occupancy<2>(blocks);
  if (k == 3) return occupancy<3>(blocks);
  return cudaErrorInvalidValue;
}

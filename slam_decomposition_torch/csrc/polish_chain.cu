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
// blocks, 3.8 waves at 5 resident blocks. At K = 5, 6 (n = 36, 42
// parameters) a thread owns two columns of J and two CG entries, and CG
// multiplies by J^T J through J without forming it (lm_team.cuh). The
// K = 6 block (gate lists and four workspaces, 54 KB) is past the 48 KB of
// static shared memory and takes it as dynamic shared memory: 4 blocks, 16
// warps an SM, as the K = 5 block's 46 KB allows.

#include "lm_team.cuh"

namespace {

constexpr int kLanes = 4;  // lanes (warps) per block
constexpr int kThreads = kLanes * slam::kLmTeam;
// resident blocks per SM the register budget must allow: 5 caps a thread
// at 96 registers (20 warps per SM) and still builds without spills; at 4
// (118 / 125 registers used, 16 warps) the kernel ran 3-6% slower on an H100.
// At K = 4 (a row of A has 30 entries) it spills 12 B at 96 and takes 4
// (121 registers used, 16 warps); at K = 5, 6 shared memory allows no more
// than 4 blocks either.
template <int K> constexpr int kMinBlocks = K >= 4 ? 4 : 5;

template <int K> struct Smem {
  slam::GateNz<float> G[K];
  slam::GateNz<double> Gd[K];
  slam::LmWs<double, K> ws[kLanes];
};

template <int K>
__device__ __forceinline__ void polish_block(slam::GateNz<float>* sG, slam::GateNz<double>* sGd,
                                             slam::LmWs<double, K>* ws, const double* __restrict__ x0,
                                             const double* __restrict__ tgt, const double* __restrict__ gates,
                                             int iters, int L, double* __restrict__ xout,
                                             double* __restrict__ fout) {
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

template <int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks<K>)
    polish_chain_kernel(const double* __restrict__ x0, const double* __restrict__ tgt,
                        const double* __restrict__ gates, int iters, int L,
                        double* __restrict__ xout, double* __restrict__ fout) {
  if constexpr (sizeof(Smem<K>) <= slam::kStaticSmemMax) {
    __shared__ slam::GateNz<float> sG[K];
    __shared__ slam::GateNz<double> sGd[K];
    __shared__ slam::LmWs<double, K> ws[kLanes];
    polish_block<K>(sG, sGd, ws, x0, tgt, gates, iters, L, xout, fout);
  } else {
    Smem<K>& sm = slam::dynamic_smem<Smem<K>>();
    polish_block<K>(sm.G, sm.Gd, sm.ws, x0, tgt, gates, iters, L, xout, fout);
  }
}

template <int K>
cudaError_t launch(dim3 grid, dim3 block, cudaStream_t s, const double* a, const double* t, const double* g,
                   int iters, int L, double* xo, double* fo) {
  cudaError_t err = slam::allow_smem<Smem<K>>(polish_chain_kernel<K>);
  if (err != cudaSuccess) return err;
  polish_chain_kernel<K><<<grid, block, (slam::kDynSmem<Smem<K>>), s>>>(a, t, g, iters, L, xo, fo);
  return cudaGetLastError();
}

template <int K> cudaError_t occupancy(int* blocks, int* smem, int* dynamic) {
  *smem = (int)sizeof(Smem<K>);
  *dynamic = slam::kDynSmem<Smem<K>> > 0;
  cudaError_t err = slam::allow_smem<Smem<K>>(polish_chain_kernel<K>);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, polish_chain_kernel<K>, kThreads,
                                                       slam::kDynSmem<Smem<K>>);
}

}  // namespace

// x0 (L, 6(k+1)) f64, tgt (L, 4, 4) complex128, gates (k, 4, 4) complex128
// -> xout (L, 6(k+1)) f64, fout (L,) f64. k must be 1, ..., 6.
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
  switch (k) {
    case 1: return launch<1>(grid, block, s, a, t, g, iters, L, xo, fo);
    case 2: return launch<2>(grid, block, s, a, t, g, iters, L, xo, fo);
    case 3: return launch<3>(grid, block, s, a, t, g, iters, L, xo, fo);
    case 4: return launch<4>(grid, block, s, a, t, g, iters, L, xo, fo);
    case 5: return launch<5>(grid, block, s, a, t, g, iters, L, xo, fo);
    case 6: return launch<6>(grid, block, s, a, t, g, iters, L, xo, fo);
    default: return cudaErrorInvalidValue;
  }
}

// resident blocks per SM of the k-instance on the current device, its
// threads per block, its shared memory a block and whether that is dynamic
extern "C" cudaError_t slam_polish_chain_occupancy(int k, int* blocks, int* threads, int* smem, int* dynamic) {
  *threads = kThreads;
  switch (k) {
    case 1: return occupancy<1>(blocks, smem, dynamic);
    case 2: return occupancy<2>(blocks, smem, dynamic);
    case 3: return occupancy<3>(blocks, smem, dynamic);
    case 4: return occupancy<4>(blocks, smem, dynamic);
    case 5: return occupancy<5>(blocks, smem, dynamic);
    case 6: return occupancy<6>(blocks, smem, dynamic);
    default: return cudaErrorInvalidValue;
  }
}

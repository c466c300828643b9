// f32 Levenberg-Marquardt ranking pass over the u3 / constant-gate chain.
//
// Replaces: slam_decomposition_tpu/ops/pallas_chain.py:make_lm_chain
// (body lm_block :201-268): lm_iters LM iterations per lane on the 32-real
// phase-aligned residual r = vec(U - e^{i phi} T); J (32 x n) in forward
// mode, normal equations, n + 8 CG iterations on J^T J + lam I, accept iff
// ||r||^2 drops, lam x0.3 / x8 clipped to [1e-14, 1e3]. Returns x and the
// final ||r||^2 = 8 - 2|tr|.
//
// Bound on this card: operations. A lane needs ~57k (k=2) / ~96k (k=3)
// f32 operations per iteration that rebuilds J and ~22k / ~44k per
// iteration that keeps it (utils/mfu.py's launch model: J from prefix and
// suffix products, A's upper triangle, CG, the trial residual) against
// ~0.2 KB of device memory read and written per lane for all iterations, so the
// kernel cannot be bound by device memory. The earlier design, one thread
// per lane, kept J (32 x n) and A (n x n) in local memory (5.7 / 8.2 KB a
// thread, more than L1 and L2 hold for the ~34k resident threads) and was
// bound by that traffic at 12.5% occupancy (255 registers).
//
// Design (lm_team.cuh, its program with a float residual): one warp per
// lane, four lanes per block. J, r, the
// chain's prefix and suffix products and the CG direction sit in shared
// memory (~5.6 KB a lane at k=3); each thread builds one column of J,
// keeps one row of A in registers and owns one row of the CG vectors; dot
// products are butterfly shuffles. A rejected step reuses J, A and b. The
// gate products skip sqiSwap's zeros (chain_common.cuh GateNz). 40000 lanes
// are 10000 blocks, many waves, so the last wave's tail is small. At
// K = 5, 6 (n = 36, 42 parameters, more than a warp's threads) a thread
// owns two columns of J and two CG entries, and CG multiplies by J^T J
// through J without forming it (lm_team.cuh); a block's gate lists and
// workspaces (35 / 41 KB) stay static shared memory.

#include "lm_team.cuh"

namespace {

constexpr int kLanes = 4;  // lanes (warps) per block
constexpr int kThreads = kLanes * slam::kLmTeam;
// resident blocks per SM the register budget must allow: 5 caps a thread
// at 96 registers (20 warps per SM) without spills at K = 1..4; 6 (80)
// spills. The wide instances (K = 5, 6) spill 8 B at 96 and take 4 (122
// registers used, 16 warps).
template <int K> constexpr int kMinBlocks = K >= 5 ? 4 : 5;
// shared memory a block: the gate lists and the lanes' workspaces
template <int K> constexpr int kSmem = K * sizeof(slam::GateNz<float>) + kLanes * sizeof(slam::LmWs<float, K>);

template <int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks<K>)
    lm_chain_kernel(const float* __restrict__ x0, const float* __restrict__ tgt,
                    const float* __restrict__ gates, int iters, int L,
                    float* __restrict__ xout, float* __restrict__ fout) {
  __shared__ slam::GateNz<float> sG[K];
  __shared__ slam::LmWs<float, K> ws[kLanes];
  for (int idx = threadIdx.x; idx < 8 * K; idx += blockDim.x) slam::gate_nz_entry(gates, sG, idx);
  __syncthreads();
  const int w = threadIdx.x / slam::kLmTeam;
  const int lane = blockIdx.x * kLanes + w;
  slam::DevTeam<slam::kLmTeam, slam::LmThread<float, K>> tm(threadIdx.x % slam::kLmTeam);
  slam::lm_team_io<float, K>(tm, ws[w], sG, sG, x0, tgt, iters, lane < L ? lane : L - 1, lane < L, xout,
                             fout);
}

template <int K> cudaError_t occupancy(int* blocks, int* smem) {
  *smem = kSmem<K>;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, lm_chain_kernel<K>, kThreads, 0);
}

}  // namespace

// x0 (L, 6(k+1)) f32, tgt (L, 4, 4) complex64, gates (k, 4, 4) complex64
// -> xout (L, 6(k+1)) f32, fout (L,) f32. k must be 1, ..., 6.
extern "C" cudaError_t slam_lm_chain(const void* x0, const void* tgt, const void* gates,
                                     int iters, int k, int L, void* xout, void* fout,
                                     void* stream) {
  if (L <= 0) return cudaSuccess;
  cudaError_t err = slam::use_device_of(x0);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kLanes - 1) / kLanes), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(x0);
  const float* t = static_cast<const float*>(tgt);
  const float* g = static_cast<const float*>(gates);
  float* xo = static_cast<float*>(xout);
  float* fo = static_cast<float*>(fout);
  if (k == 1) lm_chain_kernel<1><<<grid, block, 0, s>>>(a, t, g, iters, L, xo, fo);
  else if (k == 2) lm_chain_kernel<2><<<grid, block, 0, s>>>(a, t, g, iters, L, xo, fo);
  else if (k == 3) lm_chain_kernel<3><<<grid, block, 0, s>>>(a, t, g, iters, L, xo, fo);
  else if (k == 4) lm_chain_kernel<4><<<grid, block, 0, s>>>(a, t, g, iters, L, xo, fo);
  else if (k == 5) lm_chain_kernel<5><<<grid, block, 0, s>>>(a, t, g, iters, L, xo, fo);
  else if (k == 6) lm_chain_kernel<6><<<grid, block, 0, s>>>(a, t, g, iters, L, xo, fo);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// resident blocks per SM of the k-instance on the current device, its
// threads per block, its shared memory a block and whether that is dynamic
// (never, here)
extern "C" cudaError_t slam_lm_chain_occupancy(int k, int* blocks, int* threads, int* smem, int* dynamic) {
  *threads = kThreads;
  *dynamic = 0;
  if (k == 1) return occupancy<1>(blocks, smem);
  if (k == 2) return occupancy<2>(blocks, smem);
  if (k == 3) return occupancy<3>(blocks, smem);
  if (k == 4) return occupancy<4>(blocks, smem);
  if (k == 5) return occupancy<5>(blocks, smem);
  if (k == 6) return occupancy<6>(blocks, smem);
  return cudaErrorInvalidValue;
}

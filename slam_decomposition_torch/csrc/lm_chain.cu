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
// K >= 5 (n >= 36 parameters, more than a warp's threads) a thread owns
// two (K = 5..9) or three (K = 10..12: n = 66..78) columns of J and CG
// entries, and CG multiplies by J^T J through J without forming it
// (lm_team.cuh). A block's gate lists and workspaces stay static shared
// memory up to K = 7 (46 KB); from K = 8 (53 KB) they are past the 48 KB a
// kernel may declare and take dynamic shared memory.

#include "lm_chain.cuh"

// K = 7..12 come from lm_chain_deep.cu
SLAM_LM_DEPTH(extern, 7)
SLAM_LM_DEPTH(extern, 8)
SLAM_LM_DEPTH(extern, 9)
SLAM_LM_DEPTH(extern, 10)
SLAM_LM_DEPTH(extern, 11)
SLAM_LM_DEPTH(extern, 12)

// K = 13..79: the depth-generic program (lm_chain_generic.cu)
extern "C" cudaError_t slam_lm_chain_generic(const void* x0, const void* tgt, const void* gates, int iters,
                                             int k, int L, void* xout, void* fout, void* stream);

// x0 (L, 6(k+1)) f32, tgt (L, 4, 4) complex64, gates (k, 4, 4) complex64
// -> xout (L, 6(k+1)) f32, fout (L,) f32. k must be 1, ..., 79 (1..12 run
// their instance, 13..79 the depth-generic program).
extern "C" cudaError_t slam_lm_chain(const void* x0, const void* tgt, const void* gates,
                                     int iters, int k, int L, void* xout, void* fout,
                                     void* stream) {
  if (k > slam::kInstMaxK) return slam_lm_chain_generic(x0, tgt, gates, iters, k, L, xout, fout, stream);
  if (L <= 0) return cudaSuccess;
  cudaError_t err = slam::use_device_of(x0);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + slam_lm::kLanes - 1) / slam_lm::kLanes), block(slam_lm::kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(x0);
  const float* t = static_cast<const float*>(tgt);
  const float* g = static_cast<const float*>(gates);
  float* xo = static_cast<float*>(xout);
  float* fo = static_cast<float*>(fout);
  return slam::by_k(k, [&](auto K) {
    return slam_lm::launch<decltype(K)::value>(grid, block, s, a, t, g, iters, L, xo, fo);
  });
}

// resident blocks per SM of the k-instance on the current device, its
// threads per block, its shared memory a block and whether that is dynamic
extern "C" cudaError_t slam_lm_chain_occupancy(int k, int* blocks, int* threads, int* smem, int* dynamic) {
  *threads = slam_lm::kThreads;
  return slam::by_k(k, [&](auto K) { return slam_lm::occupancy<decltype(K)::value>(blocks, smem, dynamic); });
}

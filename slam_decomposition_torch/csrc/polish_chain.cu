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
// blocks, 3.8 waves at 5 resident blocks. From K = 5 (n >= 36 parameters)
// a thread owns two (K = 5..9) or three (K = 10..12) columns of J and CG
// entries, and CG multiplies by J^T J through J without forming it
// (lm_team.cuh). From K = 6 a block (gate lists and four workspaces, 54 KB
// at K = 6, 98 KB at K = 12) is past the 48 KB of static shared memory
// and takes it as dynamic shared memory: 4 blocks (16 warps) an SM at
// K = 5, 6, 3 at K = 7..9, 2 at K = 10..12.

#include "polish_chain.cuh"

// K = 7..12 come from polish_chain_deep.cu
SLAM_POLISH_DEPTH(extern, 7)
SLAM_POLISH_DEPTH(extern, 8)
SLAM_POLISH_DEPTH(extern, 9)
SLAM_POLISH_DEPTH(extern, 10)
SLAM_POLISH_DEPTH(extern, 11)
SLAM_POLISH_DEPTH(extern, 12)

// K = 13..79: the depth-generic program (polish_chain_generic.cu)
extern "C" cudaError_t slam_polish_chain_generic(const void* x0, const void* tgt, const void* gates, int iters,
                                                 int k, int L, void* xout, void* fout, void* rebuilds,
                                                 void* stream);

// x0 (L, 6(k+1)) f64, tgt (L, 4, 4) complex128, gates (k, 4, 4) complex128
// -> xout (L, 6(k+1)) f64, fout (L,) f64. k must be 1, ..., 79 (1..12 run
// their instance, 13..79 the depth-generic program). rebuilds: null, or one
// int64 in device memory to which each lane adds its number of iterations
// that built J, A and b.
extern "C" cudaError_t slam_polish_chain(const void* x0, const void* tgt, const void* gates,
                                         int iters, int k, int L, void* xout, void* fout, void* rebuilds,
                                         void* stream) {
  if (k > slam::kInstMaxK)
    return slam_polish_chain_generic(x0, tgt, gates, iters, k, L, xout, fout, rebuilds, stream);
  if (L <= 0) return cudaSuccess;
  cudaError_t err = slam::use_device_of(x0);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + slam_polish::kLanes - 1) / slam_polish::kLanes), block(slam_polish::kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double* a = static_cast<const double*>(x0);
  const double* t = static_cast<const double*>(tgt);
  const double* g = static_cast<const double*>(gates);
  double* xo = static_cast<double*>(xout);
  double* fo = static_cast<double*>(fout);
  auto* n = static_cast<unsigned long long*>(rebuilds);
  return slam::by_k(k, [&](auto K) {
    return slam_polish::launch<decltype(K)::value>(grid, block, s, a, t, g, iters, L, xo, fo, n);
  });
}

// resident blocks per SM of the k-instance on the current device, its
// threads per block, its shared memory a block and whether that is dynamic
extern "C" cudaError_t slam_polish_chain_occupancy(int k, int* blocks, int* threads, int* smem, int* dynamic) {
  *threads = slam_polish::kThreads;
  return slam::by_k(k, [&](auto K) { return slam_polish::occupancy<decltype(K)::value>(blocks, smem, dynamic); });
}

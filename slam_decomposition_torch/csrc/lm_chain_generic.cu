// f32 Levenberg-Marquardt ranking pass over the u3 / constant-gate chain
// for any chain depth K: one program in which K is a runtime argument.
//
// Replaces: slam_decomposition_tpu/ops/pallas_chain.py:make_lm_chain
// (body lm_block :201-268) at the depths without an instance, K = 13..79
// (n = 84..480 parameters); lm_chain.cu's entry point hands them here.
//
// Bound on this card: operations, as lm_chain.cu (J from prefix and suffix
// products, b, n + 8 CG iterations of 2 * 32 n multiply-adds, the trial
// residual; utils/mfu.py), against ~0.4-2.4 KB of device memory a lane. CG
// is 89-97% of the time (K = 13..79); each multiply-add of it takes one J
// entry, which the old program read from shared memory for both products,
// and (J p)_e is a chain of n dependent multiply-adds.
//
// Design (lm_generic.cuh, its program with a float residual): lm_team.cuh's
// warp per lane and matrix-free CG, compiled for four slot buckets, with
// the CG vectors in registers and J's first columns copied to registers
// before CG (all of them to K = 20), so that J^T (J p) reads little or no
// J from shared memory. The gate lists are built once a launch in device
// memory and read through the read-only path; a block holds only lane
// workspaces (17.2 KB at K = 13, 95.0 KB at K = 79), as many as put the
// most lanes on an SM within the bucket's register budget (lm_gen_lanes):
// 8 lanes an SM at K = 13, 16 and 20, 7 at 24, 5 at 32, 3 at 48 and 2 at
// 79, where the old block (gate lists and at most 4 lanes) held 8, 8, 4,
// 4, 4, 3 and 1.

#include "lm_generic.cuh"

// x0 (L, 6(k+1)) f32, tgt (L, 4, 4) complex64, gates (k, 4, 4) complex64
// -> xout (L, 6(k+1)) f32, fout (L,) f32, through the depth-generic program
// for any k in 1..kMaxK.
extern "C" cudaError_t slam_lm_chain_generic(const void* x0, const void* tgt, const void* gates, int iters,
                                             int k, int L, void* xout, void* fout, void* stream) {
  return slam::lm_gen_launch<float>(x0, tgt, gates, iters, k, L, xout, fout, stream);
}

// resident blocks per SM of the program at depth k on the current device,
// its threads per block, its dynamic shared memory a block and its lanes a
// block
extern "C" cudaError_t slam_lm_chain_generic_occupancy(int k, int* blocks, int* threads, int* smem, int* lanes) {
  return slam::lm_gen_occupancy<float>(k, blocks, threads, smem, lanes);
}

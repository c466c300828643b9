// High-precision Levenberg-Marquardt polish over the u3 / constant-gate
// chain, with the certificate, for any chain depth K: one program in which
// K is a runtime argument.
//
// Replaces: slam_decomposition_tpu/ops/pallas_chain.py:make_polish_chain
// (body polish_block :417-563) at the depths without an instance,
// K = 13..79 (n = 84..480 parameters); polish_chain.cu's entry point hands
// them here. As there, the residual and trial step run in native f64 (the
// TPU's double-single), J, b and CG in f32, and the kernel returns x with
// its angles reduced mod 4 pi and the final accepted ||r||^2 in f64.
//
// Bound on this card: operations, as polish_chain.cu (the f32 LM's J, b and
// CG, one f64 chain per residual), against ~0.8-4.8 KB of device memory a
// lane; as in the f32 LM, CG is 91-97% of the time.
//
// Design (lm_generic.cuh, its program with a double residual): the f32
// LM's program (CG vectors and J's first columns in registers) with the
// f64 residual on four threads. Both gate lists (f32 for J, f64 for the
// residual: 105.0 KB at K = 79) are built once a launch in device memory
// and read through the read-only path; a block holds only lane workspaces
// (21.1 KB at K = 13, 113.4 KB at K = 79), as many as put the most lanes
// on an SM within the bucket's register budget (lm_gen_lanes): 8 lanes an
// SM at K = 13 and 16, 7 at 20 (one block of 7), 6 at 24, 4 at 32, 3 at 48
// and 2 at 79 (one block of 2), where the old block (both gate lists and
// at most 4 lanes) held 8, 4, 4, 4, 3, 2 and 1.

#include "lm_generic.cuh"

// x0 (L, 6(k+1)) f64, tgt (L, 4, 4) complex128, gates (k, 4, 4) complex128
// -> xout (L, 6(k+1)) f64, fout (L,) f64, through the depth-generic program
// for any k in 1..kMaxK; rebuilds as slam_polish_chain's (null, or an int64 in
// device memory that counts the lanes' J builds).
extern "C" cudaError_t slam_polish_chain_generic(const void* x0, const void* tgt, const void* gates, int iters,
                                                 int k, int L, void* xout, void* fout, void* rebuilds, void* stream) {
  return slam::lm_gen_launch<double>(x0, tgt, gates, iters, k, L, xout, fout, rebuilds, stream);
}

// resident blocks per SM of the program at depth k on the current device,
// its threads per block, its dynamic shared memory a block and its lanes a
// block
extern "C" cudaError_t slam_polish_chain_generic_occupancy(int k, int* blocks, int* threads, int* smem, int* lanes) {
  return slam::lm_gen_occupancy<double>(k, blocks, threads, smem, lanes);
}

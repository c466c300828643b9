// Fused Adam warm start over the u3 / constant-gate chain, f32, for any
// chain depth K: one program in which K is a runtime argument.
//
// Replaces: slam_decomposition_tpu/ops/pallas_chain.py:make_adam_chain
// (kernel body :701-745) at the depths without an instance, K = 13..79
// (n = 84..480 parameters); adam_chain.cu's entry point hands them here.
//
// Bound on this card: operations, as adam_chain.cu (one step is a forward
// chain, the prefix products and a reverse sweep; ~3 chain evaluations,
// utils/mfu.py), against one read of (x0, T) and one write of x per lane.
// A lane's step is two serial chains of K + 1 small products, so what
// limits it is how many lanes an SM keeps in flight to hide their latency.
// The first program (a 4-thread team a lane, g, m, v and the gate lists in
// shared memory) held one block of at most 32 lanes an SM, 1 to 4 warps,
// and spent half its time in the forward chain (PERF.md section 6).
//
// Design (adam_generic.cuh): a team of 16 threads a lane, one thread per
// entry of the 4x4 being built, so that each layer of a chain is two
// exchanges through shared memory; the gradient and the Adam update fused
// into one pass in which each thread takes whole layers, with their x, m
// and v in registers (compiled once a layer bucket: 1..5 layers a thread,
// K <= 15, 31, 47, 63, 79). The gates are read from device memory, so a
// block holds only lane workspaces (192 B a layer: 2.9 KB a lane at K =
// 13, 15.3 KB at K = 79), as many as put the most lanes on an SM within
// the bucket's register budget (adam_gen_lanes, adam_gen_lanes_cap): 40
// lanes (20 warps) an SM at K = 13, 32 (16 warps) at 16..32, 24 at 48, 18
// at 64 and 14 at 79 (the first program: 32 lanes to K = 20, 24 at 24, 16
// at 32, 8 from 48, on 4 threads each). The instance with the final cost
// (Cost) runs the forward chain once more, as in adam_chain.cu.

#include "adam_generic.cuh"

// x0 (L, 6(k+1)) f32, tgt (L, 4, 4) complex64, gates (k, 4, 4) complex64,
// sched (iters, 3) f32 -> xout (L, 6(k+1)) f32 and, unless fout is null,
// fout (L,) f32, the square cost at xout, through the depth-generic
// program for any k in 1..kMaxK. Launches on `stream` and returns the
// launch's error code.
extern "C" cudaError_t slam_adam_chain_generic(const void* x0, const void* tgt, const void* gates,
                                               const void* sched, int iters, int k, int L, void* xout,
                                               void* fout, void* stream) {
  if (k < 1 || k > slam::kMaxK) return cudaErrorInvalidValue;
  if (L <= 0) return cudaSuccess;
  cudaError_t err = slam::use_device_of(x0);
  if (err != cudaSuccess) return err;
  const slam::AdamGenShape sh = slam::adam_gen_shape(k);
  if (sh.smem > slam::kBlockSmemMax) return cudaErrorInvalidValue;
  return slam::adam_gen_by_bucket(k, [&](auto sb) {
    auto* kernel = slam::adam_gen_kernel_of<decltype(sb)::value>(fout != nullptr);
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
    if (e != cudaSuccess) return e;
    kernel<<<(L + sh.lanes - 1) / sh.lanes, sh.lanes * slam::kAdamGenTeam, sh.smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x0), static_cast<const float*>(tgt), static_cast<const float*>(gates),
        static_cast<const float*>(sched), iters, k, L, sh.lanes, (int)sh.lane_bytes, static_cast<float*>(xout),
        static_cast<float*>(fout));
    return cudaGetLastError();
  });
}

// resident blocks per SM of the default program at depth k on the current
// device, its threads per block, its dynamic shared memory a block and its
// lanes a block
extern "C" cudaError_t slam_adam_chain_generic_occupancy(int k, int* blocks, int* threads, int* smem, int* lanes) {
  if (k < 1 || k > slam::kMaxK) return cudaErrorInvalidValue;
  const slam::AdamGenShape sh = slam::adam_gen_shape(k);
  *threads = sh.lanes * slam::kAdamGenTeam;
  *smem = (int)sh.smem;
  *lanes = sh.lanes;
  return slam::adam_gen_by_bucket(k, [&](auto sb) {
    auto* kernel = slam::adam_gen_kernel_of<decltype(sb)::value>(false);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, *threads, sh.smem);
  });
}

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
//
// Design (adam_generic.cuh): adam_team.cuh's 4-thread team per lane,
// unchanged, with the layer loops rolled and the per-thread gradient and
// Adam state g, m, v moved from registers (3 n / 4 floats a thread, 222 at
// K = 48, 360 at K = 79) into the lane's workspace. A block holds the gate lists and as
// many lane workspaces as fit in 227 KB of dynamic shared memory, at most
// 32 (adam_chain.cuh's block) and in whole warps of 8 teams
// (chain_common.cuh generic_lanes): 32 lanes (4.2 KB each at K = 13) to
// K = 21, 24 to K = 29, 16 to K = 43 and 8 (14.1 KB each at K = 48, 22.8
// KB at K = 79) beyond, one block (one to four warps) an SM. The instance with the final cost
// (Cost) is kept as in adam_chain.cu.

#include "adam_generic.cuh"

namespace slam_adam_generic {

constexpr int kMaxLanes = 32, kWarpLanes = 32 / slam::kAdamTeam;
constexpr int kMaxThreads = kMaxLanes * slam::kAdamTeam;

struct Shape {
  int lanes;
  size_t lane_bytes, gate_bytes, smem;
};

inline Shape shape(int k) {
  Shape sh;
  sh.lane_bytes = slam::AdamGenWs::lane_bytes(k);
  sh.gate_bytes = slam::adam_gen_gate_bytes(k);
  sh.lanes = slam::generic_lanes(sh.lane_bytes, sh.gate_bytes, kMaxLanes, kWarpLanes);
  sh.smem = sh.gate_bytes + sh.lanes * sh.lane_bytes;
  return sh;
}

template <bool Cost>
__global__ void __launch_bounds__(kMaxThreads)
    adam_chain_generic_kernel(const float* __restrict__ x0, const float* __restrict__ tgt,
                              const float* __restrict__ gates, const float* __restrict__ sched, int iters, int K,
                              int L, int lanes, int lane_bytes, int gate_bytes, float* __restrict__ xout,
                              float* __restrict__ fout) {
  extern __shared__ __align__(16) unsigned char smem[];
  slam::GateNz<float>* sG = reinterpret_cast<slam::GateNz<float>*>(smem);
  for (int idx = threadIdx.x; idx < 8 * K; idx += blockDim.x) slam::gate_nz_entry<float>(gates, sG, idx);
  __syncthreads();
  const int w = threadIdx.x / slam::kAdamTeam;
  const int lane = blockIdx.x * lanes + w;
  const slam::AdamGenWs ws(smem + gate_bytes + (size_t)w * lane_bytes, K);
  // a team past the last lane repeats lane L - 1 without storing: every
  // thread of the warp takes part in the shuffles
  slam::DevTeam<slam::kAdamTeam, slam::AdamGenThread> tm(threadIdx.x % slam::kAdamTeam);
  slam::adam_gen_team_io<Cost>(tm, ws, sG, x0, tgt, sched, iters, lane < L ? lane : L - 1, lane < L, xout, fout);
}

}  // namespace slam_adam_generic

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
  const slam_adam_generic::Shape sh = slam_adam_generic::shape(k);
  if (sh.smem > slam::kBlockSmemMax) return cudaErrorInvalidValue;
  auto* kernel = fout ? slam_adam_generic::adam_chain_generic_kernel<true>
                      : slam_adam_generic::adam_chain_generic_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + sh.lanes - 1) / sh.lanes), block(sh.lanes * slam::kAdamTeam);
  kernel<<<grid, block, sh.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), static_cast<const float*>(tgt), static_cast<const float*>(gates),
      static_cast<const float*>(sched), iters, k, L, sh.lanes, (int)sh.lane_bytes, (int)sh.gate_bytes,
      static_cast<float*>(xout), static_cast<float*>(fout));
  return cudaGetLastError();
}

// resident blocks per SM of the default program at depth k on the current
// device, its threads per block, its dynamic shared memory a block and its
// lanes a block
extern "C" cudaError_t slam_adam_chain_generic_occupancy(int k, int* blocks, int* threads, int* smem, int* lanes) {
  if (k < 1 || k > slam::kMaxK) return cudaErrorInvalidValue;
  const slam_adam_generic::Shape sh = slam_adam_generic::shape(k);
  *threads = sh.lanes * slam::kAdamTeam;
  *smem = (int)sh.smem;
  *lanes = sh.lanes;
  auto* kernel = slam_adam_generic::adam_chain_generic_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, *threads, sh.smem);
}

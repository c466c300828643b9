// f32 Levenberg-Marquardt ranking pass over the u3 / constant-gate chain
// for any chain depth K: one program in which K is a runtime argument.
//
// Replaces: slam_decomposition_tpu/ops/pallas_chain.py:make_lm_chain
// (body lm_block :201-268) at the depths without an instance, K = 13..79
// (n = 84..480 parameters); lm_chain.cu's entry point hands them here.
//
// Bound on this card: operations, as lm_chain.cu (J from prefix and suffix
// products, b, n + 8 CG iterations of 2 * 32 n multiply-adds, the trial
// residual; utils/mfu.py), against ~0.4-2.4 KB of device memory a lane.
//
// Design (lm_generic.cuh, its program with a float residual): lm_team.cuh's
// warp per lane and matrix-free CG, with the layer loops rolled and the
// CG's per-parameter vectors in the lane's workspace. A block holds the gate
// lists and as many lane workspaces as fit in 227 KB of dynamic shared
// memory, at most 4 (lm_chain.cuh's block; chain_common.cuh
// generic_lanes): 4 lanes (18.8 KB each at K = 13) to K = 38, 3 (64.8 KB
// each at K = 48) to K = 49, 2 to K = 71, then 1 (104.4 KB at K = 79); two
// blocks an SM at K = 13 and 16, one from K = 20.

#include "lm_generic.cuh"

namespace slam_lm_generic {

constexpr int kMaxLanes = 4;
constexpr int kMaxThreads = kMaxLanes * slam::kLmTeam;

struct Shape {
  int lanes;
  size_t lane_bytes, gate_bytes, smem;
};

inline Shape shape(int k) {
  Shape sh;
  sh.lane_bytes = slam::LmGenWs<float>::lane_bytes(k);
  sh.gate_bytes = slam::lm_gen_gate_bytes<float>(k);
  sh.lanes = slam::generic_lanes(sh.lane_bytes, sh.gate_bytes, kMaxLanes, 1);
  sh.smem = sh.gate_bytes + sh.lanes * sh.lane_bytes;
  return sh;
}

__global__ void __launch_bounds__(kMaxThreads)
    lm_chain_generic_kernel(const float* __restrict__ x0, const float* __restrict__ tgt,
                            const float* __restrict__ gates, int iters, int K, int L, int lanes, int lane_bytes,
                            int gate_bytes, float* __restrict__ xout, float* __restrict__ fout) {
  extern __shared__ __align__(16) unsigned char smem[];
  slam::GateNz<float>* sG = reinterpret_cast<slam::GateNz<float>*>(smem);
  for (int idx = threadIdx.x; idx < 8 * K; idx += blockDim.x) slam::gate_nz_entry(gates, sG, idx);
  __syncthreads();
  const int w = threadIdx.x / slam::kLmTeam;
  const int lane = blockIdx.x * lanes + w;
  const slam::LmGenWs<float> ws(smem + gate_bytes + (size_t)w * lane_bytes, K);
  slam::DevTeam<slam::kLmTeam, slam::LmGenThread<float>> tm(threadIdx.x % slam::kLmTeam);
  slam::lm_gen_team_io<float>(tm, ws, sG, sG, x0, tgt, iters, lane < L ? lane : L - 1, lane < L, xout, fout);
}

}  // namespace slam_lm_generic

// x0 (L, 6(k+1)) f32, tgt (L, 4, 4) complex64, gates (k, 4, 4) complex64
// -> xout (L, 6(k+1)) f32, fout (L,) f32, through the depth-generic program
// for any k in 1..kMaxK.
extern "C" cudaError_t slam_lm_chain_generic(const void* x0, const void* tgt, const void* gates, int iters,
                                             int k, int L, void* xout, void* fout, void* stream) {
  if (k < 1 || k > slam::kMaxK) return cudaErrorInvalidValue;
  if (L <= 0) return cudaSuccess;
  cudaError_t err = slam::use_device_of(x0);
  if (err != cudaSuccess) return err;
  const slam_lm_generic::Shape sh = slam_lm_generic::shape(k);
  if (sh.smem > slam::kBlockSmemMax) return cudaErrorInvalidValue;
  auto* kernel = slam_lm_generic::lm_chain_generic_kernel;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + sh.lanes - 1) / sh.lanes), block(sh.lanes * slam::kLmTeam);
  kernel<<<grid, block, sh.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), static_cast<const float*>(tgt), static_cast<const float*>(gates), iters, k, L,
      sh.lanes, (int)sh.lane_bytes, (int)sh.gate_bytes, static_cast<float*>(xout), static_cast<float*>(fout));
  return cudaGetLastError();
}

// resident blocks per SM of the program at depth k on the current device,
// its threads per block, its dynamic shared memory a block and its lanes a
// block
extern "C" cudaError_t slam_lm_chain_generic_occupancy(int k, int* blocks, int* threads, int* smem, int* lanes) {
  if (k < 1 || k > slam::kMaxK) return cudaErrorInvalidValue;
  const slam_lm_generic::Shape sh = slam_lm_generic::shape(k);
  *threads = sh.lanes * slam::kLmTeam;
  *smem = (int)sh.smem;
  *lanes = sh.lanes;
  auto* kernel = slam_lm_generic::lm_chain_generic_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, *threads, sh.smem);
}

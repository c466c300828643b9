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
// lane.
//
// Design (lm_generic.cuh, its program with a double residual): lm_team.cuh's
// polish with the layer loops rolled and the CG's vectors in the lane's
// workspace. A block holds both gate lists (f32 for J, f64 for the
// residual) and as many lane workspaces as fit in 227 KB of dynamic shared
// memory, at most 4 (polish_chain.cuh's block; chain_common.cuh
// generic_lanes): 4 lanes (22.7 KB each at K = 13) to K = 29, then 3 to
// K = 37, 2 (76.4 KB each at K = 48) to K = 50 and 1 (122.8 KB at K = 79,
// beside 103.7 KB of gate lists: the deepest chain a block fits,
// chain_common.cuh kMaxK); two blocks an SM at K = 13, one from K = 16.

#include "lm_generic.cuh"

namespace slam_polish_generic {

constexpr int kMaxLanes = 4;
constexpr int kMaxThreads = kMaxLanes * slam::kLmTeam;

struct Shape {
  int lanes;
  size_t lane_bytes, gate_bytes, smem;
};

inline Shape shape(int k) {
  Shape sh;
  sh.lane_bytes = slam::LmGenWs<double>::lane_bytes(k);
  sh.gate_bytes = slam::lm_gen_gate_bytes<double>(k);
  sh.lanes = slam::generic_lanes(sh.lane_bytes, sh.gate_bytes, kMaxLanes, 1);
  sh.smem = sh.gate_bytes + sh.lanes * sh.lane_bytes;
  return sh;
}

__global__ void __launch_bounds__(kMaxThreads)
    polish_chain_generic_kernel(const double* __restrict__ x0, const double* __restrict__ tgt,
                                const double* __restrict__ gates, int iters, int K, int L, int lanes,
                                int lane_bytes, int gate_bytes, double* __restrict__ xout,
                                double* __restrict__ fout) {
  extern __shared__ __align__(16) unsigned char smem[];
  slam::GateNz<float>* sG = reinterpret_cast<slam::GateNz<float>*>(smem);
  slam::GateNz<double>* sGd =
      reinterpret_cast<slam::GateNz<double>*>(smem + slam::align16(sizeof(slam::GateNz<float>) * K));
  for (int idx = threadIdx.x; idx < 8 * K; idx += blockDim.x) {
    slam::gate_nz_entry(gates, sG, idx);
    slam::gate_nz_entry(gates, sGd, idx);
  }
  __syncthreads();
  const int w = threadIdx.x / slam::kLmTeam;
  const int lane = blockIdx.x * lanes + w;
  const slam::LmGenWs<double> ws(smem + gate_bytes + (size_t)w * lane_bytes, K);
  slam::DevTeam<slam::kLmTeam, slam::LmGenThread<double>> tm(threadIdx.x % slam::kLmTeam);
  slam::lm_gen_team_io<double>(tm, ws, sG, sGd, x0, tgt, iters, lane < L ? lane : L - 1, lane < L, xout, fout);
}

}  // namespace slam_polish_generic

// x0 (L, 6(k+1)) f64, tgt (L, 4, 4) complex128, gates (k, 4, 4) complex128
// -> xout (L, 6(k+1)) f64, fout (L,) f64, through the depth-generic program
// for any k in 1..kMaxK.
extern "C" cudaError_t slam_polish_chain_generic(const void* x0, const void* tgt, const void* gates, int iters,
                                                 int k, int L, void* xout, void* fout, void* stream) {
  if (k < 1 || k > slam::kMaxK) return cudaErrorInvalidValue;
  if (L <= 0) return cudaSuccess;
  cudaError_t err = slam::use_device_of(x0);
  if (err != cudaSuccess) return err;
  const slam_polish_generic::Shape sh = slam_polish_generic::shape(k);
  if (sh.smem > slam::kBlockSmemMax) return cudaErrorInvalidValue;
  auto* kernel = slam_polish_generic::polish_chain_generic_kernel;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + sh.lanes - 1) / sh.lanes), block(sh.lanes * slam::kLmTeam);
  kernel<<<grid, block, sh.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x0), static_cast<const double*>(tgt), static_cast<const double*>(gates), iters, k,
      L, sh.lanes, (int)sh.lane_bytes, (int)sh.gate_bytes, static_cast<double*>(xout), static_cast<double*>(fout));
  return cudaGetLastError();
}

// resident blocks per SM of the program at depth k on the current device,
// its threads per block, its dynamic shared memory a block and its lanes a
// block
extern "C" cudaError_t slam_polish_chain_generic_occupancy(int k, int* blocks, int* threads, int* smem, int* lanes) {
  if (k < 1 || k > slam::kMaxK) return cudaErrorInvalidValue;
  const slam_polish_generic::Shape sh = slam_polish_generic::shape(k);
  *threads = sh.lanes * slam::kLmTeam;
  *smem = (int)sh.smem;
  *lanes = sh.lanes;
  auto* kernel = slam_polish_generic::polish_chain_generic_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, *threads, sh.smem);
}

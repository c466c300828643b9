// The polish kernel and its launch glue, templated on the chain depth
// K. polish_chain.cu holds the C entry points and the K = 1..6 instances,
// polish_chain_deep.cu the K = 7..12 ones, so that the build, one nvcc per
// source and all at once (ops/_build.py), compiles the two halves side by
// side. The design is described in polish_chain.cu.

#pragma once

#include "lm_team.cuh"

namespace slam_polish {

constexpr int kLanes = 4;  // lanes (warps) per block
constexpr int kThreads = kLanes * slam::kLmTeam;

template <int K> struct Smem {
  slam::GateNz<float> G[K];
  slam::GateNz<double> Gd[K];
  slam::LmWs<double, K> ws[kLanes];
};

// resident blocks per SM the register budget must allow: 5 caps a thread
// at 96 registers (20 warps per SM) and still builds without spills; at 4
// (118 / 125 registers used, 16 warps) the kernel ran 3-6% slower on an H100.
// At K = 4 (a row of A has 30 entries) it spills 12 B at 96 and takes 4
// (121 registers used, 16 warps). From K = 7 shared memory allows fewer
// blocks (3 at K = 7..9, 2 at K = 10..12), and the cap follows it.
template <int K> constexpr int kMinBlocks = slam::min_blocks(K >= 4 ? 4 : 5, slam::kSmemBlocks<Smem<K>>);

template <int K>
__device__ __forceinline__ void polish_block(slam::GateNz<float>* sG, slam::GateNz<double>* sGd,
                                             slam::LmWs<double, K>* ws, const double* __restrict__ x0,
                                             const double* __restrict__ tgt, const double* __restrict__ gates,
                                             int iters, int L, double* __restrict__ xout,
                                             double* __restrict__ fout, unsigned long long* rebuilds) {
  for (int idx = threadIdx.x; idx < 8 * K; idx += blockDim.x) {
    slam::gate_nz_entry(gates, sG, idx);
    slam::gate_nz_entry(gates, sGd, idx);
  }
  __syncthreads();
  const int w = threadIdx.x / slam::kLmTeam;
  const int lane = blockIdx.x * kLanes + w;
  slam::DevTeam<slam::kLmTeam, slam::LmThread<double, K>> tm(threadIdx.x % slam::kLmTeam);
  slam::lm_team_io<double, K>(tm, ws[w], sG, sGd, x0, tgt, iters, lane < L ? lane : L - 1, lane < L, xout,
                              fout, rebuilds);
}

template <int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks<K>)
    polish_chain_kernel(const double* __restrict__ x0, const double* __restrict__ tgt,
                        const double* __restrict__ gates, int iters, int L,
                        double* __restrict__ xout, double* __restrict__ fout,
                        unsigned long long* rebuilds) {
  if constexpr (sizeof(Smem<K>) <= slam::kStaticSmemMax) {
    __shared__ slam::GateNz<float> sG[K];
    __shared__ slam::GateNz<double> sGd[K];
    __shared__ slam::LmWs<double, K> ws[kLanes];
    polish_block<K>(sG, sGd, ws, x0, tgt, gates, iters, L, xout, fout, rebuilds);
  } else {
    Smem<K>& sm = slam::dynamic_smem<Smem<K>>();
    polish_block<K>(sm.G, sm.Gd, sm.ws, x0, tgt, gates, iters, L, xout, fout, rebuilds);
  }
}

template <int K>
cudaError_t launch(dim3 grid, dim3 block, cudaStream_t s, const double* a, const double* t, const double* g,
                   int iters, int L, double* xo, double* fo, unsigned long long* rebuilds) {
  cudaError_t err = slam::allow_smem<Smem<K>>(polish_chain_kernel<K>);
  if (err != cudaSuccess) return err;
  polish_chain_kernel<K><<<grid, block, (slam::kDynSmem<Smem<K>>), s>>>(a, t, g, iters, L, xo, fo, rebuilds);
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

}  // namespace slam_polish

// The depth-K instances of the launch glue: declared extern in the entry
// source (SLAM_POLISH_DEPTH(extern, K)) and instantiated in the deep one
// (SLAM_POLISH_DEPTH(, K)).
#define SLAM_POLISH_DEPTH(ext, K) \
  ext template cudaError_t slam_polish::launch<K>( \
      dim3, dim3, cudaStream_t, const double*, const double*, const double*, int, int, double*, double*, \
      unsigned long long*); \
  ext template cudaError_t slam_polish::occupancy<K>(int*, int*, int*);

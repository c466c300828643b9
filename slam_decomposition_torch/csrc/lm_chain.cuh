// The f32 LM kernel and its launch glue, templated on the chain depth
// K. lm_chain.cu holds the C entry points and the K = 1..6 instances,
// lm_chain_deep.cu the K = 7..12 ones, so that the build, one nvcc per
// source and all at once (ops/_build.py), compiles the two halves side by
// side. The design is described in lm_chain.cu.

#pragma once

#include "lm_team.cuh"

namespace slam_lm {

constexpr int kLanes = 4;  // lanes (warps) per block
constexpr int kThreads = kLanes * slam::kLmTeam;

template <int K> struct Smem {
  slam::GateNz<float> G[K];
  slam::LmWs<float, K> ws[kLanes];
};

// resident blocks per SM the register budget must allow: 5 caps a thread
// at 96 registers (20 warps per SM) without spills at K = 1..4; 6 (80)
// spills. The wide instances (K >= 5) spill 8 B at 96 and take 4 (122
// registers used, 16 warps); from K = 10 (three slots a thread, 61 KB a
// block) shared memory allows 3, and the cap follows it.
template <int K> constexpr int kMinBlocks = slam::min_blocks(K >= 5 ? 4 : 5, slam::kSmemBlocks<Smem<K>>);

template <int K>
__device__ __forceinline__ void lm_block(slam::GateNz<float>* sG, slam::LmWs<float, K>* ws,
                                         const float* __restrict__ x0, const float* __restrict__ tgt,
                                         const float* __restrict__ gates, int iters, int L,
                                         float* __restrict__ xout, float* __restrict__ fout) {
  for (int idx = threadIdx.x; idx < 8 * K; idx += blockDim.x) slam::gate_nz_entry(gates, sG, idx);
  __syncthreads();
  const int w = threadIdx.x / slam::kLmTeam;
  const int lane = blockIdx.x * kLanes + w;
  slam::DevTeam<slam::kLmTeam, slam::LmThread<float, K>> tm(threadIdx.x % slam::kLmTeam);
  slam::lm_team_io<float, K>(tm, ws[w], sG, sG, x0, tgt, iters, lane < L ? lane : L - 1, lane < L, xout,
                             fout);
}

template <int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks<K>)
    lm_chain_kernel(const float* __restrict__ x0, const float* __restrict__ tgt,
                    const float* __restrict__ gates, int iters, int L,
                    float* __restrict__ xout, float* __restrict__ fout) {
  if constexpr (sizeof(Smem<K>) <= slam::kStaticSmemMax) {
    __shared__ slam::GateNz<float> sG[K];
    __shared__ slam::LmWs<float, K> ws[kLanes];
    lm_block<K>(sG, ws, x0, tgt, gates, iters, L, xout, fout);
  } else {
    Smem<K>& sm = slam::dynamic_smem<Smem<K>>();
    lm_block<K>(sm.G, sm.ws, x0, tgt, gates, iters, L, xout, fout);
  }
}

template <int K>
cudaError_t launch(dim3 grid, dim3 block, cudaStream_t s, const float* a, const float* t, const float* g,
                   int iters, int L, float* xo, float* fo) {
  cudaError_t err = slam::allow_smem<Smem<K>>(lm_chain_kernel<K>);
  if (err != cudaSuccess) return err;
  lm_chain_kernel<K><<<grid, block, (slam::kDynSmem<Smem<K>>), s>>>(a, t, g, iters, L, xo, fo);
  return cudaGetLastError();
}

template <int K> cudaError_t occupancy(int* blocks, int* smem, int* dynamic) {
  *smem = (int)sizeof(Smem<K>);
  *dynamic = slam::kDynSmem<Smem<K>> > 0;
  cudaError_t err = slam::allow_smem<Smem<K>>(lm_chain_kernel<K>);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, lm_chain_kernel<K>, kThreads,
                                                       slam::kDynSmem<Smem<K>>);
}

}  // namespace slam_lm

// The depth-K instances of the launch glue: declared extern in the entry
// source (SLAM_LM_DEPTH(extern, K)) and instantiated in the deep one
// (SLAM_LM_DEPTH(, K)).
#define SLAM_LM_DEPTH(ext, K) \
  ext template cudaError_t slam_lm::launch<K>( \
      dim3, dim3, cudaStream_t, const float*, const float*, const float*, int, int, float*, float*); \
  ext template cudaError_t slam_lm::occupancy<K>(int*, int*, int*);

// The Adam kernel and its launch glue, templated on the chain depth
// K. adam_chain.cu holds the C entry points and the K = 1..6 instances,
// adam_chain_deep.cu the K = 7..12 ones, so that the build, one nvcc per
// source and all at once (ops/_build.py), compiles the two halves side by
// side. The design is described in adam_chain.cu.

#pragma once

#include "adam_team.cuh"

namespace slam_adam {

constexpr int kLanes = 32;  // lanes per block
constexpr int kThreads = kLanes * slam::kAdamTeam;

template <int K> struct Smem {
  slam::GateNz<float> G[K];
  slam::AdamWs<K> ws[kLanes];
};

// resident blocks per SM the register budget must allow: 5 caps a thread
// at 96 registers (20 warps per SM) without spills; 6 (80) spills. The
// instance with the cost spills at 96 (8 / 4 B) and takes 4 (128), and so
// does the K = 4 instance (8 gradient and Adam-state slots a thread: 4 / 8 B
// of spills at 96, 107 registers used at 4). From K = 6 shared memory
// allows fewer blocks (3 at K = 6..8, 2 at K = 9..12), and the cap follows
// it.
template <int K, bool Cost>
constexpr int kMinBlocks = slam::min_blocks(Cost || K >= 4 ? 4 : 5, slam::kSmemBlocks<Smem<K>>);

template <int K, bool Cost>
__device__ __forceinline__ void adam_block(slam::GateNz<float>* sG, slam::AdamWs<K>* ws,
                                           const float* __restrict__ x0, const float* __restrict__ tgt,
                                           const float* __restrict__ gates, const float* __restrict__ sched,
                                           int iters, int L, float* __restrict__ xout, float* __restrict__ fout) {
  for (int idx = threadIdx.x; idx < 8 * K; idx += blockDim.x) slam::gate_nz_entry<float>(gates, sG, idx);
  __syncthreads();
  const int w = threadIdx.x / slam::kAdamTeam;
  const int lane = blockIdx.x * kLanes + w;
  // a team past the last lane repeats lane L - 1 without storing: every
  // thread of the warp takes part in the shuffles
  slam::DevTeam<slam::kAdamTeam, slam::AdamThread<K>> tm(threadIdx.x % slam::kAdamTeam);
  slam::adam_team_io<K, Cost>(tm, ws[w], sG, x0, tgt, sched, iters, lane < L ? lane : L - 1, lane < L, xout,
                               fout);
}

template <int K, bool Cost>
__global__ void __launch_bounds__(kThreads, kMinBlocks<K, Cost>)
    adam_chain_kernel(const float* __restrict__ x0, const float* __restrict__ tgt,
                      const float* __restrict__ gates, const float* __restrict__ sched,
                      int iters, int L, float* __restrict__ xout, float* __restrict__ fout) {
  if constexpr (sizeof(Smem<K>) <= slam::kStaticSmemMax) {
    __shared__ slam::GateNz<float> sG[K];
    __shared__ slam::AdamWs<K> ws[kLanes];
    adam_block<K, Cost>(sG, ws, x0, tgt, gates, sched, iters, L, xout, fout);
  } else {
    Smem<K>& sm = slam::dynamic_smem<Smem<K>>();
    adam_block<K, Cost>(sm.G, sm.ws, x0, tgt, gates, sched, iters, L, xout, fout);
  }
}

template <int K> cudaError_t occupancy(int* blocks, int* smem, int* dynamic) {
  *smem = (int)sizeof(Smem<K>);
  *dynamic = slam::kDynSmem<Smem<K>> > 0;
  cudaError_t err = slam::allow_smem<Smem<K>>(adam_chain_kernel<K, false>);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, adam_chain_kernel<K, false>, kThreads,
                                                       slam::kDynSmem<Smem<K>>);
}

// the instance with the cost when fout is given, else the default one
template <int K>
cudaError_t launch(dim3 grid, dim3 block, cudaStream_t s, const float* a, const float* t, const float* g,
                   const float* sc, int iters, int L, float* o, float* f) {
  auto* kernel = f ? adam_chain_kernel<K, true> : adam_chain_kernel<K, false>;
  cudaError_t err = slam::allow_smem<Smem<K>>(kernel);
  if (err != cudaSuccess) return err;
  kernel<<<grid, block, (slam::kDynSmem<Smem<K>>), s>>>(a, t, g, sc, iters, L, o, f);
  return cudaGetLastError();
}

}  // namespace slam_adam

// The depth-K instances of the launch glue: declared extern in the entry
// source (SLAM_ADAM_DEPTH(extern, K)) and instantiated in the deep one
// (SLAM_ADAM_DEPTH(, K)).
#define SLAM_ADAM_DEPTH(ext, K) \
  ext template cudaError_t slam_adam::launch<K>( \
      dim3, dim3, cudaStream_t, const float*, const float*, const float*, const float*, int, int, float*, float*); \
  ext template cudaError_t slam_adam::occupancy<K>(int*, int*, int*);

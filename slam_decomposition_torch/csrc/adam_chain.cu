// Fused Adam warm start over the u3 / constant-gate chain, f32.
//
// Replaces: slam_decomposition_tpu/ops/pallas_chain.py:make_adam_chain
// (kernel body :701-745): adam_iters Adam steps per lane on the square cost
// 1 - (|tr(T^dag U(x))|^2 + 4)/20 with the gradient taken inside the kernel.
//
// Bound on this card: operations. One step is a forward chain, the prefix
// products and a reverse sweep of small complex products (~6.0k / 8.5k
// f32 operations at k=2 / 3, utils/mfu.py's model); device memory sees one
// read of (x0, T) and one write of x per lane. The earlier design, one
// thread per lane, could not hold x, m, v, the gradient, the layers and
// the prefix products in 255 registers and spilled (628 / 1708 B) at 12.5%
// occupancy.
//
// Design (adam_team.cuh): a team of 4 threads per lane, 32 lanes per
// block. Thread c holds row c of the reverse sweep's products and the
// Adam state of parameters c, c + 4, ... in registers and its column of
// the prefix products in shared memory, with the angles, their sines and
// cosines and the target; at 96 registers 20 warps per SM are resident
// and 40000 lanes take 1.9 waves. The team exchanges 2 floats (the trace)
// and 6 floats per layer (the gradient) per step by shuffles. The gate
// products skip sqiSwap's zeros (chain_common.cuh GateNz); the [1/bias1,
// 1/bias2, lr] schedule is read from a small device array like the TPU
// kernel's SMEM. A second instance (Cost) ends with one more forward chain
// and writes the lane's square cost at the final x (the TPU kernel's
// with_cost, pallas_chain.py:707-719, :744-745); the default instance does
// not pay for it. At K = 5, 6 the 32 lanes' workspaces (1.5 / 1.7 KB each)
// and the gate lists take 51 / 58 KB a block, past the 48 KB of static
// shared memory: those instances take it as dynamic shared memory, which
// leaves 4 / 3 blocks (16 / 12 warps) an SM.

#include "adam_team.cuh"

namespace {

constexpr int kLanes = 32;  // lanes per block
constexpr int kThreads = kLanes * slam::kAdamTeam;
// resident blocks per SM the register budget must allow: 5 caps a thread
// at 96 registers (20 warps per SM) without spills; 6 (80) spills. The
// instance with the cost spills at 96 (8 / 4 B) and takes 4 (128), and so
// does the K = 4 instance (8 gradient and Adam-state slots a thread: 4 / 8 B
// of spills at 96, 107 registers used at 4). At K = 5 shared memory allows
// 4 blocks, at K = 6 3 (168 registers), so neither needs a tighter cap.
template <int K, bool Cost> constexpr int kMinBlocks = K >= 6 ? 3 : Cost || K >= 4 ? 4 : 5;

template <int K> struct Smem {
  slam::GateNz<float> G[K];
  slam::AdamWs<K> ws[kLanes];
};

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

}  // namespace

// x0 (L, 6(k+1)) f32, tgt (L, 4, 4) complex64, gates (k, 4, 4) complex64,
// sched (iters, 3) f32 -> xout (L, 6(k+1)) f32 and, unless fout is null,
// fout (L,) f32, the square cost at xout. Launches on `stream` and returns
// the launch's error code; k must be 1, ..., 6.
extern "C" cudaError_t slam_adam_chain(const void* x0, const void* tgt, const void* gates,
                                       const void* sched, int iters, int k, int L,
                                       void* xout, void* fout, void* stream) {
  if (L <= 0) return cudaSuccess;
  cudaError_t err = slam::use_device_of(x0);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kLanes - 1) / kLanes), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(x0);
  const float* t = static_cast<const float*>(tgt);
  const float* g = static_cast<const float*>(gates);
  const float* sc = static_cast<const float*>(sched);
  float* o = static_cast<float*>(xout);
  float* f = static_cast<float*>(fout);
  switch (k) {
    case 1: return launch<1>(grid, block, s, a, t, g, sc, iters, L, o, f);
    case 2: return launch<2>(grid, block, s, a, t, g, sc, iters, L, o, f);
    case 3: return launch<3>(grid, block, s, a, t, g, sc, iters, L, o, f);
    case 4: return launch<4>(grid, block, s, a, t, g, sc, iters, L, o, f);
    case 5: return launch<5>(grid, block, s, a, t, g, sc, iters, L, o, f);
    case 6: return launch<6>(grid, block, s, a, t, g, sc, iters, L, o, f);
    default: return cudaErrorInvalidValue;
  }
}

// resident blocks per SM of the default k-instance on the current device,
// its threads per block, its shared memory a block and whether that is
// dynamic
extern "C" cudaError_t slam_adam_chain_occupancy(int k, int* blocks, int* threads, int* smem, int* dynamic) {
  *threads = kThreads;
  switch (k) {
    case 1: return occupancy<1>(blocks, smem, dynamic);
    case 2: return occupancy<2>(blocks, smem, dynamic);
    case 3: return occupancy<3>(blocks, smem, dynamic);
    case 4: return occupancy<4>(blocks, smem, dynamic);
    case 5: return occupancy<5>(blocks, smem, dynamic);
    case 6: return occupancy<6>(blocks, smem, dynamic);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* slam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

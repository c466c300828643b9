// Host build of the three kernels' lane programs, with the same C interface
// as the CUDA launchers minus the stream. The Adam and LM teams run their
// steps as loops over the team's threads (chain_common.cuh HostTeam), block
// by block as the kernels cut the lanes, a team past the last lane
// repeating lane L-1 without storing; the polish runs one lane after
// another. The CPU tests compile it with a host C++ compiler
// (tests/test_torch_kernel_lanes.py) and hold the kernels' arithmetic
// against the plain PyTorch versions; nothing on the main path uses it.
// Build: g++ -O1 -std=c++17 -shared -fPIC -o liblanes.so host_lanes.cpp
#include "adam_team.cuh"
#include "lm_team.cuh"
#include <cmath>
#include <vector>
using namespace slam;

constexpr int kAdamLanes = 32, kLmLanes = 4;  // lanes per block, as in adam_chain.cu / lm_chain.cu

template <typename T, int K> static void gate_lists(const T* gates, GateNz<T>* G) {
  for (int idx = 0; idx < 8 * K; ++idx) gate_nz_entry<T>(gates, G, idx);
}

template <int K> static void adam_k(const float* x0, const float* tgt, const float* gates, const float* sched, int iters, int L, float* xout) {
  GateNz<float> G[K]; gate_lists<float, K>(gates, G);
  AdamWs<K> ws;
  HostTeam<kAdamTeam, AdamThread<K>> tm;
  for (int lane = 0; lane < (L + kAdamLanes - 1) / kAdamLanes * kAdamLanes; ++lane)
    adam_team_io<K>(tm, ws, G, x0, tgt, sched, iters, lane < L ? lane : L - 1, lane < L, xout);
}
template <int K> static void lm_k(const float* x0, const float* tgt, const float* gates, int iters, int L, float* xout, float* fout) {
  GateNz<float> G[K]; gate_lists<float, K>(gates, G);
  LmWs<K> ws;
  HostTeam<kLmTeam, LmThread<K>> tm;
  for (int lane = 0; lane < (L + kLmLanes - 1) / kLmLanes * kLmLanes; ++lane)
    lm_team_io<K>(tm, ws, G, x0, tgt, iters, lane < L ? lane : L - 1, lane < L, xout, fout);
}
template <int K> static void polish_k(const double* x0, const double* tgt, const double* gates, int iters, int L, double* xout, double* fout) {
  M4<double> G[K]; load_gates<double, K>(gates, G, 0, 1);
  M4<float> G32[K]; gates_to_f32<K>(G, G32, 0, 1);
  for (int l = 0; l < L; ++l) polish_lane_io<K>(x0, tgt, G, G32, iters, l, xout, fout);
}
extern "C" {
void adam_host(const float* x0, const float* tgt, const float* gates, const float* sched, int iters, int k, int L, float* xout) {
  if (k == 2) adam_k<2>(x0, tgt, gates, sched, iters, L, xout); else adam_k<3>(x0, tgt, gates, sched, iters, L, xout);
}
void lm_host(const float* x0, const float* tgt, const float* gates, int iters, int k, int L, float* xout, float* fout) {
  if (k == 2) lm_k<2>(x0, tgt, gates, iters, L, xout, fout); else lm_k<3>(x0, tgt, gates, iters, L, xout, fout);
}
void polish_host(const double* x0, const double* tgt, const double* gates, int iters, int k, int L, double* xout, double* fout) {
  if (k == 2) polish_k<2>(x0, tgt, gates, iters, L, xout, fout); else polish_k<3>(x0, tgt, gates, iters, L, xout, fout);
}
}

// Host build of the three kernels' lane programs, with the same C interface
// as the CUDA launchers minus the stream. The teams (Adam; the LM program
// with a float residual for the ranking pass and a double one for the
// polish) run their steps as loops over the team's threads
// (chain_common.cuh HostTeam), block by block as the kernels cut the
// lanes, a team past the last lane repeating lane L-1 without storing.
// The CPU tests compile it with a host C++ compiler
// (tests/test_torch_kernel_lanes.py) and hold the kernels' arithmetic
// against the plain PyTorch versions; nothing on the main path uses it.
// Build: g++ -O1 -std=c++17 -shared -fPIC -o liblanes.so host_lanes.cpp
#include "adam_team.cuh"
#include "lm_team.cuh"
#include <cmath>
#include <vector>
using namespace slam;

constexpr int kAdamLanes = 32, kLmLanes = 4;  // lanes per block, as in adam_chain.cu / lm_chain.cu, polish_chain.cu

template <typename T, int K, typename S> static void gate_lists(const S* gates, GateNz<T>* G) {
  for (int idx = 0; idx < 8 * K; ++idx) gate_nz_entry<T>(gates, G, idx);
}

template <int K, bool Cost> static void adam_k(const float* x0, const float* tgt, const float* gates, const float* sched, int iters, int L, float* xout, float* fout) {
  GateNz<float> G[K]; gate_lists<float, K>(gates, G);
  AdamWs<K> ws;
  HostTeam<kAdamTeam, AdamThread<K>> tm;
  for (int lane = 0; lane < (L + kAdamLanes - 1) / kAdamLanes * kAdamLanes; ++lane)
    adam_team_io<K, Cost>(tm, ws, G, x0, tgt, sched, iters, lane < L ? lane : L - 1, lane < L, xout, fout);
}
// R = float: the f32 ranking pass; R = double: the polish
template <typename R, int K> static void lm_k(const R* x0, const R* tgt, const R* gates, int iters, int L, R* xout, R* fout) {
  GateNz<float> G[K]; gate_lists<float, K>(gates, G);
  GateNz<R> GR[K]; gate_lists<R, K>(gates, GR);
  LmWs<R, K> ws;
  HostTeam<kLmTeam, LmThread<R, K>> tm;
  for (int lane = 0; lane < (L + kLmLanes - 1) / kLmLanes * kLmLanes; ++lane)
    lm_team_io<R, K>(tm, ws, G, GR, x0, tgt, iters, lane < L ? lane : L - 1, lane < L, xout, fout);
}
extern "C" {
// fout may be null: then the instance without the final cost runs
void adam_host(const float* x0, const float* tgt, const float* gates, const float* sched, int iters, int k, int L, float* xout, float* fout) {
  if (k == 2 && fout) adam_k<2, true>(x0, tgt, gates, sched, iters, L, xout, fout);
  else if (k == 2) adam_k<2, false>(x0, tgt, gates, sched, iters, L, xout, fout);
  else if (fout) adam_k<3, true>(x0, tgt, gates, sched, iters, L, xout, fout);
  else adam_k<3, false>(x0, tgt, gates, sched, iters, L, xout, fout);
}
void lm_host(const float* x0, const float* tgt, const float* gates, int iters, int k, int L, float* xout, float* fout) {
  if (k == 2) lm_k<float, 2>(x0, tgt, gates, iters, L, xout, fout); else lm_k<float, 3>(x0, tgt, gates, iters, L, xout, fout);
}
void polish_host(const double* x0, const double* tgt, const double* gates, int iters, int k, int L, double* xout, double* fout) {
  if (k == 2) lm_k<double, 2>(x0, tgt, gates, iters, L, xout, fout); else lm_k<double, 3>(x0, tgt, gates, iters, L, xout, fout);
}
}

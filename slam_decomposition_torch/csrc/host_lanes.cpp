// Host build of the three kernels' lane programs, with the same C interface
// as the CUDA launchers minus the stream: the depth-K instances (K =
// 1..12) and the depth-generic programs (any K to 79, K a runtime
// argument). The teams (Adam; the LM program with a float residual for the
// ranking pass and a double one for the polish) run their steps as loops
// over the team's threads (chain_common.cuh HostTeam), block by block as the
// kernels cut the lanes, a team past the last lane repeating lane L-1
// without storing. The LM's and the polish's entries take a counter of
// J builds (may be null), as the CUDA launchers do.
// The CPU tests compile it with a host C++ compiler
// (tests/test_torch_kernel_lanes.py) and hold the kernels' arithmetic
// against the plain PyTorch versions; nothing on the main path uses it.
// Build: g++ -O1 -std=c++17 -shared -fPIC -o liblanes.so host_lanes.cpp
#include "adam_generic.cuh"
#include "lm_generic.cuh"
#include <cmath>
#include <vector>
using namespace slam;

constexpr int kAdamLanes = 32, kLmLanes = 4;  // lanes per block, as in adam_chain.cuh / lm_chain.cuh, polish_chain.cuh

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
template <typename R, int K> static void lm_k(const R* x0, const R* tgt, const R* gates, int iters, int L, R* xout, R* fout, unsigned long long* rebuilds) {
  GateNz<float> G[K]; gate_lists<float, K>(gates, G);
  GateNz<R> GR[K]; gate_lists<R, K>(gates, GR);
  LmWs<R, K> ws;
  HostTeam<kLmTeam, LmThread<R, K>> tm;
  for (int lane = 0; lane < (L + kLmLanes - 1) / kLmLanes * kLmLanes; ++lane)
    lm_team_io<R, K>(tm, ws, G, GR, x0, tgt, iters, lane < L ? lane : L - 1, lane < L, xout, fout, rebuilds);
}
// the instance of depth k (1..12); Adam's with the cost when fout is given
template <int K> static void adam_any(const float* x0, const float* tgt, const float* gates, const float* sched, int iters, int L, float* xout, float* fout) {
  if (fout) adam_k<K, true>(x0, tgt, gates, sched, iters, L, xout, fout);
  else adam_k<K, false>(x0, tgt, gates, sched, iters, L, xout, fout);
}
#define SLAM_BY_K(k, call) \
  switch (k) { case 1: call(1); break; case 2: call(2); break; case 3: call(3); break; case 4: call(4); break; \
               case 5: call(5); break; case 6: call(6); break; case 7: call(7); break; case 8: call(8); break; \
               case 9: call(9); break; case 10: call(10); break; case 11: call(11); break; case 12: call(12); break; }
// The depth-generic programs, on a 16-byte aligned buffer of one lane's
// workspace, over as many lanes a block as the kernels take (Adam:
// adam_generic.cuh adam_gen_block_lanes; the LM and the polish:
// lm_generic.cuh lm_gen_block_lanes), in depth k's slot bucket.
template <bool Cost> static void adam_gen(const float* x0, const float* tgt, const float* gates, const float* sched, int iters, int k, int L, float* xout, float* fout) {
  std::vector<F4> buf(AdamGenWs::lane_bytes(k) / sizeof(F4));
  const AdamGenWs ws(reinterpret_cast<unsigned char*>(buf.data()), k);
  const int lanes = adam_gen_block_lanes(k);
  adam_gen_by_bucket(k, [&](auto sb) {
    constexpr int SB = decltype(sb)::value;
    HostTeam<kAdamGenTeam, AdamGenThread<SB>> tm;
    for (int lane = 0; lane < (L + lanes - 1) / lanes * lanes; ++lane)
      adam_gen_team_io<SB, Cost>(tm, ws, gates, x0, tgt, sched, iters, lane < L ? lane : L - 1, lane < L, xout, fout);
  });
}
template <typename R> static void lm_gen(const R* x0, const R* tgt, const R* gates, int iters, int k, int L, R* xout, R* fout, unsigned long long* rebuilds) {
  std::vector<GateNz<float>> G(k);
  std::vector<GateNz<R>> GR(k);
  for (int idx = 0; idx < 8 * k; ++idx) {
    gate_nz_entry<float>(gates, G.data(), idx);
    gate_nz_entry<R>(gates, GR.data(), idx);
  }
  std::vector<F4> buf(LmGenWs<R>::lane_bytes(k) / sizeof(F4));
  const LmGenWs<R> ws(reinterpret_cast<unsigned char*>(buf.data()), k);
  const int lanes = lm_gen_block_lanes<R>(k);
  lm_gen_by_bucket(k, [&](auto sb) {
    constexpr int SB = decltype(sb)::value;
    HostTeam<kLmTeam, LmGenThread<R, SB>> tm;
    for (int lane = 0; lane < (L + lanes - 1) / lanes * lanes; ++lane)
      lm_gen_team_io<R, SB>(tm, ws, G.data(), GR.data(), x0, tgt, iters, lane < L ? lane : L - 1, lane < L, xout, fout, rebuilds);
  });
}
extern "C" {
// fout may be null: then the instance without the final cost runs
void adam_host(const float* x0, const float* tgt, const float* gates, const float* sched, int iters, int k, int L, float* xout, float* fout) {
#define CALL(K) adam_any<K>(x0, tgt, gates, sched, iters, L, xout, fout)
  SLAM_BY_K(k, CALL)
#undef CALL
}
void lm_host(const float* x0, const float* tgt, const float* gates, int iters, int k, int L, float* xout, float* fout, unsigned long long* rebuilds) {
#define CALL(K) lm_k<float, K>(x0, tgt, gates, iters, L, xout, fout, rebuilds)
  SLAM_BY_K(k, CALL)
#undef CALL
}
void polish_host(const double* x0, const double* tgt, const double* gates, int iters, int k, int L, double* xout, double* fout, unsigned long long* rebuilds) {
#define CALL(K) lm_k<double, K>(x0, tgt, gates, iters, L, xout, fout, rebuilds)
  SLAM_BY_K(k, CALL)
#undef CALL
}
// the depth-generic programs at any k in 1..79
void adam_host_generic(const float* x0, const float* tgt, const float* gates, const float* sched, int iters, int k, int L, float* xout, float* fout) {
  if (fout) adam_gen<true>(x0, tgt, gates, sched, iters, k, L, xout, fout);
  else adam_gen<false>(x0, tgt, gates, sched, iters, k, L, xout, fout);
}
void lm_host_generic(const float* x0, const float* tgt, const float* gates, int iters, int k, int L, float* xout, float* fout, unsigned long long* rebuilds) {
  lm_gen<float>(x0, tgt, gates, iters, k, L, xout, fout, rebuilds);
}
void polish_host_generic(const double* x0, const double* tgt, const double* gates, int iters, int k, int L, double* xout, double* fout, unsigned long long* rebuilds) {
  lm_gen<double>(x0, tgt, gates, iters, k, L, xout, fout, rebuilds);
}
// the generic blocks at depth k: kernel 0 Adam, 1 LM, 2 polish -> lanes a
// block, bytes of one lane's workspace, bytes of gate lists in the block
// (0 for all three: Adam reads the gates and the LM and the polish their
// lists from device memory), and the most lanes an SM the registers hold
// (the slot bucket's cap)
void generic_shape(int kernel, int k, int* lanes, long* lane_bytes, long* gate_bytes, int* cap) {
  if (kernel == 0) { *lanes = adam_gen_block_lanes(k); *lane_bytes = (long)AdamGenWs::lane_bytes(k); *gate_bytes = 0; *cap = adam_gen_lanes_cap(adam_gen_bucket(k)); }
  else if (kernel == 1) { *lanes = lm_gen_block_lanes<float>(k); *lane_bytes = (long)LmGenWs<float>::lane_bytes(k); *gate_bytes = 0; *cap = lm_gen_lanes_cap(lm_gen_bucket(k)); }
  else { *lanes = lm_gen_block_lanes<double>(k); *lane_bytes = (long)LmGenWs<double>::lane_bytes(k); *gate_bytes = 0; *cap = lm_gen_lanes_cap(lm_gen_bucket(k)); }
}
}

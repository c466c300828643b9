// Host build of the three kernels' lane entries (chain_common.cuh), one
// lane after another on the CPU, with the same C interface as the CUDA
// launchers minus the stream. The CPU tests compile it with a host C++
// compiler (tests/test_torch_kernel_lanes.py) and hold the kernels'
// arithmetic against the plain PyTorch versions; nothing on the main path
// uses it. Build: g++ -O1 -std=c++17 -shared -fPIC -o liblanes.so host_lanes.cpp
#include "chain_common.cuh"
#include <cmath>
using namespace slam;
template <int K> static void adam_k(const float* x0, const float* tgt, const float* gates, const float* sched, int iters, int L, float* xout) {
  M4<float> G[K]; load_gates<float, K>(gates, G, 0, 1);
  for (int l = 0; l < L; ++l) adam_lane_io<K>(x0, tgt, G, sched, iters, l, xout);
}
template <int K> static void lm_k(const float* x0, const float* tgt, const float* gates, int iters, int L, float* xout, float* fout) {
  M4<float> G[K]; load_gates<float, K>(gates, G, 0, 1);
  for (int l = 0; l < L; ++l) lm_lane_io<K>(x0, tgt, G, iters, l, xout, fout);
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

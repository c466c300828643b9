// Math shared by the three chain kernels (adam_chain.cu, lm_chain.cu,
// polish_chain.cu). Replaces the device helpers of the JAX package's
// ops/pallas_chain.py:40-149 (_u3, _layer, _matmul4, _const_matmul, _chain,
// _phase_residual_tiles) and, with derivatives written out by hand, the
// jax.grad / jax.linearize calls inside those kernels.
//
// The chain is U(x) = L_K G_{K-1} ... L_1 G_0 L_0 with
// L_i = u3(x[6i..6i+2]) (x) u3(x[6i+3..6i+5]) and constant 2Q gates G_i.
// Everything is templated on the scalar type (float / double) and on K,
// so loops over layers have compile-time trip counts.
//
// Derivatives use prefix / suffix products of the chain:
//   P_0 = I, P_{i+1} = G_i L_i P_i          (what stands right of L_i)
//   S_K = I, S_{i-1} = S_i L_i G_{i-1}      (what stands left of L_i)
//   U = S_i L_i P_i for every i, so dU/dx_p = S_i (dL_i/dx_p) P_i.
//
// What is here: complex 2x2 / 4x4 helpers; u3 from a table of its sines
// and cosines (Trig), with one derivative at a time; products with a
// Kronecker layer applied to one column or row (kron_col, kron_row);
// the gates as lists of their nonzeros (GateNz), multiplied by one column
// or row; and the team types that run the Adam and LM programs
// (adam_team.cuh, lm_team.cuh) on the card and, step by step, on the host.
//
// SLAM_HD makes every function callable from host code as well, so the
// lane programs can be compiled and checked by a host C++ compiler
// (host_lanes.cpp).

#pragma once

#include <math.h>
#include <stddef.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>

#include <type_traits>
#endif

#if defined(__CUDACC__)
#define SLAM_HD __host__ __device__ __forceinline__
#else
#define SLAM_HD inline
#endif

namespace slam {

// ------------------------------------------------------------ scalars

SLAM_HD float sqrt_(float v) { return sqrtf(v); }
SLAM_HD double sqrt_(double v) { return sqrt(v); }

// |t|^2 guard of the phase factor (the plain version's eps)
template <typename T> struct Eps;
template <> struct Eps<float> { static SLAM_HD float v() { return 1e-30f; } };
template <> struct Eps<double> { static SLAM_HD double v() { return 1e-300; } };

constexpr float kF32Tiny = 1.17549435e-38f;  // CG denominator guard
constexpr float kF32Max = 3.40282347e+38f;
constexpr int kCgExtra = 8;                   // CG runs N + 8 iterations
// sm_90's shared memory: 228 KB an SM, 1 KB of it reserved per block
constexpr size_t kSmemPerSm = 228 * 1024, kSmemReservedPerBlock = 1024;

// ------------------------------------------------------------ complex

template <typename T> struct C { T re, im; };

template <typename T> SLAM_HD C<T> cmk(T r, T i) { C<T> z; z.re = r; z.im = i; return z; }
template <typename T> SLAM_HD C<T> cadd(C<T> a, C<T> b) { return cmk(a.re + b.re, a.im + b.im); }
template <typename T> SLAM_HD C<T> cmul(C<T> a, C<T> b) {
  return cmk(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re);
}
// conj(a) * b
template <typename T> SLAM_HD C<T> cjmul(C<T> a, C<T> b) {
  return cmk(a.re * b.re + a.im * b.im, a.re * b.im - a.im * b.re);
}

template <typename T> struct M2 { C<T> e[4]; };   // row-major 2x2
// four floats read as one 16-byte shared-memory load
struct alignas(16) F4 { float v[4]; };
SLAM_HD const F4& f4(const float* p) { return *reinterpret_cast<const F4*>(p); }

// ------------------------------------------------------------ layers

// The eight sines and cosines one u3(theta, phi, lam) is built from.
template <typename T> struct Trig { T c, s, cp, sp, cl, sl, cpl, spl; };

// one range reduction for both on the card (the same values as sinf, cosf)
SLAM_HD void sincos_(float v, float* s, float* c) {
#if defined(__CUDA_ARCH__)
  sincosf(v, s, c);
#else
  *s = sinf(v);
  *c = cosf(v);
#endif
}
SLAM_HD void sincos_(double v, double* s, double* c) {
#if defined(__CUDA_ARCH__)
  sincos(v, s, c);
#else
  *s = sin(v);
  *c = cos(v);
#endif
}

template <typename T> SLAM_HD Trig<T> u3_trig(const T* a) {
  Trig<T> g;
  sincos_(a[0] * T(0.5), &g.s, &g.c);
  sincos_(a[1], &g.sp, &g.cp);
  sincos_(a[2], &g.sl, &g.cl);
  sincos_(a[1] + a[2], &g.spl, &g.cpl);
  return g;
}

// One of the four sine / cosine pairs of u3_trig (j = 0 theta/2, 1 phi, 2
// lam, 3 phi + lam), so that four threads can share one u3's trig
template <typename T> SLAM_HD void u3_trig_pair(const T* a, int j, Trig<T>& g) {
  const T arg = j == 0 ? a[0] * T(0.5) : j == 1 ? a[1] : j == 2 ? a[2] : a[1] + a[2];
  T s, c;
  sincos_(arg, &s, &c);
  if (j == 0) { g.s = s; g.c = c; }
  else if (j == 1) { g.sp = s; g.cp = c; }
  else if (j == 2) { g.sl = s; g.cl = c; }
  else { g.spl = s; g.cpl = c; }
}

// The partial derivative of u3(theta, phi, lam) in angle j (0 theta, 1
// phi, 2 lam), from its sines and cosines.
template <typename T> SLAM_HD void u3_deriv(const Trig<T>& g, int j, M2<T>& dU) {
  const T c = g.c, s = g.s, cp = g.cp, sp = g.sp, cl = g.cl, sl = g.sl, cpl = g.cpl, spl = g.spl;
  const T h = T(0.5);
  if (j == 0) {
    dU.e[0] = cmk(-h * s, T(0));
    dU.e[1] = cmk(-h * cl * c, -h * sl * c);
    dU.e[2] = cmk(h * cp * c, h * sp * c);
    dU.e[3] = cmk(-h * cpl * s, -h * spl * s);
  } else if (j == 1) {
    dU.e[0] = cmk(T(0), T(0));
    dU.e[1] = cmk(T(0), T(0));
    dU.e[2] = cmk(-sp * s, cp * s);
    dU.e[3] = cmk(-spl * c, cpl * c);
  } else {
    dU.e[0] = cmk(T(0), T(0));
    dU.e[1] = cmk(sl * s, -cl * s);
    dU.e[2] = cmk(T(0), T(0));
    dU.e[3] = cmk(-spl * c, cpl * c);
  }
}

// qiskit u3(theta, phi, lam) from its sines and cosines; with dU !=
// nullptr also the three partial derivatives dU[0] (theta), dU[1] (phi),
// dU[2] (lam).
template <typename T> SLAM_HD void u3_build(const Trig<T>& g, M2<T>& U, M2<T>* dU) {
  const T c = g.c, s = g.s, cp = g.cp, sp = g.sp, cl = g.cl, sl = g.sl, cpl = g.cpl, spl = g.spl;
  U.e[0] = cmk(c, T(0));
  U.e[1] = cmk(-cl * s, -sl * s);
  U.e[2] = cmk(cp * s, sp * s);
  U.e[3] = cmk(cpl * c, spl * c);
  if (dU) {
#pragma unroll
    for (int j = 0; j < 3; ++j) u3_deriv(g, j, dU[j]);
  }
}

// w = (A (x) B) v for a column 4-vector v: w[2a+c] = sum_b A[a][b] sum_d B[c][d] v[2b+d]
template <typename T> SLAM_HD void kron_col(const M2<T>& A, const M2<T>& B, const C<T>* v, C<T>* w) {
  C<T> Y[2][2];
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int c = 0; c < 2; ++c) Y[b][c] = cadd(cmul(B.e[2 * c], v[2 * b]), cmul(B.e[2 * c + 1], v[2 * b + 1]));
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c) w[2 * a + c] = cadd(cmul(A.e[2 * a], Y[0][c]), cmul(A.e[2 * a + 1], Y[1][c]));
}

// w = u^T (A (x) B) for a row 4-vector u: w[2b+d] = sum_a A[a][b] sum_c u[2a+c] B[c][d]
template <typename T> SLAM_HD void kron_row(const M2<T>& A, const M2<T>& B, const C<T>* u, C<T>* w) {
  C<T> Y[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int d = 0; d < 2; ++d) Y[a][d] = cadd(cmul(u[2 * a], B.e[d]), cmul(u[2 * a + 1], B.e[2 + d]));
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int d = 0; d < 2; ++d) w[2 * b + d] = cadd(cmul(A.e[b], Y[0][d]), cmul(A.e[2 + b], Y[1][d]));
}

// ------------------------------------------------------------ sparse gates

// The nonzero entries of one constant gate, listed per row (for G v) and
// per column (for u^T G), each with its kind: bit 1 a real part, bit 2 an
// imaginary part. sqiSwap has 6 nonzeros, each purely real or purely
// imaginary, so a product with it costs 6 two-term multiply-adds instead
// of 16 complex ones (the TPU kernel's _const_matmul). Every thread of a
// team multiplies by the same gate, so the loops and kind tests below are
// uniform across the warp.
template <typename T> struct GateNz {
  int rn[4], cn[4];      // nonzeros in row i / column q
  int rc[4][4], cr[4][4];  // their column / row indices
  int rk[4][4], ck[4][4];  // their kinds
  C<T> rv[4][4], cv[4][4];
};

// Entry idx in [0, 8K) of the lists of K gates g (K, 4, 4) interleaved
// complex, cast to T: gate idx / 8, row idx % 8 for idx % 8 < 4, else
// column idx % 8 - 4.
template <typename T, typename S>
SLAM_HD void gate_nz_entry(const S* g, GateNz<T>* out, int idx) {
  GateNz<T>& G = out[idx / 8];
  const S* m = g + 32 * (idx / 8);
  const int line = idx % 8 % 4;
  const bool row = idx % 8 < 4;
  int n = 0;
  for (int j = 0; j < 4; ++j) {
    const int e = row ? 4 * line + j : 4 * j + line;
    const T re = T(m[2 * e]), im = T(m[2 * e + 1]);
    const int kind = (re != T(0) ? 1 : 0) | (im != T(0) ? 2 : 0);
    if (kind == 0) continue;
    if (row) { G.rc[line][n] = j; G.rk[line][n] = kind; G.rv[line][n] = cmk(re, im); }
    else { G.cr[line][n] = j; G.ck[line][n] = kind; G.cv[line][n] = cmk(re, im); }
    ++n;
  }
  if (row) G.rn[line] = n; else G.cn[line] = n;
}

// acc += g v with only the parts of g that are nonzero
template <typename T> SLAM_HD void cmac_kind(C<T>& acc, C<T> g, int kind, C<T> v) {
  if (kind & 1) { acc.re += g.re * v.re; acc.im += g.re * v.im; }
  if (kind & 2) { acc.re -= g.im * v.im; acc.im += g.im * v.re; }
}

// w = G y for a column 4-vector y (y is read through the lists, so it may
// sit in shared memory; w is indexed statically and stays in registers)
template <typename T> SLAM_HD void gate_col(const GateNz<T>& G, const C<T>* y, C<T>* w) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    C<T> acc = cmk(T(0), T(0));
    for (int s = 0; s < G.rn[i]; ++s) cmac_kind(acc, G.rv[i][s], G.rk[i][s], y[G.rc[i][s]]);
    w[i] = acc;
  }
}

// w = u^T G for a row 4-vector u
template <typename T> SLAM_HD void gate_row(const GateNz<T>& G, const C<T>* u, C<T>* w) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    C<T> acc = cmk(T(0), T(0));
    for (int s = 0; s < G.cn[q]; ++s) cmac_kind(acc, G.cv[q][s], G.ck[q][s], u[G.cr[q][s]]);
    w[q] = acc;
  }
}

// ------------------------------------------------------------ teams
// A team of S threads works on one lane (S = 32: a warp; S = 4: a quarter
// of one). The team's program is written once, as steps: each step is a
// loop `for (t = tm.first(); t < tm.last(); ++t)` over the team's threads
// that reads the lane's shared workspace and tm.th(t), the thread's own
// registers. Steps are separated by tm.sync() or by tm.sum(), a butterfly
// sum over the team whose result every thread receives.
//
// On the card (DevTeam) the loop runs once, for the calling thread, and
// th(t) is that thread's register state; sync() is __syncwarp() and sum()
// shuffles. On the host (HostTeam, host_lanes.cpp) the loop runs over all
// S threads one after another with an array of register states, so a step
// must only write its own slots and read what earlier steps wrote; the
// butterfly adds in the same order as the shuffles.

#define SLAM_EACH(tm, t) for (int t = (tm).first(); t < (tm).last(); ++t)

#if defined(__CUDACC__)
template <int S, class Th> struct DevTeam {
  int t0;
  Th reg;
  __device__ __forceinline__ explicit DevTeam(int t) : t0(t) {}
  __device__ __forceinline__ int first() const { return t0; }
  __device__ __forceinline__ int last() const { return t0 + 1; }
  __device__ __forceinline__ Th& th(int) { return reg; }
  __device__ __forceinline__ const Th& any() const { return reg; }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  template <typename V, int n> __device__ __forceinline__ void sum(V (Th::*f)[n]) {
#pragma unroll
    for (int i = 0; i < n; ++i) {
      V v = (reg.*f)[i];
#pragma unroll
      for (int o = S / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      (reg.*f)[i] = v;
    }
  }
};
#endif

template <int S, class Th> struct HostTeam {
  Th regs[S];
  int first() const { return 0; }
  int last() const { return S; }
  Th& th(int t) { return regs[t]; }
  const Th& any() const { return regs[0]; }
  void sync() const {}
  template <typename V, int n> void sum(V (Th::*f)[n]) {
    for (int i = 0; i < n; ++i) {
      V v[S], w[S];
      for (int t = 0; t < S; ++t) v[t] = (regs[t].*f)[i];
      for (int o = S / 2; o > 0; o >>= 1) {
        for (int t = 0; t < S; ++t) w[t] = v[t] + v[t ^ o];
        for (int t = 0; t < S; ++t) v[t] = w[t];
      }
      for (int t = 0; t < S; ++t) (regs[t].*f)[i] = v[t];
    }
  }
};

// Chain depths with a kernel (ops/chain_kernels.py KERNEL_KS): 1..kInstMaxK
// as one template instance each, kInstMaxK + 1..kMaxK through the
// depth-generic programs, in which K is a runtime argument. kMaxK = 79 was
// the deepest chain at which the polish's one-lane block fit in 227 KB of
// shared memory beside its f32 and f64 gate lists. Those lists are now in
// device memory (lm_generic.cuh), and Adam reads its gates from there
// (adam_generic.cuh), so shared memory no longer stops the depths there:
// the LM's and the polish's one-lane blocks would fit to their last slot
// bucket's K = 84 (the polish's lane: 120.7 KB), and Adam's unit, a warp
// of 2 lanes of 192 B a layer and 256-383 B besides, to K = 602 (226.6 KB;
// host_lanes.cpp generic_shape, tests/test_torch_kernel_lanes.py), though
// past K = 79 its registers would need more layer buckets than its 5.
// kMaxK stays 79 all the same, for every kernel alike: deeper chains are
// later work.
constexpr int kInstMaxK = 12;
constexpr int kMaxK = 79;

#if defined(__CUDACC__)
// ------------------------------------------------------------ launch glue

// The kernels are launched from a library with its own CUDA runtime, so
// make the device that owns the tensors current before launching.
inline cudaError_t use_device_of(const void* ptr) {
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, ptr);
  if (err != cudaSuccess) return err;
  if (attr.type != cudaMemoryTypeDevice) return cudaErrorInvalidValue;
  return cudaSetDevice(attr.device);
}

// A block's shared memory, described by a struct S of its gate lists and
// lane workspaces. A kernel may declare at most 48 KB; where S is larger
// (the deep chains' Adam and polish blocks) the block takes S as dynamic
// shared memory, found at dynamic_smem<S>(): the launch passes kDynSmem<S>
// bytes after allow_smem<S> has raised the kernel's limit to them. A block
// that fits declares its arrays as before (one struct in their place gave
// Adam's K <= 4 instances other registers).
constexpr size_t kStaticSmemMax = 48 * 1024;
template <class S> constexpr size_t kDynSmem = sizeof(S) <= kStaticSmemMax ? 0 : sizeof(S);

template <class S> __device__ __forceinline__ S& dynamic_smem() {
  extern __shared__ __align__(16) unsigned char dyn_smem_bytes[];
  return *reinterpret_cast<S*>(dyn_smem_bytes);
}

template <class S, class Kernel> cudaError_t allow_smem(Kernel* kernel) {
  if constexpr (kDynSmem<S> == 0) return cudaSuccess;
  else return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDynSmem<S>);
}

// Resident blocks per SM that a block of shared memory S leaves room for on
// sm_90 (kSmemPerSm, kSmemReservedPerBlock below). Where it is below
// the register budget's block count, the kernels take it as that count:
// a tighter register cap would buy spills and no more resident blocks.
template <class S> constexpr int kSmemBlocks = (int)(kSmemPerSm / (sizeof(S) + kSmemReservedPerBlock));
constexpr int min_blocks(int regs, int smem) { return regs < smem ? regs : smem; }

// The chain depths the kernels are instantiated for:
// f(std::integral_constant<int, K>{}) for K == k in 1..kInstMaxK, else
// cudaErrorInvalidValue. Deeper chains, to kMaxK, run the depth-generic
// programs (adam_generic.cuh, lm_generic.cuh), whose entry points the
// instances' entry points hand them to.
template <int K = 1, class F> cudaError_t by_k(int k, F&& f) {
  if constexpr (K > kInstMaxK) return cudaErrorInvalidValue;
  else return k == K ? f(std::integral_constant<int, K>{}) : by_k<K + 1>(k, f);
}
#endif

// ------------------------------------------------------------ generic blocks
// A depth-generic block holds lane workspaces in dynamic shared memory,
// sized from K at launch (adam_gen_lanes, lm_gen_lanes), at most
// kBlockSmemMax (the launchers refuse a larger block).
constexpr size_t kBlockSmemMax = 227 * 1024;

SLAM_HD size_t align16(size_t bytes) { return (bytes + 15) / 16 * 16; }

// Carves 16-byte aligned arrays out of a lane's workspace in order; with
// base == nullptr it only counts their bytes.
struct Carve {
  unsigned char* base;
  size_t off;
  template <typename T> SLAM_HD T* take(size_t n) {
    T* q = base ? reinterpret_cast<T*>(base + off) : nullptr;
    off += align16(sizeof(T) * n);
    return q;
  }
};

}  // namespace slam

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
// or row; the team types that run the Adam and LM programs (adam_team.cuh,
// lm_team.cuh) on the card and, step by step, on the host; and the
// one-thread LM body of the polish (lm_lane<double, K>, polish_lane_io).
//
// SLAM_HD makes every function callable from host code as well, so the
// lane programs can be compiled and checked by a host C++ compiler
// (host_lanes.cpp).

#pragma once

#include <math.h>
#include <stddef.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
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
constexpr int kCgExtra = 8;                   // CG runs N + 8 iterations

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
template <typename T> struct M4 { C<T> e[16]; };  // row-major 4x4

template <typename T> SLAM_HD void set_identity(M4<T>& A) {
#pragma unroll
  for (int i = 0; i < 16; ++i) A.e[i] = cmk(T(i % 5 == 0 ? 1 : 0), T(0));
}

// C = A B (C must not alias A or B)
template <typename T> SLAM_HD void matmul4(const M4<T>& A, const M4<T>& B, M4<T>& Cm) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      C<T> acc = cmul(A.e[4 * i], B.e[j]);
#pragma unroll
      for (int q = 1; q < 4; ++q) acc = cadd(acc, cmul(A.e[4 * i + q], B.e[4 * q + j]));
      Cm.e[4 * i + j] = acc;
    }
  }
}

// tr(T^dag U) = sum_ij conj(T_ij) U_ij
template <typename T> SLAM_HD C<T> overlap(const M4<T>& Tg, const M4<T>& U) {
  C<T> t = cjmul(Tg.e[0], U.e[0]);
#pragma unroll
  for (int i = 1; i < 16; ++i) t = cadd(t, cjmul(Tg.e[i], U.e[i]));
  return t;
}

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
  *s = sin(v);
  *c = cos(v);
}

template <typename T> SLAM_HD Trig<T> u3_trig(const T* a) {
  Trig<T> g;
  sincos_(a[0] * T(0.5), &g.s, &g.c);
  sincos_(a[1], &g.sp, &g.cp);
  sincos_(a[2], &g.sl, &g.cl);
  sincos_(a[1] + a[2], &g.spl, &g.cpl);
  return g;
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

// qiskit u3(theta, phi, lam) from a[0..2] (and its derivatives, as u3_build)
template <typename T> SLAM_HD void u3(const T* a, M2<T>& U, M2<T>* dU) {
  u3_build(u3_trig(a), U, dU);
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
// complex: gate idx / 8, row idx % 8 for idx % 8 < 4, else column idx % 8 - 4.
template <typename T>
SLAM_HD void gate_nz_entry(const T* g, GateNz<T>* out, int idx) {
  GateNz<T>& G = out[idx / 8];
  const T* m = g + 32 * (idx / 8);
  const int line = idx % 8 % 4;
  const bool row = idx % 8 < 4;
  int n = 0;
  for (int j = 0; j < 4; ++j) {
    const int e = row ? 4 * line + j : 4 * j + line;
    const T re = m[2 * e], im = m[2 * e + 1];
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
  template <int n> __device__ __forceinline__ void sum(float (Th::*f)[n]) {
#pragma unroll
    for (int i = 0; i < n; ++i) {
      float v = (reg.*f)[i];
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
  template <int n> void sum(float (Th::*f)[n]) {
    for (int i = 0; i < n; ++i) {
      float v[S], w[S];
      for (int t = 0; t < S; ++t) v[t] = (regs[t].*f)[i];
      for (int o = S / 2; o > 0; o >>= 1) {
        for (int t = 0; t < S; ++t) w[t] = v[t] + v[t ^ o];
        for (int t = 0; t < S; ++t) v[t] = w[t];
      }
      for (int t = 0; t < S; ++t) (regs[t].*f)[i] = v[t];
    }
  }
};

// L = A (x) B: L[2a+c][2b+d] = A[a][b] B[c][d]
template <typename T> SLAM_HD void kron2(const M2<T>& A, const M2<T>& B, M4<T>& L) {
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int d = 0; d < 2; ++d)
          L.e[(2 * a + c) * 4 + 2 * b + d] = cmul(A.e[2 * a + b], B.e[2 * c + d]);
}

// ------------------------------------------------------------ chain

template <typename T, int K> SLAM_HD void chain(const T* x, const M4<T>* G, M4<T>& U) {
  M2<T> A, B;
  M4<T> L, tmp;
  u3(x, A, (M2<T>*)nullptr);
  u3(x + 3, B, (M2<T>*)nullptr);
  kron2(A, B, U);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    matmul4(G[i], U, tmp);
    u3(x + 6 * (i + 1), A, (M2<T>*)nullptr);
    u3(x + 6 * (i + 1) + 3, B, (M2<T>*)nullptr);
    kron2(A, B, L);
    matmul4(L, tmp, U);
  }
}

// Phase-aligned residual r = vec(V - e^{i phi} T), e^{i phi} = t/|t|,
// t = tr(T^dag V): r[0..15] real parts, r[16..31] imaginary parts.
template <typename T, int K>
SLAM_HD void residual(const T* x, const M4<T>& Tg, const M4<T>* G, T* r) {
  M4<T> V;
  chain<T, K>(x, G, V);
  const C<T> t = overlap(Tg, V);
  const T mag = sqrt_(t.re * t.re + t.im * t.im + Eps<T>::v());
  const C<T> z = cmk(t.re / mag, t.im / mag);
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const C<T> zt = cmul(z, Tg.e[e]);
    r[e] = V.e[e].re - zt.re;
    r[16 + e] = V.e[e].im - zt.im;
  }
}

template <typename T, int N> SLAM_HD T sumsq(const T* r) {
  T f = T(0);
#pragma unroll
  for (int i = 0; i < N; ++i) f += r[i] * r[i];
  return f;
}

// Layers, their u3 factors, and the prefix products P_0..P_K.
template <typename T, int K> struct ChainParts {
  M2<T> A[K + 1], B[K + 1];   // the two u3 factors of each layer
  M4<T> L[K + 1];             // layers
  M4<T> P[K + 1];             // prefix products
  M4<T> U;                    // the chain
};

template <typename T, int K>
SLAM_HD void chain_parts(const T* x, const M4<T>* G, ChainParts<T, K>& cp) {
  set_identity(cp.P[0]);
  M4<T> tmp;
#pragma unroll
  for (int i = 0; i <= K; ++i) {
    u3(x + 6 * i, cp.A[i], (M2<T>*)nullptr);
    u3(x + 6 * i + 3, cp.B[i], (M2<T>*)nullptr);
    kron2(cp.A[i], cp.B[i], cp.L[i]);
    if (i < K) {
      matmul4(cp.L[i], cp.P[i], tmp);
      matmul4(G[i], tmp, cp.P[i + 1]);
    }
  }
  matmul4(cp.L[K], cp.P[K], cp.U);
}

// ------------------------------------------------------------ LM

// J[p][0..31] = d r / d x_p of the phase residual, in f32 (the plain
// version's jacfwd). Includes the derivative of the phase factor:
// d(t/|t|) = i z Im(conj(z) dt) / |t|.
template <int K>
SLAM_HD void jacobian(const float* x, const M4<float>& Tg, const M4<float>* G, float (*J)[32]) {
  ChainParts<float, K> cp;
  chain_parts<float, K>(x, G, cp);
  M4<float> S[K + 1], tmp, D, Q;
  set_identity(S[K]);
#pragma unroll
  for (int i = K; i > 0; --i) {
    matmul4(S[i], cp.L[i], tmp);
    matmul4(tmp, G[i - 1], S[i - 1]);
  }
  const C<float> t = overlap(Tg, cp.U);
  const float mag = sqrtf(t.re * t.re + t.im * t.im + Eps<float>::v());
  const C<float> z = cmk(t.re / mag, t.im / mag);
#pragma unroll 1
  for (int i = 0; i <= K; ++i) {
    M2<float> dA[3], dB[3], Ai, Bi;
    u3(x + 6 * i, Ai, dA);
    u3(x + 6 * i + 3, Bi, dB);
#pragma unroll 1
    for (int j = 0; j < 6; ++j) {
      M4<float> dL;
      if (j < 3) kron2(dA[j], Bi, dL);
      else kron2(Ai, dB[j - 3], dL);
      matmul4(dL, cp.P[i], Q);
      matmul4(S[i], Q, D);
      const C<float> dt = overlap(Tg, D);
      const float w = (z.re * dt.im - z.im * dt.re) / mag;  // Im(conj(z) dt)/|t|
      const C<float> dz = cmk(-z.im * w, z.re * w);
      float* col = J[6 * i + j];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const C<float> dzt = cmul(dz, Tg.e[e]);
        col[e] = D.e[e].re - dzt.re;
        col[16 + e] = D.e[e].im - dzt.im;
      }
    }
  }
}

// x = (A + lam I)^{-1} b by N + 8 CG iterations (JAX gauss_newton._spd_solve)
template <int N>
SLAM_HD void cg_solve(const float (*A)[N], float lam, const float* b, float* xs) {
  float r[N], p[N], Ap[N];
  float rs = 0.f;
#pragma unroll 1
  for (int i = 0; i < N; ++i) { xs[i] = 0.f; r[i] = b[i]; p[i] = b[i]; rs += b[i] * b[i]; }
#pragma unroll 1
  for (int it = 0; it < N + kCgExtra; ++it) {
    float pAp = 0.f;
#pragma unroll 1
    for (int i = 0; i < N; ++i) {
      float acc = lam * p[i];
      for (int j = 0; j < N; ++j) acc += A[i][j] * p[j];
      Ap[i] = acc;
      pAp += p[i] * acc;
    }
    // guards keep NaN (as torch.clamp_min does) but lift 0 and underflow
    const float alpha = rs / (pAp < kF32Tiny ? kF32Tiny : pAp);
    float rs_new = 0.f;
#pragma unroll 1
    for (int i = 0; i < N; ++i) {
      xs[i] += alpha * p[i];
      r[i] -= alpha * Ap[i];
      rs_new += r[i] * r[i];
    }
    const float beta = rs_new / (rs < kF32Tiny ? kF32Tiny : rs);
#pragma unroll 1
    for (int i = 0; i < N; ++i) p[i] = r[i] + beta * p[i];
    rs = rs_new;
  }
}

// Levenberg-Marquardt on the phase residual, in place on x; the residual,
// trial step and accept test in R (float: the ranking pass, double: the
// polish), J / normal equations / CG in f32. Returns the final accepted
// ||r||^2 (JAX gauss_newton.lm_one; pallas_chain.py lm_block, polish_block).
template <typename R, int K>
SLAM_HD R lm_lane(R* x, const M4<R>& Tg, const M4<float>& T32, const M4<R>* G,
                  const M4<float>* G32, int iters) {
  constexpr int N = 6 * (K + 1);
  R r[32], rn[32], xn[N];
  float xf[N], b[N], dx[N];
  float J[N][32];
  float A[N][N];
  residual<R, K>(x, Tg, G, r);
  R f0 = sumsq<R, 32>(r);
  R lam = R(1e-3);
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int p = 0; p < N; ++p) xf[p] = (float)x[p];
    jacobian<K>(xf, T32, G32, J);
#pragma unroll 1
    for (int i = 0; i < N; ++i) {
#pragma unroll 1
      for (int j = i; j < N; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < 32; ++e) acc += J[i][e] * J[j][e];
        A[i][j] = acc;
        A[j][i] = acc;
      }
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < 32; ++e) acc += J[i][e] * (float)r[e];
      b[i] = -acc;
    }
    cg_solve<N>(A, (float)lam, b, dx);
#pragma unroll
    for (int p = 0; p < N; ++p) xn[p] = x[p] + (R)dx[p];
    residual<R, K>(xn, Tg, G, rn);
    const R fn = sumsq<R, 32>(rn);
    if (fn < f0) {  // a NaN trial step is "not improved"
#pragma unroll
      for (int p = 0; p < N; ++p) x[p] = xn[p];
#pragma unroll
      for (int e = 0; e < 32; ++e) r[e] = rn[e];
      f0 = fn;
      lam = lam * R(0.3);
    } else {
      lam = lam * R(8.0);
    }
    lam = lam < R(1e-14) ? R(1e-14) : (lam > R(1e3) ? R(1e3) : lam);
  }
  return f0;
}

// ------------------------------------------------------------ polish lane
// One lane of the polish from the raw arrays: load x0 and the target, run,
// store. The CUDA kernel calls it with the gates in shared memory; the host
// build (host_lanes.cpp) calls it in a loop over lanes. Arrays are
// row-major; complex values are interleaved (re, im).

constexpr double kFourPi = 4.0 * 3.14159265358979323846;

// copy of the K constant gates into G, elements start, start + stride, ...
// (a block's threads share the copy into shared memory)
template <typename T, int K>
SLAM_HD void load_gates(const T* g, M4<T>* G, int start, int stride) {
  for (int e = start; e < 16 * K; e += stride) G[e / 16].e[e % 16] = cmk(g[2 * e], g[2 * e + 1]);
}

template <int K>
SLAM_HD void gates_to_f32(const M4<double>* G, M4<float>* G32, int start, int stride) {
  for (int e = start; e < 16 * K; e += stride)
    G32[e / 16].e[e % 16] = cmk((float)G[e / 16].e[e % 16].re, (float)G[e / 16].e[e % 16].im);
}

template <typename T> SLAM_HD void load_target(const T* tgt, int lane, M4<T>& Tg) {
  const T* t = tgt + 32 * (size_t)lane;
#pragma unroll
  for (int e = 0; e < 16; ++e) Tg.e[e] = cmk(t[2 * e], t[2 * e + 1]);
}

// the polish: angles reduced mod 4 pi first (u3 is 4 pi-periodic in every
// angle), residual in f64, Jacobian from the f32 copies of T and G
template <int K>
SLAM_HD void polish_lane_io(const double* __restrict__ x0, const double* __restrict__ tgt,
                            const M4<double>* __restrict__ G, const M4<float>* __restrict__ G32,
                            int iters, int lane, double* __restrict__ xout,
                            double* __restrict__ fout) {
  constexpr int N = 6 * (K + 1);
  double x[N];
#pragma unroll
  for (int p = 0; p < N; ++p) {
    const double v = x0[(size_t)lane * N + p];
    x[p] = v - kFourPi * rint(v / kFourPi);
  }
  M4<double> Tg;
  M4<float> T32;
  load_target(tgt, lane, Tg);
#pragma unroll
  for (int e = 0; e < 16; ++e) T32.e[e] = cmk((float)Tg.e[e].re, (float)Tg.e[e].im);
  fout[lane] = lm_lane<double, K>(x, Tg, T32, G, G32, iters);
#pragma unroll
  for (int p = 0; p < N; ++p) xout[(size_t)lane * N + p] = x[p];
}

#if defined(__CUDACC__)
// ------------------------------------------------------------ launch glue

constexpr int kBlock = 64;  // threads (lanes) per block of the polish

// The kernels are launched from a library with its own CUDA runtime, so
// make the device that owns the tensors current before launching.
inline cudaError_t use_device_of(const void* ptr) {
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, ptr);
  if (err != cudaSuccess) return err;
  if (attr.type != cudaMemoryTypeDevice) return cudaErrorInvalidValue;
  return cudaSetDevice(attr.device);
}
#endif

}  // namespace slam

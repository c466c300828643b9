// Per-lane math shared by the three chain kernels (adam_chain.cu,
// lm_chain.cu, polish_chain.cu). Replaces the device helpers of the JAX
// package's ops/pallas_chain.py:40-149 (_u3, _layer, _matmul4,
// _const_matmul, _chain, _phase_residual_tiles) and, with derivatives
// written out by hand, the jax.grad / jax.linearize calls inside those
// kernels.
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
// The Adam gradient only needs t = tr(T^dag U) and its derivatives: with
// W_i = P_i T^dag S_i, dt/dx_p = sum_ab W_i[b][a] dL_i[a][b], which the
// Kronecker structure of L_i reduces to 2x2 contractions.
//
// SLAM_HD makes every function callable from host code as well, so the
// lane bodies can be compiled and checked by a host C++ compiler.

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

SLAM_HD float sin_(float v) { return sinf(v); }
SLAM_HD double sin_(double v) { return sin(v); }
SLAM_HD float cos_(float v) { return cosf(v); }
SLAM_HD double cos_(double v) { return cos(v); }
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

// qiskit u3(theta, phi, lam) from a[0..2]; with dU != nullptr also the
// three partial derivatives dU[0] (theta), dU[1] (phi), dU[2] (lam).
template <typename T> SLAM_HD void u3(const T* a, M2<T>& U, M2<T>* dU) {
  const T c = cos_(a[0] * T(0.5)), s = sin_(a[0] * T(0.5));
  const T cp = cos_(a[1]), sp = sin_(a[1]);
  const T cl = cos_(a[2]), sl = sin_(a[2]);
  const T cpl = cos_(a[1] + a[2]), spl = sin_(a[1] + a[2]);
  U.e[0] = cmk(c, T(0));
  U.e[1] = cmk(-cl * s, -sl * s);
  U.e[2] = cmk(cp * s, sp * s);
  U.e[3] = cmk(cpl * c, spl * c);
  if (dU) {
    const T h = T(0.5);
    dU[0].e[0] = cmk(-h * s, T(0));
    dU[0].e[1] = cmk(-h * cl * c, -h * sl * c);
    dU[0].e[2] = cmk(h * cp * c, h * sp * c);
    dU[0].e[3] = cmk(-h * cpl * s, -h * spl * s);
    dU[1].e[0] = cmk(T(0), T(0));
    dU[1].e[1] = cmk(T(0), T(0));
    dU[1].e[2] = cmk(-sp * s, cp * s);
    dU[1].e[3] = cmk(-spl * c, cpl * c);
    dU[2].e[0] = cmk(T(0), T(0));
    dU[2].e[1] = cmk(sl * s, -cl * s);
    dU[2].e[2] = cmk(T(0), T(0));
    dU[2].e[3] = cmk(-spl * c, cpl * c);
  }
}

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

// t = tr(T^dag U) and dt[p] = d t / d x_p for all 6(K+1) parameters
// (reverse sweep over the layers with W_i = P_i T^dag S_i).
template <typename T, int K>
SLAM_HD C<T> overlap_grad(const T* x, const M4<T>& Tg, const M4<T>* G, C<T>* dt) {
  ChainParts<T, K> cp;
  chain_parts<T, K>(x, G, cp);
  const C<T> t = overlap(Tg, cp.U);
  M4<T> X, W, tmp;  // X_i = T^dag S_i, starting at X_K = T^dag
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) X.e[4 * a + b] = cmk(Tg.e[4 * b + a].re, -Tg.e[4 * b + a].im);
#pragma unroll
  for (int i = K; i >= 0; --i) {
    matmul4(cp.P[i], X, W);
    // CA[a1][b1] = sum W[2b1+b2][2a1+a2] B[a2][b2], CB likewise with A
    M2<T> CA, CB;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        C<T> ca = cmk(T(0), T(0)), cb = cmk(T(0), T(0));
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            // CA: (a1, b1) = (u, v), (a2, b2) = (p, q)
            ca = cadd(ca, cmul(W.e[(2 * v + q) * 4 + 2 * u + p], cp.B[i].e[2 * p + q]));
            // CB: (a2, b2) = (u, v), (a1, b1) = (p, q)
            cb = cadd(cb, cmul(W.e[(2 * q + v) * 4 + 2 * p + u], cp.A[i].e[2 * p + q]));
          }
        CA.e[2 * u + v] = ca;
        CB.e[2 * u + v] = cb;
      }
    M2<T> dA[3], dB[3], Ai, Bi;
    u3(x + 6 * i, Ai, dA);
    u3(x + 6 * i + 3, Bi, dB);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      C<T> sa = cmk(T(0), T(0)), sb = cmk(T(0), T(0));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sa = cadd(sa, cmul(dA[j].e[e], CA.e[e]));
        sb = cadd(sb, cmul(dB[j].e[e], CB.e[e]));
      }
      dt[6 * i + j] = sa;
      dt[6 * i + 3 + j] = sb;
    }
    if (i > 0) {  // X_{i-1} = X_i L_i G_{i-1}
      matmul4(X, cp.L[i], tmp);
      matmul4(tmp, G[i - 1], X);
    }
  }
  return t;
}

// ------------------------------------------------------------ Adam

// adam_iters Adam steps on the square cost 1 - (|t|^2 + 4)/20, in place on
// x; sched holds [1/bias1, 1/bias2, lr] per step (JAX pallas_chain.py:701-745).
template <int K>
SLAM_HD void adam_lane(float* x, const M4<float>& Tg, const M4<float>* G,
                       const float* sched, int iters) {
  constexpr int N = 6 * (K + 1);
  float m[N], v[N];
  C<float> dt[N];
#pragma unroll
  for (int p = 0; p < N; ++p) { m[p] = 0.f; v[p] = 0.f; }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const C<float> t = overlap_grad<float, K>(x, Tg, G, dt);
    const float s0 = sched[3 * it], s1 = sched[3 * it + 1], s2 = sched[3 * it + 2];
#pragma unroll
    for (int p = 0; p < N; ++p) {
      // d/dx (1 - (|t|^2 + 4)/20) = -(2/20) Re(conj(t) dt)
      const float g = -0.1f * (t.re * dt[p].re + t.im * dt[p].im);
      m[p] = 0.9f * m[p] + 0.1f * g;
      v[p] = 0.999f * v[p] + 0.001f * (g * g);
      const float mhat = m[p] * s0;
      const float vhat = v[p] * s1;
      x[p] = x[p] - s2 * mhat / (sqrtf(vhat) + 1e-8f);
    }
  }
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

// ------------------------------------------------------------ lane entries
// One lane of each kernel from the raw arrays: load x0 and the target,
// run, store. The CUDA kernels call these with gates in shared memory; the
// host build (host_lanes.cpp) calls the same functions in a loop over lanes.
// Arrays are row-major; complex values are interleaved (re, im).

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

template <int K>
SLAM_HD void adam_lane_io(const float* __restrict__ x0, const float* __restrict__ tgt,
                          const M4<float>* __restrict__ G, const float* __restrict__ sched,
                          int iters, int lane, float* __restrict__ xout) {
  constexpr int N = 6 * (K + 1);
  float x[N];
#pragma unroll
  for (int p = 0; p < N; ++p) x[p] = x0[(size_t)lane * N + p];
  M4<float> Tg;
  load_target(tgt, lane, Tg);
  adam_lane<K>(x, Tg, G, sched, iters);
#pragma unroll
  for (int p = 0; p < N; ++p) xout[(size_t)lane * N + p] = x[p];
}

template <int K>
SLAM_HD void lm_lane_io(const float* __restrict__ x0, const float* __restrict__ tgt,
                        const M4<float>* __restrict__ G, int iters, int lane,
                        float* __restrict__ xout, float* __restrict__ fout) {
  constexpr int N = 6 * (K + 1);
  float x[N];
#pragma unroll
  for (int p = 0; p < N; ++p) x[p] = x0[(size_t)lane * N + p];
  M4<float> Tg;
  load_target(tgt, lane, Tg);
  fout[lane] = lm_lane<float, K>(x, Tg, Tg, G, G, iters);
#pragma unroll
  for (int p = 0; p < N; ++p) xout[(size_t)lane * N + p] = x[p];
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

constexpr int kBlock = 64;  // threads (lanes) per block

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

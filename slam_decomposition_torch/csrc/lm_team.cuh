// Levenberg-Marquardt on the phase residual for one lane, run by a team of
// 32 threads (one warp) over a per-lane workspace in shared memory. One
// program, templated on the residual type R, serves two kernels: R = float
// is the f32 ranking pass (lm_chain.cu), R = double the polish
// (polish_chain.cu). The kernels and the host build (host_lanes.cpp) run
// this same program; chain_common.cuh says how a team runs its steps.
//
// It computes what the plain version does (JAX gauss_newton.lm_one;
// pallas_chain.py lm_block, polish_block): the phase-aligned residual
// r = vec(U - e^{i phi} T), the trial step x + dx and the accept test in R;
// J = dr/dx at float(x), A = J^T J and b = -J^T float(r), n + 8 CG
// iterations on (A + lam I) dx = b in f32; the trial step accepted iff
// ||r||^2 drops, lam x0.3 / x8 clipped to [1e-14, 1e3]. Sums are taken in
// another order (butterflies, the chain applied column by column), which is
// rounding only. A rejected step leaves x, and so J, A and b, unchanged:
// they are kept and not rebuilt.
//
// Who does what, for n = 6(K+1) parameters:
//   chain:  threads 0-3 each build one column of every prefix product
//           P_i and of U, threads 4-7 one row of every suffix product S_i
//           (no exchange between them: a column of M v needs only that
//           column of v), gate products through the sparse lists;
//   J:      thread p < n builds column p, dU/dx_p = S_i (dL_i/dx_p) P_i
//           with the phase factor's derivative, from P, S in shared memory;
//   normal: thread i < n builds row i of A (kept in its registers) and b_i;
//   CG:     thread i owns x_i, r_i, p_i, (Ap)_i; the mat-vec reads p from
//           shared memory (double-buffered: one barrier per iteration),
//           the two dot products are butterfly sums;
//   residual: thread e builds r_e; ||r||^2 is a butterfly sum in R.
//
// Wide chains (K >= 5: n >= 36 parameters, more than the team's 32
// threads): thread t owns parameters t, t + 32 and, from K = 10 (n >= 66),
// t + 64 (each only where it is below n) in J's columns, b and CG. A is
// not built: two rows of n entries a thread would not fit in registers,
// and A in shared memory would halve the lanes an SM holds. CG multiplies
// by it as (A + lam I) p = J^T (J p) + lam p from J, which stays in shared
// memory: thread e forms (J p)_e from row e of J, then each thread its
// entries of J^T (J p) from its columns. That is A p up to f32 rounding
// (the plain version forms A), at 2 * 32 n multiply-adds a CG iteration
// against n^2.
//
// With R = float the trial residual comes from the f32 chain parts of the
// trial point, which are then those J needs if the step is accepted. With
// R = double the trial residual needs only the chain itself in f64
// (threads 0-3, one column each, no suffix products), and the f32 chain
// parts are built at float(x) on the iterations that rebuild J.

#pragma once

#include <type_traits>

#include "chain_common.cuh"

namespace slam {

constexpr int kLmTeam = 32;
constexpr double kFourPi = 4.0 * 3.14159265358979323846;

// what the workspace holds beside the f32 parts: nothing for the f32 pass,
// the f64 state for the polish. 64-bit values take two banks, so a column
// thread's scratch row is padded to 5 entries (80 bytes): the four rows
// then start 20 banks apart and fall on different banks.
template <typename R, int K> struct LmHi {};
template <int K> struct LmHi<double, K> {
  static constexpr int N = 6 * (K + 1), NT = 2 * (K + 1);
  double xd[N], xnd[N];     // parameters, trial parameters
  C<double> Td[16], Vd[16];  // target, the chain of the last f64 residual
  C<double> yd[4][5];       // per column thread: vector before a gate product
  C<double> trd[4];         // per column thread: its column's part of tr(T^dag V)
  Trig<double> trigd[NT];   // u3 factors of the last f64 residual
};

// Row length of J and p: n rounded up to a multiple of 4 floats (16-byte
// loads). A wide chain's CG has thread e read row e of J 16 bytes at a
// time, 8 threads a shared-memory pass: rows an odd number of 16-byte units
// apart fall on 8 different groups of 4 banks, an even number share them
// (at n = 48, 54, 72, 78 the rows were 2-4 ways in conflict), so from K = 5
// the length is rounded up to an odd number of 16-byte units (K = 5, 6, 9,
// 10 have one already).
template <int K>
constexpr int kLmRowPad = K >= 5 ? ((6 * (K + 1) + 3) / 4 | 1) * 4 : (6 * (K + 1) + 3) / 4 * 4;

// per-lane workspace in shared memory; rows of J and p padded to NP (a
// multiple of 4) and 16-byte aligned for 16-byte loads; matrices row-major
// with one padding entry so that the K+1 matrices fall on different banks.
// With R = double, x is float(xd) (where J is taken) and xn is not used.
template <typename R, int K> struct LmWs : LmHi<R, K> {
  static constexpr int N = 6 * (K + 1), NP = kLmRowPad<K>, NT = 2 * (K + 1), MS = 17;
  alignas(16) float J[32][NP];  // J[e][p] = d r_e / d x_p
  alignas(16) float p[2][NP];   // CG direction, double-buffered
  float x[N], xn[N];          // parameters, trial parameters
  alignas(16) float r[32], rn[32];  // residual of x, of the trial point, as f32 (rn: J p in a wide CG)
  C<float> T[16];             // target
  C<float> P[K + 1][MS];      // prefix products (of the last f32 chain built)
  C<float> S[K + 1][MS];      // suffix products
  C<float> V[16];             // the chain
  C<float> y[8][4];           // per chain thread: vector before a gate product
  Trig<float> trig[NT];       // u3 factors of the last f32 chain built
};

// parameters a thread owns (t, t + 32, ...) for n = 6(K+1) parameters
template <int K> constexpr int kLmSlots = (6 * (K + 1) + kLmTeam - 1) / kLmTeam;

// The chain's layer loops (lm_chain_parts, lm_residual_f64) loop over the
// layers. Unrolled, every chain an iteration builds is inlined with K + 1
// copies of the layer: on an H100 the LM then took 1.06-1.94x the rolled
// time at every depth measured (K = 2, 3, 5..12), and the deep instances
// made the build several times longer (PERF.md). The polish keeps them
// unrolled at K <= 3, where rolled it spills 4-32 B at its 96-register cap.
template <typename R, int K>
constexpr int kLmLayerUnroll = std::is_same_v<R, double> && K <= 3 ? K + 1 : 1;

template <typename R, int K> struct LmThread {
  static constexpr int N = 6 * (K + 1), S = kLmSlots<K>;
  float arow[S == 1 ? N : 1];  // row t of A = J^T J (a wide chain's CG does not build A)
  // CG of parameter t + 32 s: right-hand side, x, r, p, (A + lam I) p
  float b[S], xc[S], rc[S], pc[S], ap[S];
  float rs;               // uniform across the team
  int shift;              // the polish's CG runs on b 2^-shift (uniform)
  R f0, lam;              // uniform across the team
  C<float> z;             // e^{i phi} of the last f32 chain built
  float mag;              // |tr(T^dag U)| of the last f32 chain built
  bool fresh;             // x moved: J, A and b must be rebuilt
  float part[1];          // operand of the CG's sums
  R sq[1];                // operand of the sum ||r||^2
};

// trig of xs, then the chain parts P, S, V; ends with a barrier
template <typename R, int K, class Team>
SLAM_HD void lm_chain_parts(Team& tm, LmWs<R, K>& ws, const float* xs, const GateNz<float>* G) {
  SLAM_EACH(tm, t) {
    if (t < LmWs<R, K>::NT) ws.trig[t] = u3_trig(xs + 3 * t);
  }
  tm.sync();
  SLAM_EACH(tm, t) {
    if (t < 4) {  // column t of P_0..P_K and of V
      C<float> v[4], w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = cmk(q == t ? 1.f : 0.f, 0.f);
#pragma unroll (kLmLayerUnroll<R, K>)
      for (int i = 0; i <= K; ++i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) ws.P[i][4 * q + t] = v[q];
        M2<float> A, B;
        u3_build(ws.trig[2 * i], A, (M2<float>*)nullptr);
        u3_build(ws.trig[2 * i + 1], B, (M2<float>*)nullptr);
        kron_col(A, B, v, w);
        if (i < K) {
#pragma unroll
          for (int q = 0; q < 4; ++q) ws.y[t][q] = w[q];
          gate_col(G[i], ws.y[t], v);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) ws.V[4 * q + t] = w[q];
    } else if (t < 8) {  // row t - 4 of S_K..S_0
      const int j = t - 4;
      C<float> u[4], w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) u[q] = cmk(q == j ? 1.f : 0.f, 0.f);
#pragma unroll (kLmLayerUnroll<R, K>)
      for (int i = K; i >= 0; --i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) ws.S[i][4 * j + q] = u[q];
        if (i > 0) {
          M2<float> A, B;
          u3_build(ws.trig[2 * i], A, (M2<float>*)nullptr);
          u3_build(ws.trig[2 * i + 1], B, (M2<float>*)nullptr);
          kron_row(A, B, u, w);
#pragma unroll
          for (int q = 0; q < 4; ++q) ws.y[t][q] = w[q];
          gate_row(G[i - 1], ws.y[t], u);
        }
      }
    }
  }
  tm.sync();
}

// e^{i phi} = t/|t| and |t| of a trace t = tr(T^dag V)
template <typename F> SLAM_HD void phase_of(C<F> tr, C<F>& z, F& mag) {
  mag = sqrt_(tr.re * tr.re + tr.im * tr.im + Eps<F>::v());
  z = cmk(tr.re / mag, tr.im / mag);
}

// the phase of the f32 chain in ws.V, every thread for itself
template <typename R, int K> SLAM_HD void lm_phase(const LmWs<R, K>& ws, LmThread<R, K>& th) {
  C<float> tr = cjmul(ws.T[0], ws.V[0]);
  for (int e = 1; e < 16; ++e) tr = cadd(tr, cjmul(ws.T[e], ws.V[e]));
  phase_of(tr, th.z, th.mag);
}

// entry t of r = vec(V - z T): real parts, then imaginary parts
template <typename F> SLAM_HD F lm_residual_entry(int t, const C<F>* T, const C<F>* V, C<F> z) {
  const int e = t & 15;
  const C<F> zt = cmul(z, T[e]);
  return t < 16 ? V[e].re - zt.re : V[e].im - zt.im;
}

// every thread: the phase of the f32 chain, then residual entry t into out
// and its square into sq[0], summed over the team
template <int K, class Team> SLAM_HD void lm_residual(Team& tm, LmWs<float, K>& ws, float* out) {
  SLAM_EACH(tm, t) {
    LmThread<float, K>& th = tm.th(t);
    lm_phase(ws, th);
    const float v = lm_residual_entry(t, ws.T, ws.V, th.z);
    out[t] = v;
    th.sq[0] = v * v;
  }
  tm.sum(&LmThread<float, K>::sq);
}

// The polish's residual at xs, in f64: its sines and cosines (one pair a
// thread), then threads 0-3 one column of the chain each with its part of
// tr(T^dag V), then every thread the phase and entry t, whose f32 cast goes
// into out (r enters b only) and whose f64 square into sq[0], summed over
// the team.
template <int K, class Team>
SLAM_HD void lm_residual_f64(Team& tm, LmWs<double, K>& ws, const double* xs, const GateNz<double>* G,
                             float* out) {
  SLAM_EACH(tm, t) {
    constexpr int kPairs = 4 * LmWs<double, K>::NT;
    if constexpr (kPairs <= kLmTeam) {
      if (t < kPairs) u3_trig_pair(xs + 3 * (t / 4), t % 4, ws.trigd[t / 4]);
    } else {  // K >= 4: more pairs than threads
      for (int s = t; s < kPairs; s += kLmTeam) u3_trig_pair(xs + 3 * (s / 4), s % 4, ws.trigd[s / 4]);
    }
  }
  tm.sync();
  SLAM_EACH(tm, t) {
    if (t < 4) {
      C<double> v[4], w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = cmk(q == t ? 1.0 : 0.0, 0.0);
#pragma unroll (kLmLayerUnroll<double, K>)
      for (int i = 0; i <= K; ++i) {
        M2<double> A, B;
        u3_build(ws.trigd[2 * i], A, (M2<double>*)nullptr);
        u3_build(ws.trigd[2 * i + 1], B, (M2<double>*)nullptr);
        kron_col(A, B, v, w);
        if (i < K) {
#pragma unroll
          for (int q = 0; q < 4; ++q) ws.yd[t][q] = w[q];
          gate_col(G[i], ws.yd[t], v);
        }
      }
      C<double> tr = cjmul(ws.Td[t], w[0]);
#pragma unroll
      for (int q = 1; q < 4; ++q) tr = cadd(tr, cjmul(ws.Td[4 * q + t], w[q]));
      ws.trd[t] = tr;
#pragma unroll
      for (int q = 0; q < 4; ++q) ws.Vd[4 * q + t] = w[q];
    }
  }
  tm.sync();
  SLAM_EACH(tm, t) {
    C<double> z;
    double mag;
    phase_of(cadd(cadd(ws.trd[0], ws.trd[1]), cadd(ws.trd[2], ws.trd[3])), z, mag);
    const double v = lm_residual_entry(t, ws.Td, ws.Vd, z);
    out[t] = (float)v;
    tm.th(t).sq[0] = v * v;
  }
  tm.sum(&LmThread<double, K>::sq);
}

// column t of J at the last f32 chain built (thread t < n): D = dU/dx_t is
// written into the column first, then the phase factor's term is taken off
template <typename R, int K>
SLAM_HD void lm_jacobian_column(int t, LmWs<R, K>& ws, const LmThread<R, K>& th) {
  const int i = t / 6, j = t % 6;
  M2<float> first, second;  // dL_i/dx_t = first (x) second
  if (j < 3) {
    u3_deriv(ws.trig[2 * i], j, first);
    u3_build(ws.trig[2 * i + 1], second, (M2<float>*)nullptr);
  } else {
    u3_build(ws.trig[2 * i], first, (M2<float>*)nullptr);
    u3_deriv(ws.trig[2 * i + 1], j - 3, second);
  }
  C<float> dt = cmk(0.f, 0.f);  // tr(T^dag D), summed column by column
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    C<float> v[4], w[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) v[a] = ws.P[i][4 * a + q];
    kron_col(first, second, v, w);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      C<float> acc = cmul(ws.S[i][4 * a], w[0]);
#pragma unroll
      for (int m = 1; m < 4; ++m) acc = cadd(acc, cmul(ws.S[i][4 * a + m], w[m]));
      ws.J[4 * a + q][t] = acc.re;
      ws.J[16 + 4 * a + q][t] = acc.im;
      dt = cadd(dt, cjmul(ws.T[4 * a + q], acc));
    }
  }
  // d(t/|t|) = i z Im(conj(z) dt) / |t|
  const float w = (th.z.re * dt.im - th.z.im * dt.re) / th.mag;
  const C<float> dz = cmk(-th.z.im * w, th.z.re * w);
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const C<float> dzt = cmul(dz, ws.T[e]);
    ws.J[e][t] -= dzt.re;
    ws.J[16 + e][t] -= dzt.im;
  }
}

// acc[j] += a * row[j] for j < N, row read 4 floats at a time
template <int N> SLAM_HD void axpy_row(float a, const float* row, float* acc) {
#pragma unroll
  for (int j4 = 0; j4 < (N + 3) / 4; ++j4) {
    const F4 q = f4(row + 4 * j4);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (4 * j4 + u < N) acc[4 * j4 + u] += a * q.v[u];
  }
}

// iters LM iterations on the lane's parameters (ws.x for the f32 pass,
// ws.xd for the polish; loaded, with the target, before the call); G are the
// f32 gate lists, GR those of the residual's type (the polish's f64 chain).
// Ends with the final accepted ||r||^2 in every thread's f0; returns the
// number of iterations that built J, A and b (the first, and each after an
// accepted step).
template <typename R, int K, class Team>
SLAM_HD int lm_team(Team& tm, LmWs<R, K>& ws, const GateNz<float>* G, const GateNz<R>* GR, int iters) {
  constexpr int N = 6 * (K + 1), S = kLmSlots<K>;
  constexpr bool kF64 = std::is_same_v<R, double>;
  if constexpr (kF64) {
    lm_residual_f64<K>(tm, ws, ws.xd, GR, ws.r);
  } else {
    lm_chain_parts<R, K>(tm, ws, ws.x, G);
    lm_residual<K>(tm, ws, ws.r);
  }
  SLAM_EACH(tm, t) {
    LmThread<R, K>& th = tm.th(t);
    th.f0 = th.sq[0];
    th.lam = R(1e-3);
    th.fresh = true;
  }
  tm.sync();
  int rebuilds = 0;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    if (tm.any().fresh) {  // uniform
      ++rebuilds;
      if constexpr (kF64) {  // the f32 chain parts at float(x), and their phase
        SLAM_EACH(tm, t) {
#pragma unroll
          for (int s = 0; s < S; ++s)
            if (t + kLmTeam * s < N) ws.x[t + kLmTeam * s] = (float)ws.xd[t + kLmTeam * s];
        }
        tm.sync();
        lm_chain_parts<R, K>(tm, ws, ws.x, G);
        SLAM_EACH(tm, t) lm_phase(ws, tm.th(t));
      }  // else the chain parts in ws are those of x already
      SLAM_EACH(tm, t) {
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (t + kLmTeam * s < N) lm_jacobian_column<R, K>(t + kLmTeam * s, ws, tm.th(t));
      }
      tm.sync();
      SLAM_EACH(tm, t) {
        LmThread<R, K>& th = tm.th(t);
        if constexpr (S == 1) {  // row t of A and b_t
          float b = 0.f;
#pragma unroll
          for (int j = 0; j < N; ++j) th.arow[j] = 0.f;
          if (t < N) {
#pragma unroll 2
            for (int e = 0; e < 32; ++e) {
              const float a = ws.J[e][t];
              axpy_row<N>(a, ws.J[e], th.arow);
              b += a * ws.r[e];
            }
          }
          th.b[0] = -b;
        } else {  // b alone
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const int p = t + kLmTeam * s;
            float b = 0.f;
            if (p < N) {
              for (int e = 0; e < 32; ++e) b += ws.J[e][p] * ws.r[e];
            }
            th.b[s] = -b;
          }
        }
      }
    }
    SLAM_EACH(tm, t) {
      LmThread<R, K>& th = tm.th(t);
      th.part[0] = th.b[0] * th.b[0];
#pragma unroll
      for (int s = 1; s < S; ++s) th.part[0] += th.b[s] * th.b[s];
    }
    tm.sum(&LmThread<R, K>::part);
    SLAM_EACH(tm, t) {  // CG from 0; parameters p >= N carry zeros
      LmThread<R, K>& th = tm.th(t);
      th.rs = th.part[0];
      if constexpr (kF64) {
        // Near convergence b^T b falls to 1e-26 and below, and CG takes it
        // down by another 1e-14: f32 then leaves its normal range, where a
        // division takes the slow path (and loses bits). CG is linear in b
        // and exact under a power of two, so it runs on b 2^-s with
        // b^T b 2^-2s in [1/2, 4), and dx is scaled back in f64.
        th.shift = th.rs > 0.f && th.rs <= kF32Max ? ilogbf(th.rs) / 2 : 0;
        th.rs = ldexpf(th.rs, -2 * th.shift);
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float b = th.b[s];  // th.b stays unscaled: a rejected step reuses it
        if constexpr (kF64) b = ldexpf(b, -th.shift);
        th.xc[s] = 0.f;
        th.rc[s] = b;
        th.pc[s] = b;
        if (t + kLmTeam * s < N) ws.p[0][t + kLmTeam * s] = b;
      }
    }
    tm.sync();
#pragma unroll 1
    for (int c = 0; c < N + kCgExtra; ++c) {
      const float* p = ws.p[c & 1];
      if constexpr (S > 1) {  // (J p)_t into rn: the trial residual's slot is free during CG
        SLAM_EACH(tm, t) {
          float acc = 0.f;
#pragma unroll
          for (int j4 = 0; j4 < (N + 3) / 4; ++j4) {
            const F4 a = f4(ws.J[t] + 4 * j4), q = f4(p + 4 * j4);
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (4 * j4 + u < N) acc += a.v[u] * q.v[u];
          }
          ws.rn[t] = acc;
        }
        tm.sync();
      }
      SLAM_EACH(tm, t) {
        LmThread<R, K>& th = tm.th(t);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          float acc = (float)th.lam * th.pc[s];
          if constexpr (S == 1) {  // row t of A times p
#pragma unroll
            for (int j4 = 0; j4 < (N + 3) / 4; ++j4) {
              const F4 q = f4(p + 4 * j4);
#pragma unroll
              for (int u = 0; u < 4; ++u)
                if (4 * j4 + u < N) acc += th.arow[4 * j4 + u] * q.v[u];
            }
          } else {  // column t + 32 s of J times J p
            const int col = t + kLmTeam * s < N ? t + kLmTeam * s : 0;
#pragma unroll
            for (int e4 = 0; e4 < 8; ++e4) {
              const F4 q = f4(ws.rn + 4 * e4);
#pragma unroll
              for (int u = 0; u < 4; ++u) acc += ws.J[4 * e4 + u][col] * q.v[u];
            }
          }
          th.ap[s] = t + kLmTeam * s < N ? acc : 0.f;
          th.part[0] = s == 0 ? th.pc[s] * th.ap[s] : th.part[0] + th.pc[s] * th.ap[s];
        }
      }
      tm.sum(&LmThread<R, K>::part);
      SLAM_EACH(tm, t) {
        LmThread<R, K>& th = tm.th(t);
        // guards keep NaN (as torch.clamp_min does) but lift 0 and underflow
        const float pAp = th.part[0];
        const float alpha = th.rs / (pAp < kF32Tiny ? kF32Tiny : pAp);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          th.xc[s] += alpha * th.pc[s];
          th.rc[s] -= alpha * th.ap[s];
          th.part[0] = s == 0 ? th.rc[s] * th.rc[s] : th.part[0] + th.rc[s] * th.rc[s];
        }
      }
      tm.sum(&LmThread<R, K>::part);
      SLAM_EACH(tm, t) {
        LmThread<R, K>& th = tm.th(t);
        const float rs_new = th.part[0];
        const float beta = rs_new / (th.rs < kF32Tiny ? kF32Tiny : th.rs);
        th.rs = rs_new;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          th.pc[s] = th.rc[s] + beta * th.pc[s];
          if (t + kLmTeam * s < N) ws.p[(c + 1) & 1][t + kLmTeam * s] = th.pc[s];
        }
      }
      tm.sync();
    }
    if constexpr (kF64) {
      SLAM_EACH(tm, t) {
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (t + kLmTeam * s < N)
            ws.xnd[t + kLmTeam * s] = ws.xd[t + kLmTeam * s] + ldexp((double)tm.th(t).xc[s], tm.th(t).shift);
      }
      tm.sync();
      lm_residual_f64<K>(tm, ws, ws.xnd, GR, ws.rn);
    } else {
      SLAM_EACH(tm, t) {
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (t + kLmTeam * s < N) ws.xn[t + kLmTeam * s] = ws.x[t + kLmTeam * s] + tm.th(t).xc[s];
      }
      tm.sync();
      lm_chain_parts<R, K>(tm, ws, ws.xn, G);
      lm_residual<K>(tm, ws, ws.rn);
    }
    SLAM_EACH(tm, t) {
      LmThread<R, K>& th = tm.th(t);
      const R fn = th.sq[0];
      th.fresh = fn < th.f0;  // a NaN trial step is "not improved"
      if (th.fresh) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int p = t + kLmTeam * s;
          if constexpr (kF64) {
            if (p < N) ws.xd[p] = ws.xnd[p];
          } else {
            if (p < N) ws.x[p] = ws.xn[p];
          }
        }
        ws.r[t] = ws.rn[t];
        th.f0 = fn;
        th.lam = th.lam * R(0.3);
      } else {
        th.lam = th.lam * R(8.0);
      }
      th.lam = th.lam < R(1e-14) ? R(1e-14) : (th.lam > R(1e3) ? R(1e3) : th.lam);
    }
    tm.sync();
  }
  return rebuilds;
}

// One lane from the raw arrays: load x0 and the target, run, store (the
// store only where `store`: a team past the last lane repeats lane L-1).
// The polish first reduces its angles mod 4 pi (u3 is 4 pi-periodic in
// every angle) and keeps the f32 cast of the target for J. The host build
// reuses one workspace for lane after lane. Where `rebuilds` is given, the
// lane's leader adds the lane's count of J builds to it at the end.
template <typename R, int K, class Team>
SLAM_HD void lm_team_io(Team& tm, LmWs<R, K>& ws, const GateNz<float>* G, const GateNz<R>* GR,
                        const R* __restrict__ x0, const R* __restrict__ tgt, int iters, int lane,
                        bool store, R* __restrict__ xout, R* __restrict__ fout,
                        unsigned long long* rebuilds) {
  constexpr int N = 6 * (K + 1), S = kLmSlots<K>;
  constexpr bool kF64 = std::is_same_v<R, double>;
  SLAM_EACH(tm, t) {
    const R* tg = tgt + 32 * (size_t)lane;
    if constexpr (kF64) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int p = t + kLmTeam * s;
        if (p < N) {
          const double v = x0[(size_t)lane * N + p];
          ws.xd[p] = v - kFourPi * rint(v / kFourPi);
        }
      }
      if (t < 16) {
        ws.Td[t] = cmk(tg[2 * t], tg[2 * t + 1]);
        ws.T[t] = cmk((float)tg[2 * t], (float)tg[2 * t + 1]);
      }
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (t + kLmTeam * s < N) ws.x[t + kLmTeam * s] = x0[(size_t)lane * N + t + kLmTeam * s];
      if (t < 16) ws.T[t] = cmk(tg[2 * t], tg[2 * t + 1]);
    }
  }
  tm.sync();
  const int built = lm_team<R, K>(tm, ws, G, GR, iters);
  SLAM_EACH(tm, t) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int p = t + kLmTeam * s;
      if (store && p < N) {
        if constexpr (kF64) xout[(size_t)lane * N + p] = ws.xd[p];
        else xout[(size_t)lane * N + p] = ws.x[p];
      }
    }
    if (store && t == 0) {
      fout[lane] = tm.th(t).f0;
      if (rebuilds != nullptr) count_add(rebuilds, built);
    }
  }
}

}  // namespace slam

// The f32 Levenberg-Marquardt ranking pass for one lane, run by a team of
// 32 threads (one warp) over a per-lane workspace in shared memory. The
// kernel (lm_chain.cu) and the host build (host_lanes.cpp) run this same
// program; chain_common.cuh says how a team runs its steps.
//
// It computes what chain_common.cuh's one-thread lm_lane<float, K> does:
// the phase-aligned residual r = vec(U - e^{i phi} T), J = dr/dx in f32,
// A = J^T J and b = -J^T r, n + 8 CG iterations on (A + lam I) dx = b, the
// trial step accepted iff ||r||^2 drops, lam x0.3 / x8 clipped to
// [1e-14, 1e3]. Sums are taken in another order (butterflies, the chain
// applied column by column), which is f32 rounding only. A rejected step
// leaves x, and so J, A and b, unchanged: they are kept and not rebuilt.
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
//   residual: thread e builds r_e; ||r||^2 is a butterfly sum.

#pragma once

#include "chain_common.cuh"

namespace slam {

constexpr int kLmTeam = 32;

// per-lane workspace in shared memory; rows of J and p padded to NP (a
// multiple of 4) and 16-byte aligned for 16-byte loads; matrices row-major
// with one padding entry so that the K+1 matrices fall on different banks
template <int K> struct LmWs {
  static constexpr int N = 6 * (K + 1), NP = (N + 3) / 4 * 4, NT = 2 * (K + 1), MS = 17;
  alignas(16) float J[32][NP];  // J[e][p] = d r_e / d x_p
  alignas(16) float p[2][NP];   // CG direction, double-buffered
  float x[N], xn[N];          // parameters, trial parameters
  float r[32], rn[32];        // residual of x, of xn
  C<float> T[16];             // target
  C<float> P[K + 1][MS];      // prefix products (of the last chain built)
  C<float> S[K + 1][MS];      // suffix products
  C<float> V[16];             // the chain
  C<float> y[8][4];           // per chain thread: vector before a gate product
  Trig<float> trig[NT];       // u3 factors of the last chain built
};

template <int K> struct LmThread {
  static constexpr int N = 6 * (K + 1);
  float arow[N];          // row t of A = J^T J
  float b, xc, rc, pc, ap;  // CG: right-hand side, x, r, p, (A + lam I) p of this row
  float rs, f0, lam;      // uniform across the team
  C<float> z;             // e^{i phi} of the last chain built
  float mag;              // |tr(T^dag U)| of the last chain built
  bool fresh;             // x moved: J, A and b must be rebuilt
  float part[1];          // operand of the team's sums
};

// trig of xs, then the chain parts P, S, V; ends with a barrier
template <int K, class Team>
SLAM_HD void lm_chain_parts(Team& tm, LmWs<K>& ws, const float* xs, const GateNz<float>* G) {
  SLAM_EACH(tm, t) {
    if (t < LmWs<K>::NT) ws.trig[t] = u3_trig(xs + 3 * t);
  }
  tm.sync();
  SLAM_EACH(tm, t) {
    if (t < 4) {  // column t of P_0..P_K and of V
      C<float> v[4], w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = cmk(q == t ? 1.f : 0.f, 0.f);
#pragma unroll
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
#pragma unroll
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

// every thread: the phase of the chain, then residual entry t into out and
// its square into part[0]
template <int K, class Team> SLAM_HD void lm_residual(Team& tm, LmWs<K>& ws, float* out) {
  SLAM_EACH(tm, t) {
    LmThread<K>& th = tm.th(t);
    C<float> tr = cjmul(ws.T[0], ws.V[0]);
    for (int e = 1; e < 16; ++e) tr = cadd(tr, cjmul(ws.T[e], ws.V[e]));
    th.mag = sqrtf(tr.re * tr.re + tr.im * tr.im + Eps<float>::v());
    th.z = cmk(tr.re / th.mag, tr.im / th.mag);
    const int e = t & 15;
    const C<float> zt = cmul(th.z, ws.T[e]);
    const float v = t < 16 ? ws.V[e].re - zt.re : ws.V[e].im - zt.im;
    out[t] = v;
    th.part[0] = v * v;
  }
  tm.sum(&LmThread<K>::part);
}

// column t of J at the last chain built (thread t < n): D = dU/dx_t is
// written into the column first, then the phase factor's term is taken off
template <int K> SLAM_HD void lm_jacobian_column(int t, LmWs<K>& ws, const LmThread<K>& th) {
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

// iters LM iterations on ws.x (loaded, with ws.T, before the call); ends
// with the final accepted ||r||^2 in every thread's f0
template <int K, class Team>
SLAM_HD void lm_team(Team& tm, LmWs<K>& ws, const GateNz<float>* G, int iters) {
  constexpr int N = 6 * (K + 1);
  lm_chain_parts<K>(tm, ws, ws.x, G);
  lm_residual<K>(tm, ws, ws.r);
  SLAM_EACH(tm, t) {
    LmThread<K>& th = tm.th(t);
    th.f0 = th.part[0];
    th.lam = 1e-3f;
    th.fresh = true;
  }
  tm.sync();
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    if (tm.any().fresh) {  // uniform; the chain parts in ws are those of x
      SLAM_EACH(tm, t) {
        if (t < N) lm_jacobian_column<K>(t, ws, tm.th(t));
      }
      tm.sync();
      SLAM_EACH(tm, t) {
        LmThread<K>& th = tm.th(t);
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
        th.b = -b;
      }
    }
    SLAM_EACH(tm, t) {  // CG from 0; threads t >= N carry zeros
      LmThread<K>& th = tm.th(t);
      th.xc = 0.f;
      th.rc = th.b;
      th.pc = th.b;
      if (t < N) ws.p[0][t] = th.b;
      th.part[0] = th.b * th.b;
    }
    tm.sum(&LmThread<K>::part);
    SLAM_EACH(tm, t) tm.th(t).rs = tm.th(t).part[0];
    tm.sync();
#pragma unroll 1
    for (int c = 0; c < N + kCgExtra; ++c) {
      SLAM_EACH(tm, t) {
        LmThread<K>& th = tm.th(t);
        const float* p = ws.p[c & 1];
        float acc = th.lam * th.pc;
#pragma unroll
        for (int j4 = 0; j4 < (N + 3) / 4; ++j4) {
          const F4 q = f4(p + 4 * j4);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (4 * j4 + u < N) acc += th.arow[4 * j4 + u] * q.v[u];
        }
        th.ap = t < N ? acc : 0.f;
        th.part[0] = th.pc * th.ap;
      }
      tm.sum(&LmThread<K>::part);
      SLAM_EACH(tm, t) {
        LmThread<K>& th = tm.th(t);
        // guards keep NaN (as torch.clamp_min does) but lift 0 and underflow
        const float pAp = th.part[0];
        const float alpha = th.rs / (pAp < kF32Tiny ? kF32Tiny : pAp);
        th.xc += alpha * th.pc;
        th.rc -= alpha * th.ap;
        th.part[0] = th.rc * th.rc;
      }
      tm.sum(&LmThread<K>::part);
      SLAM_EACH(tm, t) {
        LmThread<K>& th = tm.th(t);
        const float rs_new = th.part[0];
        const float beta = rs_new / (th.rs < kF32Tiny ? kF32Tiny : th.rs);
        th.pc = th.rc + beta * th.pc;
        th.rs = rs_new;
        if (t < N) ws.p[(c + 1) & 1][t] = th.pc;
      }
      tm.sync();
    }
    SLAM_EACH(tm, t) {
      if (t < N) ws.xn[t] = ws.x[t] + tm.th(t).xc;
    }
    tm.sync();
    lm_chain_parts<K>(tm, ws, ws.xn, G);
    lm_residual<K>(tm, ws, ws.rn);
    SLAM_EACH(tm, t) {
      LmThread<K>& th = tm.th(t);
      const float fn = th.part[0];
      th.fresh = fn < th.f0;  // a NaN trial step is "not improved"
      if (th.fresh) {
        if (t < N) ws.x[t] = ws.xn[t];
        ws.r[t] = ws.rn[t];
        th.f0 = fn;
        th.lam = th.lam * 0.3f;
      } else {
        th.lam = th.lam * 8.0f;
      }
      th.lam = th.lam < 1e-14f ? 1e-14f : (th.lam > 1e3f ? 1e3f : th.lam);
    }
    tm.sync();
  }
}

// One lane from the raw arrays: load x0 and the target, run, store (the
// store only where `store`: a team past the last lane repeats lane L-1).
// The host build reuses one workspace for lane after lane.
template <int K, class Team>
SLAM_HD void lm_team_io(Team& tm, LmWs<K>& ws, const GateNz<float>* G, const float* __restrict__ x0,
                        const float* __restrict__ tgt, int iters, int lane, bool store,
                        float* __restrict__ xout, float* __restrict__ fout) {
  constexpr int N = 6 * (K + 1);
  SLAM_EACH(tm, t) {
    if (t < N) ws.x[t] = x0[(size_t)lane * N + t];
    if (t < 16) ws.T[t] = cmk(tgt[32 * (size_t)lane + 2 * t], tgt[32 * (size_t)lane + 2 * t + 1]);
  }
  tm.sync();
  lm_team<K>(tm, ws, G, iters);
  SLAM_EACH(tm, t) {
    if (store && t < N) xout[(size_t)lane * N + t] = ws.x[t];
    if (store && t == 0) fout[lane] = tm.th(t).f0;
  }
}

}  // namespace slam

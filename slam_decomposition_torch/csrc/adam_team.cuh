// The fused Adam warm start for one lane, run by a team of 4 threads over a
// per-lane workspace in shared memory. The kernel (adam_chain.cu) and the
// host build (host_lanes.cpp) run this same program; chain_common.cuh says
// how a team runs its steps.
//
// Each step: the gradient of the square cost 1 - (|t|^2 + 4)/20,
// t = tr(T^dag U(x)), then Adam with the step's [1/bias1, 1/bias2, lr] row.
// With P_i the prefix products (P_0 = I, P_{i+1} = G_i L_i P_i), X_i = T^dag
// S_i the suffix products seen from the target (X_K = T^dag, X_{i-1} = X_i
// L_i G_{i-1}) and W_i = P_i X_i, dt/dx_p = sum_ab W_i[b][a] dL_i[a][b]
// for the parameters p of layer i.
//
// Thread c of the team owns column c of every P_i (kept in shared memory,
// which leaves the registers to the reverse sweep) and row c of every X_i:
// W_i = sum_c P_i[:, c] X_i[c, :] is a sum of the threads' rank-1 terms,
// and a column of G v (a row of u^T G) needs only that column (row), so
// the chain and the reverse sweep run without exchange. The rank-1 terms
// enter the gradient linearly, so each thread contracts its own term with
// the layer's u3 derivatives and the team sums the layer's 6 gradient
// entries (and once the trace t) by butterflies. Thread c owns the
// gradient and Adam state m, v of parameters c, c + 4, ... and updates
// them in shared memory at the end of the step, all threads at once.

#pragma once

#include "chain_common.cuh"

namespace slam {

constexpr int kAdamTeam = 4;

template <int K> struct AdamWs {
  static constexpr int N = 6 * (K + 1), NT = 2 * (K + 1);
  float x[N];              // parameters
  C<float> T[16];          // target
  Trig<float> trig[NT];    // u3 factors of x
  C<float> y[kAdamTeam][4];  // per thread: vector before a gate product
  C<float> P[K + 1][4][kAdamTeam];  // P[i][q][c]: column c of P_i, written and read by thread c only
};

template <int K> struct AdamThread {
  static constexpr int N = 6 * (K + 1), NO = (N + kAdamTeam - 1) / kAdamTeam;
  float g[NO], m[NO], v[NO];  // gradient and Adam state of parameters c, c + 4, ...
  C<float> X[4];          // row c of X_i
  C<float> t;             // tr(T^dag U)
  float part[6];          // operands of the team's sums
};

// The forward chain at ws.x: its sines and cosines, then thread t column t
// of P_0..P_K and of U and its share of the trace; leaves t = tr(T^dag U)
// in every thread's th.t
template <int K, class Team>
SLAM_HD void adam_forward(Team& tm, AdamWs<K>& ws, const GateNz<float>* G) {
  constexpr int NT = 2 * (K + 1);
  SLAM_EACH(tm, t) {
    for (int s = t; s < NT; s += kAdamTeam) ws.trig[s] = u3_trig(ws.x + 3 * s);
  }
  tm.sync();
  SLAM_EACH(tm, t) {
    AdamThread<K>& th = tm.th(t);
    C<float> v[4], w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = cmk(q == t ? 1.f : 0.f, 0.f);
#pragma unroll
    for (int i = 0; i <= K; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) ws.P[i][q][t] = v[q];
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
    C<float> tr = cjmul(ws.T[t], w[0]);
#pragma unroll
    for (int q = 1; q < 4; ++q) tr = cadd(tr, cjmul(ws.T[4 * q + t], w[q]));
    th.part[0] = tr.re;
    th.part[1] = tr.im;
  }
  tm.sum(&AdamThread<K>::part);
  SLAM_EACH(tm, t) {
    AdamThread<K>& th = tm.th(t);
    th.t = cmk(th.part[0], th.part[1]);
  }
}

// iters Adam steps on the lane whose x0 and target are in ws; the result
// is left in ws.x
template <int K, class Team>
SLAM_HD void adam_team(Team& tm, AdamWs<K>& ws, const GateNz<float>* G, const float* __restrict__ sched,
                       int iters) {
  constexpr int N = 6 * (K + 1), NO = AdamThread<K>::NO;
  SLAM_EACH(tm, t) {
    AdamThread<K>& th = tm.th(t);
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      th.m[o] = 0.f;
      th.v[o] = 0.f;
    }
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    adam_forward<K>(tm, ws, G);
    SLAM_EACH(tm, t) {  // X_K = T^dag: row t is conj(T[:, t])
      AdamThread<K>& th = tm.th(t);
#pragma unroll
      for (int a = 0; a < 4; ++a) th.X[a] = cmk(ws.T[4 * a + t].re, -ws.T[4 * a + t].im);
    }
#pragma unroll
    for (int i = K; i >= 0; --i) {
      SLAM_EACH(tm, t) {
        AdamThread<K>& th = tm.th(t);
        C<float> Pc[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) Pc[q] = ws.P[i][q][t];
        M2<float> A, B;
        u3_build(ws.trig[2 * i], A, (M2<float>*)nullptr);
        u3_build(ws.trig[2 * i + 1], B, (M2<float>*)nullptr);
        // this thread's W = Pc X^T: CA[u][v] = sum_pq W[2v+q][2u+p] B[p][q],
        // CB[u][v] = sum_pq W[2q+v][2p+u] A[p][q]
        M2<float> CA, CB;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          C<float> YA[2], YB[2];  // sum_p X[2u+p] B[p][q], sum_p X[2p+u] A[p][q]
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            YA[q] = cadd(cmul(th.X[2 * u], B.e[q]), cmul(th.X[2 * u + 1], B.e[2 + q]));
            YB[q] = cadd(cmul(th.X[u], A.e[q]), cmul(th.X[2 + u], A.e[2 + q]));
          }
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            CA.e[2 * u + v] = cadd(cmul(Pc[2 * v], YA[0]), cmul(Pc[2 * v + 1], YA[1]));
            CB.e[2 * u + v] = cadd(cmul(Pc[v], YB[0]), cmul(Pc[2 + v], YB[1]));
          }
        }
        if (i > 0) {  // X_{i-1} = X_i L_i G_{i-1}
          C<float> w[4];
          kron_row(A, B, th.X, w);
#pragma unroll
          for (int q = 0; q < 4; ++q) ws.y[t][q] = w[q];
          gate_row(G[i - 1], ws.y[t], th.X);
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          M2<float> dA, dB;
          u3_deriv(ws.trig[2 * i], j, dA);
          u3_deriv(ws.trig[2 * i + 1], j, dB);
          C<float> sa = cmul(dA.e[0], CA.e[0]), sb = cmul(dB.e[0], CB.e[0]);
#pragma unroll
          for (int e = 1; e < 4; ++e) {
            sa = cadd(sa, cmul(dA.e[e], CA.e[e]));
            sb = cadd(sb, cmul(dB.e[e], CB.e[e]));
          }
          // d/dx (1 - (|t|^2 + 4)/20) = -(2/20) Re(conj(t) dt)
          th.part[j] = -0.1f * (th.t.re * sa.re + th.t.im * sa.im);
          th.part[3 + j] = -0.1f * (th.t.re * sb.re + th.t.im * sb.im);
        }
      }
      tm.sum(&AdamThread<K>::part);
      SLAM_EACH(tm, t) {  // keep the gradient entries this thread owns
        AdamThread<K>& th = tm.th(t);
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const int p = 6 * i + j;
          if (p % kAdamTeam == t) th.g[p / kAdamTeam] = th.part[j];
        }
      }
    }
    SLAM_EACH(tm, t) {
      AdamThread<K>& th = tm.th(t);
      const float s0 = sched[3 * it], s1 = sched[3 * it + 1], s2 = sched[3 * it + 2];
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        const int p = t + kAdamTeam * o;
        if (p < N) {
          const float g = th.g[o];
          th.m[o] = 0.9f * th.m[o] + 0.1f * g;
          th.v[o] = 0.999f * th.v[o] + 0.001f * (g * g);
          const float mhat = th.m[o] * s0;
          const float vhat = th.v[o] * s1;
          ws.x[p] = ws.x[p] - s2 * mhat / (sqrtf(vhat) + 1e-8f);
        }
      }
    }
    tm.sync();
  }
}

// One lane from the raw arrays: load x0 and the target, run, store (the
// store only where `store`: a team past the last lane repeats lane L-1).
// With Cost, one more forward chain at the final x gives the lane's square
// cost 1 - (|t|^2 + 4)/20 for fout. The host build reuses one workspace
// for lane after lane.
template <int K, bool Cost, class Team>
SLAM_HD void adam_team_io(Team& tm, AdamWs<K>& ws, const GateNz<float>* G, const float* __restrict__ x0,
                          const float* __restrict__ tgt, const float* __restrict__ sched, int iters,
                          int lane, bool store, float* __restrict__ xout, float* __restrict__ fout) {
  constexpr int N = 6 * (K + 1);
  SLAM_EACH(tm, t) {
    for (int p = t; p < N; p += kAdamTeam) ws.x[p] = x0[(size_t)lane * N + p];
    for (int e = t; e < 16; e += kAdamTeam)
      ws.T[e] = cmk(tgt[32 * (size_t)lane + 2 * e], tgt[32 * (size_t)lane + 2 * e + 1]);
  }
  tm.sync();
  adam_team<K>(tm, ws, G, sched, iters);
  SLAM_EACH(tm, t) {
    for (int p = t; p < N; p += kAdamTeam) {
      if (store) xout[(size_t)lane * N + p] = ws.x[p];
    }
  }
  if constexpr (Cost) {
    adam_forward<K>(tm, ws, G);
    SLAM_EACH(tm, t) {
      const C<float> tr = tm.th(t).t;
      if (store && t == 0) fout[lane] = 1.f - (tr.re * tr.re + tr.im * tr.im + 4.f) / 20.f;
    }
  }
}

}  // namespace slam

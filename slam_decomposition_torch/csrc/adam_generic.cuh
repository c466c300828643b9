// The fused Adam warm start for one lane of a chain of any depth K (a
// runtime argument), run by a team of 4 threads over a per-lane workspace in
// shared memory laid out for K at launch. It is adam_team.cuh's program
// (the same math, the same team and the same order of every sum: prefix
// columns, suffix rows, butterfly sums), with two changes that make K a
// runtime value: the layer loops are rolled, and the gradient and Adam
// state g, m, v, which adam_team.cuh keeps in registers sized by K, sit in
// the lane's workspace, entry p written and read by thread p % 4 only. The
// kernel (adam_chain_generic.cu) and the host build (host_lanes.cpp) run
// this same program.

#pragma once

#include "adam_team.cuh"

namespace slam {

// The lane workspace for depth K, laid out from base (16-byte aligned; every
// array starts on 16 bytes).
struct AdamGenWs {
  int K, N;
  C<float>* T;        // target (16)
  C<float>* y;        // y[4 t + q]: thread t's vector before a gate product
  C<float>* P;        // P[(4 i + q) 4 + c]: column c of P_i, written and read by thread c only
  Trig<float>* trig;  // u3 factors of x (2(K+1))
  float* x;           // parameters (N)
  float *g, *m, *v;   // gradient and Adam state; entry p belongs to thread p % 4
  size_t bytes;

  SLAM_HD AdamGenWs(unsigned char* base, int K_) : K(K_), N(6 * (K_ + 1)) {
    Carve c{base, 0};
    T = c.take<C<float>>(16);
    y = c.take<C<float>>(4 * 4);
    P = c.take<C<float>>(16 * (K + 1));
    trig = c.take<Trig<float>>(2 * (K + 1));
    x = c.take<float>(N);
    g = c.take<float>(N);
    m = c.take<float>(N);
    v = c.take<float>(N);
    bytes = c.off;
  }
  static SLAM_HD size_t lane_bytes(int K) { return AdamGenWs(nullptr, K).bytes; }
};

// the gate lists of K gates, then the lane workspaces, each 16-byte aligned
SLAM_HD size_t adam_gen_gate_bytes(int K) { return align16(sizeof(GateNz<float>) * K); }

struct AdamGenThread {
  C<float> X[4];   // row c of X_i
  C<float> t;      // tr(T^dag U)
  float part[6];   // operands of the team's sums
};

// adam_forward: the forward chain at ws.x, its sines and cosines, thread t
// column t of P_0..P_K and of U; leaves t = tr(T^dag U) in every th.t
template <class Team> SLAM_HD void adam_gen_forward(Team& tm, const AdamGenWs& ws, const GateNz<float>* G) {
  const int K = ws.K, NT = 2 * (K + 1);
  SLAM_EACH(tm, t) {
    for (int s = t; s < NT; s += kAdamTeam) ws.trig[s] = u3_trig(ws.x + 3 * s);
  }
  tm.sync();
  SLAM_EACH(tm, t) {
    AdamGenThread& th = tm.th(t);
    C<float> v[4], w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = cmk(q == t ? 1.f : 0.f, 0.f);
#pragma unroll 1
    for (int i = 0; i <= K; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) ws.P[(4 * i + q) * 4 + t] = v[q];
      M2<float> A, B;
      u3_build(ws.trig[2 * i], A, (M2<float>*)nullptr);
      u3_build(ws.trig[2 * i + 1], B, (M2<float>*)nullptr);
      kron_col(A, B, v, w);
      if (i < K) {
#pragma unroll
        for (int q = 0; q < 4; ++q) ws.y[4 * t + q] = w[q];
        gate_col(G[i], ws.y + 4 * t, v);
      }
    }
    C<float> tr = cjmul(ws.T[t], w[0]);
#pragma unroll
    for (int q = 1; q < 4; ++q) tr = cadd(tr, cjmul(ws.T[4 * q + t], w[q]));
    th.part[0] = tr.re;
    th.part[1] = tr.im;
  }
  tm.sum(&AdamGenThread::part);
  SLAM_EACH(tm, t) {
    AdamGenThread& th = tm.th(t);
    th.t = cmk(th.part[0], th.part[1]);
  }
}

// adam_team: iters Adam steps on the lane whose x0 and target are in ws;
// the result is left in ws.x
template <class Team>
SLAM_HD void adam_gen_team(Team& tm, const AdamGenWs& ws, const GateNz<float>* G, const float* __restrict__ sched,
                           int iters) {
  const int K = ws.K, N = ws.N;
  SLAM_EACH(tm, t) {
    for (int p = t; p < N; p += kAdamTeam) {
      ws.m[p] = 0.f;
      ws.v[p] = 0.f;
    }
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    adam_gen_forward(tm, ws, G);
    SLAM_EACH(tm, t) {  // X_K = T^dag: row t is conj(T[:, t])
      AdamGenThread& th = tm.th(t);
#pragma unroll
      for (int a = 0; a < 4; ++a) th.X[a] = cmk(ws.T[4 * a + t].re, -ws.T[4 * a + t].im);
    }
#pragma unroll 1
    for (int i = K; i >= 0; --i) {
      SLAM_EACH(tm, t) {
        AdamGenThread& th = tm.th(t);
        C<float> Pc[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) Pc[q] = ws.P[(4 * i + q) * 4 + t];
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
          for (int q = 0; q < 4; ++q) ws.y[4 * t + q] = w[q];
          gate_row(G[i - 1], ws.y + 4 * t, th.X);
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
      tm.sum(&AdamGenThread::part);
      SLAM_EACH(tm, t) {  // keep the gradient entries this thread owns
        AdamGenThread& th = tm.th(t);
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const int p = 6 * i + j;
          if (p % kAdamTeam == t) ws.g[p] = th.part[j];
        }
      }
    }
    SLAM_EACH(tm, t) {
      const float s0 = sched[3 * it], s1 = sched[3 * it + 1], s2 = sched[3 * it + 2];
      for (int p = t; p < N; p += kAdamTeam) {
        const float g = ws.g[p];
        const float m = 0.9f * ws.m[p] + 0.1f * g;
        const float v = 0.999f * ws.v[p] + 0.001f * (g * g);
        ws.m[p] = m;
        ws.v[p] = v;
        const float mhat = m * s0;
        const float vhat = v * s1;
        ws.x[p] = ws.x[p] - s2 * mhat / (sqrtf(vhat) + 1e-8f);
      }
    }
    tm.sync();
  }
}

// adam_team_io: one lane from the raw arrays: load x0 and the target, run,
// store (only where `store`: a team past the last lane repeats lane L-1);
// with Cost, one more forward chain gives the square cost at the final x
template <bool Cost, class Team>
SLAM_HD void adam_gen_team_io(Team& tm, const AdamGenWs& ws, const GateNz<float>* G, const float* __restrict__ x0,
                              const float* __restrict__ tgt, const float* __restrict__ sched, int iters, int lane,
                              bool store, float* __restrict__ xout, float* __restrict__ fout) {
  const int N = ws.N;
  SLAM_EACH(tm, t) {
    for (int p = t; p < N; p += kAdamTeam) ws.x[p] = x0[(size_t)lane * N + p];
    for (int e = t; e < 16; e += kAdamTeam)
      ws.T[e] = cmk(tgt[32 * (size_t)lane + 2 * e], tgt[32 * (size_t)lane + 2 * e + 1]);
  }
  tm.sync();
  adam_gen_team(tm, ws, G, sched, iters);
  SLAM_EACH(tm, t) {
    for (int p = t; p < N; p += kAdamTeam) {
      if (store) xout[(size_t)lane * N + p] = ws.x[p];
    }
  }
  if constexpr (Cost) {
    adam_gen_forward(tm, ws, G);
    SLAM_EACH(tm, t) {
      const C<float> tr = tm.th(t).t;
      if (store && t == 0) fout[lane] = 1.f - (tr.re * tr.re + tr.im * tr.im + 4.f) / 20.f;
    }
  }
}

}  // namespace slam

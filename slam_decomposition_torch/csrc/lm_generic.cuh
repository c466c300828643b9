// Levenberg-Marquardt on the phase residual for one lane of a chain of any
// depth K (a runtime argument), run by a team of 32 threads (one warp) over
// a per-lane workspace in shared memory laid out for K at launch. One
// program, templated on the residual type R, serves two kernels: R = float
// is the f32 ranking pass (lm_chain_generic.cu), R = double the polish
// (polish_chain_generic.cu). The host build (host_lanes.cpp) runs it too.
//
// It is lm_team.cuh's program for wide chains (more parameters than the
// team's 32 threads), step for step and sum for sum: the chain parts,
// J column by column, b, the matrix-free CG (A + lam I) p = J^T (J p) +
// lam p from J in shared memory, J's rows padded to an odd number of
// 16-byte units, the trial step and the accept test in R. What makes K a
// runtime value: the layer loops are rolled, thread t loops over its
// parameters t, t + 32, ... below n, and the CG's per-parameter vectors
// (b, x, r, p, (A + lam I) p), which lm_team.cuh keeps in registers sized
// by K (kLmSlots<K>, 10 a thread at K = 48), sit in the lane's workspace,
// entry p written and read by thread p % 32 only.

#pragma once

#include <type_traits>

#include "lm_team.cuh"

namespace slam {

// J's row length for n parameters: lm_team.cuh's kLmRowPad (K >= 5)
SLAM_HD int lm_gen_row_pad(int n) { return ((n + 3) / 4 | 1) * 4; }

// The lane workspace for depth K (lm_team.cuh's LmWs / LmHi, the same
// arrays and paddings, plus the CG's vectors). With R = double the f64
// state comes first and x is float(xd) (where J is taken).
template <typename R> struct LmGenWs {
  int K, N, NP;
  float *J, *p;        // J[e NP + q] = d r_e / d x_q; CG direction p[b NP + q], double-buffered
  float *x, *xn;       // parameters, trial parameters
  float *r, *rn;       // residual of x, of the trial point, as f32 (rn: J p during CG)
  C<float> *T, *P, *S, *V, *y;  // target; P[17 i + 4 a + q], S likewise; the chain; y[4 t + q] per chain thread
  Trig<float>* trig;   // u3 factors of the last f32 chain built
  float *b, *xc, *rc, *pc, *ap;  // CG of parameter q: right-hand side, x, r, p, (A + lam I) p
  double *xd, *xnd;               // R = double: parameters, trial parameters
  C<double> *Td, *Vd, *yd, *trd;  // target, chain of the last f64 residual, yd[5 t + q], trd[t]
  Trig<double>* trigd;            // u3 factors of the last f64 residual
  size_t bytes;

  SLAM_HD LmGenWs(unsigned char* base, int K_) : K(K_), N(6 * (K_ + 1)), NP(lm_gen_row_pad(6 * (K_ + 1))) {
    constexpr int MS = 17;
    const int NT = 2 * (K + 1), n4 = (N + 3) / 4 * 4;
    Carve c{base, 0};
    if constexpr (std::is_same_v<R, double>) {
      xd = c.take<double>(n4);
      xnd = c.take<double>(n4);
      Td = c.take<C<double>>(16);
      Vd = c.take<C<double>>(16);
      yd = c.take<C<double>>(4 * 5);
      trd = c.take<C<double>>(4);
      trigd = c.take<Trig<double>>(NT);
    } else {
      xd = xnd = nullptr;
      Td = Vd = yd = trd = nullptr;
      trigd = nullptr;
    }
    J = c.take<float>(32 * NP);
    p = c.take<float>(2 * NP);
    x = c.take<float>(n4);
    xn = c.take<float>(n4);
    r = c.take<float>(32);
    rn = c.take<float>(32);
    T = c.take<C<float>>(16);
    P = c.take<C<float>>((K + 1) * MS);
    S = c.take<C<float>>((K + 1) * MS);
    V = c.take<C<float>>(16);
    y = c.take<C<float>>(8 * 4);
    trig = c.take<Trig<float>>(NT);
    b = c.take<float>(n4);
    xc = c.take<float>(n4);
    rc = c.take<float>(n4);
    pc = c.take<float>(n4);
    ap = c.take<float>(n4);
    bytes = c.off;
  }
  static SLAM_HD size_t lane_bytes(int K) { return LmGenWs(nullptr, K).bytes; }
};

// the gate lists a block holds: f32 ones, and f64 ones for the polish
template <typename R> SLAM_HD size_t lm_gen_gate_bytes(int K) {
  return align16(sizeof(GateNz<float>) * K) + (std::is_same_v<R, double> ? align16(sizeof(GateNz<double>) * K) : 0);
}

template <typename R> struct LmGenThread {
  float rs;        // uniform across the team
  int shift;       // the polish's CG runs on b 2^-shift (uniform)
  R f0, lam;       // uniform across the team
  C<float> z;      // e^{i phi} of the last f32 chain built
  float mag;       // |tr(T^dag U)| of the last f32 chain built
  bool fresh;      // x moved: J and b must be rebuilt
  float part[1];   // operand of the CG's sums
  R sq[1];         // operand of the sum ||r||^2
};

// lm_chain_parts: trig of xs, then the chain parts P, S, V; ends with a barrier
template <typename R, class Team>
SLAM_HD void lm_gen_chain_parts(Team& tm, const LmGenWs<R>& ws, const float* xs, const GateNz<float>* G) {
  constexpr int MS = 17;
  const int K = ws.K, NT = 2 * (K + 1);
  SLAM_EACH(tm, t) {
    for (int s = t; s < NT; s += kLmTeam) ws.trig[s] = u3_trig(xs + 3 * s);
  }
  tm.sync();
  SLAM_EACH(tm, t) {
    if (t < 4) {  // column t of P_0..P_K and of V
      C<float> v[4], w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = cmk(q == t ? 1.f : 0.f, 0.f);
#pragma unroll 1
      for (int i = 0; i <= K; ++i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) ws.P[MS * i + 4 * q + t] = v[q];
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
#pragma unroll
      for (int q = 0; q < 4; ++q) ws.V[4 * q + t] = w[q];
    } else if (t < 8) {  // row t - 4 of S_K..S_0
      const int j = t - 4;
      C<float> u[4], w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) u[q] = cmk(q == j ? 1.f : 0.f, 0.f);
#pragma unroll 1
      for (int i = K; i >= 0; --i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) ws.S[MS * i + 4 * j + q] = u[q];
        if (i > 0) {
          M2<float> A, B;
          u3_build(ws.trig[2 * i], A, (M2<float>*)nullptr);
          u3_build(ws.trig[2 * i + 1], B, (M2<float>*)nullptr);
          kron_row(A, B, u, w);
#pragma unroll
          for (int q = 0; q < 4; ++q) ws.y[4 * t + q] = w[q];
          gate_row(G[i - 1], ws.y + 4 * t, u);
        }
      }
    }
  }
  tm.sync();
}

// lm_phase: the phase of the f32 chain in ws.V, every thread for itself
template <typename R> SLAM_HD void lm_gen_phase(const LmGenWs<R>& ws, LmGenThread<R>& th) {
  C<float> tr = cjmul(ws.T[0], ws.V[0]);
  for (int e = 1; e < 16; ++e) tr = cadd(tr, cjmul(ws.T[e], ws.V[e]));
  phase_of(tr, th.z, th.mag);
}

// lm_residual: every thread the phase of the f32 chain, then residual entry
// t into out and its square into sq[0], summed over the team
template <class Team> SLAM_HD void lm_gen_residual(Team& tm, const LmGenWs<float>& ws, float* out) {
  SLAM_EACH(tm, t) {
    LmGenThread<float>& th = tm.th(t);
    lm_gen_phase(ws, th);
    const float v = lm_residual_entry(t, ws.T, ws.V, th.z);
    out[t] = v;
    th.sq[0] = v * v;
  }
  tm.sum(&LmGenThread<float>::sq);
}

// lm_residual_f64: the polish's residual at xs in f64 (sines and cosines
// one pair a thread, then threads 0-3 one column of the chain each, then
// every thread the phase and entry t); its f32 cast goes into out, its f64
// square into sq[0], summed over the team
template <class Team>
SLAM_HD void lm_gen_residual_f64(Team& tm, const LmGenWs<double>& ws, const double* xs, const GateNz<double>* G,
                                 float* out) {
  const int K = ws.K, pairs = 8 * (K + 1);
  SLAM_EACH(tm, t) {
    for (int s = t; s < pairs; s += kLmTeam) u3_trig_pair(xs + 3 * (s / 4), s % 4, ws.trigd[s / 4]);
  }
  tm.sync();
  SLAM_EACH(tm, t) {
    if (t < 4) {
      C<double> v[4], w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = cmk(q == t ? 1.0 : 0.0, 0.0);
#pragma unroll 1
      for (int i = 0; i <= K; ++i) {
        M2<double> A, B;
        u3_build(ws.trigd[2 * i], A, (M2<double>*)nullptr);
        u3_build(ws.trigd[2 * i + 1], B, (M2<double>*)nullptr);
        kron_col(A, B, v, w);
        if (i < K) {
#pragma unroll
          for (int q = 0; q < 4; ++q) ws.yd[5 * t + q] = w[q];
          gate_col(G[i], ws.yd + 5 * t, v);
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
  tm.sum(&LmGenThread<double>::sq);
}

// lm_jacobian_column: column q of J at the last f32 chain built; D =
// dU/dx_q is written into the column first, then the phase factor's term
// is taken off
template <typename R> SLAM_HD void lm_gen_jacobian_column(int q, const LmGenWs<R>& ws, const LmGenThread<R>& th) {
  constexpr int MS = 17;
  const int i = q / 6, j = q % 6, NP = ws.NP;
  M2<float> first, second;  // dL_i/dx_q = first (x) second
  if (j < 3) {
    u3_deriv(ws.trig[2 * i], j, first);
    u3_build(ws.trig[2 * i + 1], second, (M2<float>*)nullptr);
  } else {
    u3_build(ws.trig[2 * i], first, (M2<float>*)nullptr);
    u3_deriv(ws.trig[2 * i + 1], j - 3, second);
  }
  const C<float>* Pi = ws.P + MS * i;
  const C<float>* Si = ws.S + MS * i;
  C<float> dt = cmk(0.f, 0.f);  // tr(T^dag D), summed column by column
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    C<float> v[4], w[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) v[a] = Pi[4 * a + c];
    kron_col(first, second, v, w);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      C<float> acc = cmul(Si[4 * a], w[0]);
#pragma unroll
      for (int m = 1; m < 4; ++m) acc = cadd(acc, cmul(Si[4 * a + m], w[m]));
      ws.J[(4 * a + c) * NP + q] = acc.re;
      ws.J[(16 + 4 * a + c) * NP + q] = acc.im;
      dt = cadd(dt, cjmul(ws.T[4 * a + c], acc));
    }
  }
  // d(t/|t|) = i z Im(conj(z) dt) / |t|
  const float w = (th.z.re * dt.im - th.z.im * dt.re) / th.mag;
  const C<float> dz = cmk(-th.z.im * w, th.z.re * w);
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const C<float> dzt = cmul(dz, ws.T[e]);
    ws.J[e * NP + q] -= dzt.re;
    ws.J[(16 + e) * NP + q] -= dzt.im;
  }
}

// lm_team: iters LM iterations on the lane's parameters (ws.x for the f32
// pass, ws.xd for the polish; loaded, with the target, before the call); G
// are the f32 gate lists, GR those of the residual's type. Ends with the
// final accepted ||r||^2 in every thread's f0.
template <typename R, class Team>
SLAM_HD void lm_gen_team(Team& tm, const LmGenWs<R>& ws, const GateNz<float>* G, const GateNz<R>* GR, int iters) {
  const int N = ws.N, NP = ws.NP;
  constexpr bool kF64 = std::is_same_v<R, double>;
  if constexpr (kF64) {
    lm_gen_residual_f64(tm, ws, ws.xd, GR, ws.r);
  } else {
    lm_gen_chain_parts(tm, ws, ws.x, G);
    lm_gen_residual(tm, ws, ws.r);
  }
  SLAM_EACH(tm, t) {
    LmGenThread<R>& th = tm.th(t);
    th.f0 = th.sq[0];
    th.lam = R(1e-3);
    th.fresh = true;
  }
  tm.sync();
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    if (tm.any().fresh) {  // uniform
      if constexpr (kF64) {  // the f32 chain parts at float(x), and their phase
        SLAM_EACH(tm, t) {
          for (int q = t; q < N; q += kLmTeam) ws.x[q] = (float)ws.xd[q];
        }
        tm.sync();
        lm_gen_chain_parts(tm, ws, ws.x, G);
        SLAM_EACH(tm, t) lm_gen_phase(ws, tm.th(t));
      }  // else the chain parts in ws are those of x already
      SLAM_EACH(tm, t) {
        for (int q = t; q < N; q += kLmTeam) lm_gen_jacobian_column(q, ws, tm.th(t));
      }
      tm.sync();
      SLAM_EACH(tm, t) {  // b
        for (int q = t; q < N; q += kLmTeam) {
          float b = 0.f;
          for (int e = 0; e < 32; ++e) b += ws.J[e * NP + q] * ws.r[e];
          ws.b[q] = -b;
        }
      }
    }
    SLAM_EACH(tm, t) {
      LmGenThread<R>& th = tm.th(t);
      th.part[0] = 0.f;
      for (int q = t; q < N; q += kLmTeam) th.part[0] += ws.b[q] * ws.b[q];
    }
    tm.sum(&LmGenThread<R>::part);
    SLAM_EACH(tm, t) {  // CG from 0
      LmGenThread<R>& th = tm.th(t);
      th.rs = th.part[0];
      if constexpr (kF64) {
        // CG is linear in b and exact under a power of two: it runs on
        // b 2^-s with b^T b 2^-2s in [1/2, 4), out of f32's slow subnormal
        // divisions, and dx is scaled back in f64 (lm_team.cuh)
        th.shift = th.rs > 0.f && th.rs <= kF32Max ? ilogbf(th.rs) / 2 : 0;
        th.rs = ldexpf(th.rs, -2 * th.shift);
      }
      for (int q = t; q < N; q += kLmTeam) {
        float b = ws.b[q];  // ws.b stays unscaled: a rejected step reuses it
        if constexpr (kF64) b = ldexpf(b, -th.shift);
        ws.xc[q] = 0.f;
        ws.rc[q] = b;
        ws.pc[q] = b;
        ws.p[q] = b;
      }
    }
    tm.sync();
#pragma unroll 1
    for (int c = 0; c < N + kCgExtra; ++c) {
      const float* p = ws.p + (c & 1) * NP;
      SLAM_EACH(tm, t) {  // (J p)_t into rn: the trial residual's slot is free during CG
        const float* Jt = ws.J + t * NP;
        float acc = 0.f;
        for (int j4 = 0; j4 < (N + 3) / 4; ++j4) {
          const F4 a = f4(Jt + 4 * j4), q = f4(p + 4 * j4);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (4 * j4 + u < N) acc += a.v[u] * q.v[u];
        }
        ws.rn[t] = acc;
      }
      tm.sync();
      SLAM_EACH(tm, t) {  // columns t, t + 32, ... of J times J p
        LmGenThread<R>& th = tm.th(t);
        th.part[0] = 0.f;
        for (int q = t; q < N; q += kLmTeam) {
          float acc = (float)th.lam * ws.pc[q];
#pragma unroll
          for (int e4 = 0; e4 < 8; ++e4) {
            const F4 v = f4(ws.rn + 4 * e4);
#pragma unroll
            for (int u = 0; u < 4; ++u) acc += ws.J[(4 * e4 + u) * NP + q] * v.v[u];
          }
          ws.ap[q] = acc;
          th.part[0] += ws.pc[q] * acc;
        }
      }
      tm.sum(&LmGenThread<R>::part);
      SLAM_EACH(tm, t) {
        LmGenThread<R>& th = tm.th(t);
        // guards keep NaN (as torch.clamp_min does) but lift 0 and underflow
        const float pAp = th.part[0];
        const float alpha = th.rs / (pAp < kF32Tiny ? kF32Tiny : pAp);
        th.part[0] = 0.f;
        for (int q = t; q < N; q += kLmTeam) {
          ws.xc[q] += alpha * ws.pc[q];
          const float rc = ws.rc[q] - alpha * ws.ap[q];
          ws.rc[q] = rc;
          th.part[0] += rc * rc;
        }
      }
      tm.sum(&LmGenThread<R>::part);
      SLAM_EACH(tm, t) {
        LmGenThread<R>& th = tm.th(t);
        const float rs_new = th.part[0];
        const float beta = rs_new / (th.rs < kF32Tiny ? kF32Tiny : th.rs);
        th.rs = rs_new;
        float* pn = ws.p + ((c + 1) & 1) * NP;
        for (int q = t; q < N; q += kLmTeam) {
          const float pq = ws.rc[q] + beta * ws.pc[q];
          ws.pc[q] = pq;
          pn[q] = pq;
        }
      }
      tm.sync();
    }
    if constexpr (kF64) {
      SLAM_EACH(tm, t) {
        for (int q = t; q < N; q += kLmTeam) ws.xnd[q] = ws.xd[q] + ldexp((double)ws.xc[q], tm.th(t).shift);
      }
      tm.sync();
      lm_gen_residual_f64(tm, ws, ws.xnd, GR, ws.rn);
    } else {
      SLAM_EACH(tm, t) {
        for (int q = t; q < N; q += kLmTeam) ws.xn[q] = ws.x[q] + ws.xc[q];
      }
      tm.sync();
      lm_gen_chain_parts(tm, ws, ws.xn, G);
      lm_gen_residual(tm, ws, ws.rn);
    }
    SLAM_EACH(tm, t) {
      LmGenThread<R>& th = tm.th(t);
      const R fn = th.sq[0];
      th.fresh = fn < th.f0;  // a NaN trial step is "not improved"
      if (th.fresh) {
        for (int q = t; q < N; q += kLmTeam) {
          if constexpr (kF64) ws.xd[q] = ws.xnd[q];
          else ws.x[q] = ws.xn[q];
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
}

// lm_team_io: one lane from the raw arrays: load x0 (the polish reduces its
// angles mod 4 pi) and the target, run, store (only where `store`: a team
// past the last lane repeats lane L-1)
template <typename R, class Team>
SLAM_HD void lm_gen_team_io(Team& tm, const LmGenWs<R>& ws, const GateNz<float>* G, const GateNz<R>* GR,
                            const R* __restrict__ x0, const R* __restrict__ tgt, int iters, int lane, bool store,
                            R* __restrict__ xout, R* __restrict__ fout) {
  const int N = ws.N;
  constexpr bool kF64 = std::is_same_v<R, double>;
  SLAM_EACH(tm, t) {
    const R* tg = tgt + 32 * (size_t)lane;
    if constexpr (kF64) {
      for (int q = t; q < N; q += kLmTeam) {
        const double v = x0[(size_t)lane * N + q];
        ws.xd[q] = v - kFourPi * rint(v / kFourPi);
      }
      if (t < 16) {
        ws.Td[t] = cmk(tg[2 * t], tg[2 * t + 1]);
        ws.T[t] = cmk((float)tg[2 * t], (float)tg[2 * t + 1]);
      }
    } else {
      for (int q = t; q < N; q += kLmTeam) ws.x[q] = x0[(size_t)lane * N + q];
      if (t < 16) ws.T[t] = cmk(tg[2 * t], tg[2 * t + 1]);
    }
  }
  tm.sync();
  lm_gen_team(tm, ws, G, GR, iters);
  SLAM_EACH(tm, t) {
    for (int q = t; q < N; q += kLmTeam) {
      if (store) {
        if constexpr (kF64) xout[(size_t)lane * N + q] = ws.xd[q];
        else xout[(size_t)lane * N + q] = ws.x[q];
      }
    }
    if (store && t == 0) fout[lane] = tm.th(t).f0;
  }
}

}  // namespace slam

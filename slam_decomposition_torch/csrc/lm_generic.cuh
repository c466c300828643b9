// Levenberg-Marquardt on the phase residual for one lane of a chain of any
// depth K (a runtime argument), run by a team of 32 threads (one warp) over
// a per-lane workspace in shared memory laid out for K at launch. One
// program, templated on the residual type R, serves two kernels: R = float
// is the f32 ranking pass (lm_chain_generic.cu), R = double the polish
// (polish_chain_generic.cu). The host build (host_lanes.cpp) runs it too.
//
// It is lm_team.cuh's program for wide chains (more parameters than the
// team's 32 threads), step for step and sum for sum: the chain parts, J
// column by column, b, the matrix-free CG (A + lam I) p = J^T (J p) + lam p,
// the trial step and the accept test in R. Thread t owns parameters t,
// t + 32, ...: their CG vectors (b, x, r, p, (A + lam I) p) sit in its
// registers, as lm_team.cuh's kLmSlots<K> do, in arrays of a compile-time
// slot bucket SB (lm_gen_bucket: 3, 4, 8 or 16 slots, K <= 15, 20, 41, 84)
// whose loops stop at the lane's own slot count ns, a runtime value. What
// makes K a runtime value besides: the layer loops are rolled and the
// workspace is carved from K at launch.
//
// What bounds it on the H100: CG (89-97% of the time), n + 8 iterations of
// J p (thread e reads row e of J) and J^T (J p) (thread t reads its
// columns), one multiply-add per J entry read. From shared memory (128 B a
// clock an SM) that is a quarter of the f32 rate at best, and few lanes an
// SM leave the latency of each read exposed. So each thread also copies
// the first lm_gen_jregs(SB) slots of its J columns into registers before
// CG: J^T (J p) reads them there (all of them to K = 20, 2 of at most 8 to
// K = 41, then 1 of at most 16) and only J p streams all of J from shared
// memory. The
// slots of J^T (J p) are taken in groups of four under one uniform test,
// so that a group's loads issue together (a test a slot serialised them:
// 2x the time at K = 48, 79), and the other slot loops run every slot
// without a branch.
//
// The order of every sum is lm_team.cuh's: (J p)_e is thread e's sum over
// q = 0, 1, ... in order; (J^T v)_q is lam p_q plus the sum over e = 0..31
// in order, on the thread that owns q; the team sums are butterflies over
// each thread's slots summed in slot order. J's rows and both p buffers are
// zero from n to their padded length NP, so the J p loop runs over whole
// 16-byte units without a bound check: the terms it adds past n are 0 x 0,
// which leave every partial sum exactly as it was.
//
// The gate lists are the same for every lane of a launch: the launcher
// builds them once in device memory (lm_gen_gate_lists_kernel) and every
// lane reads them through the read-only path, so a block holds only lane
// workspaces, as many as lm_gen_lanes packs into an SM within the register
// budget (lm_gen_lanes_cap).

#pragma once

#include <mutex>
#include <type_traits>
#include <utility>

#include "lm_team.cuh"

namespace slam {

// J's row length for n parameters: lm_team.cuh's kLmRowPad (K >= 5)
SLAM_HD int lm_gen_row_pad(int n) { return ((n + 3) / 4 | 1) * 4; }

// parameters a thread owns at depth K: t, t + 32, ... below n = 6(K+1)
SLAM_HD int lm_gen_slots(int K) { return (6 * (K + 1) + kLmTeam - 1) / kLmTeam; }

// The slot buckets the program is compiled for: depth K runs in the
// smallest SB >= lm_gen_slots(K).
SLAM_HD int lm_gen_bucket(int K) {
  const int s = lm_gen_slots(K);
  return s <= 3 ? 3 : s <= 4 ? 4 : s <= 8 ? 8 : 16;
}

// slots of J's columns a thread keeps in registers during CG: all of them
// to K = 20, then 2 of 8 and 1 of 16, where the CG vectors take 40 and 80
// registers (3 of 8 and 2 of 16 spilled the polish at 255)
SLAM_HD constexpr int lm_gen_jregs(int SB) { return SB <= 4 ? SB : SB == 8 ? 2 : 1; }

// The most lanes (warps) an SM runs of bucket SB. Its __launch_bounds__
// holds the registers to what that many warps leave a thread: an SM's 64 K
// registers sit in four partitions of 16 K and its warps are spread over
// them, so 9-12 warps leave 168 a thread, 8 and fewer 255. Every bucket
// needs more than 168 (at 168 they spilled 8-116 B with 2-3 J slots), so
// the register file, not shared memory, holds the LM and the polish to 8
// lanes an SM through K = 20.
SLAM_HD constexpr int lm_gen_lanes_cap(int SB) { return SB <= 8 ? 8 : 4; }

// f(std::integral_constant<int, SB>{}) for depth K's bucket
template <class F> inline auto lm_gen_by_bucket(int K, F&& f) {
  switch (lm_gen_bucket(K)) {
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return f(std::integral_constant<int, 16>{});
  }
}

// The lane workspace for depth K (lm_team.cuh's LmWs / LmHi, the same
// arrays and paddings). With R = double the f64 state comes first and x is
// float(xd) (where J is taken).
template <typename R> struct LmGenWs {
  int K, N, NP;
  float *J, *p;        // J[e NP + q] = d r_e / d x_q; CG direction p[b NP + q], double-buffered; both 0 past N
  float *x, *xn;       // parameters, trial parameters
  float *r, *rn;       // residual of x, of the trial point, as f32 (rn: J p during CG)
  C<float> *T, *P, *S, *V, *y;  // target; P[17 i + 4 a + q], S likewise; the chain; y[4 t + q] per chain thread
  Trig<float>* trig;   // u3 factors of the last f32 chain built
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
    bytes = c.off;
  }
  static SLAM_HD size_t lane_bytes(int K) { return LmGenWs(nullptr, K).bytes; }
};

// the gate lists of a launch, in device memory: f32 ones, and f64 ones for
// the polish after them
template <typename R> SLAM_HD size_t lm_gen_gate_bytes(int K) {
  return align16(sizeof(GateNz<float>) * K) + (std::is_same_v<R, double> ? align16(sizeof(GateNz<double>) * K) : 0);
}

// Lanes a block for lane workspaces of lane_bytes when registers hold at
// most cap lanes an SM: the fewest that put the most lanes on an SM (228 KB,
// 1 KB reserved a block, at most 227 KB a block), at least one.
SLAM_HD int lm_gen_lanes(size_t lane_bytes, int cap) {
  int best = 1, most = 0;
  for (int l = 1; l <= cap && l * lane_bytes <= kBlockSmemMax; ++l) {
    const int by_smem = (int)(kSmemPerSm / (l * lane_bytes + kSmemReservedPerBlock));
    const int blocks = by_smem < cap / l ? by_smem : cap / l;
    if (l * blocks > most) {
      best = l;
      most = l * blocks;
    }
  }
  return best;
}

template <typename R> SLAM_HD int lm_gen_block_lanes(int K) {
  return lm_gen_lanes(LmGenWs<R>::lane_bytes(K), lm_gen_lanes_cap(lm_gen_bucket(K)));
}

template <typename R, int SB> struct LmGenThread {
  static constexpr int JR = lm_gen_jregs(SB);
  float jr[JR][kLmTeam];  // column t + 32 s of J, s < JR, during CG
  // CG of parameter t + 32 s: right-hand side, x, r, p, (A + lam I) p
  float b[SB], xc[SB], rc[SB], pc[SB], ap[SB];
  float rs;        // uniform across the team
  int shift;       // the polish's CG runs on b 2^-shift (uniform)
  R f0, lam;       // uniform across the team
  C<float> z;      // e^{i phi} of the last f32 chain built
  float mag;       // |tr(T^dag U)| of the last f32 chain built
  bool fresh;      // x moved: J and b must be rebuilt
  float part[1];   // operand of the CG's sums
  R sq[1];         // operand of the sum ||r||^2
};

template <class Team> using TeamThread = std::remove_reference_t<decltype(std::declval<Team&>().th(0))>;

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
template <typename R, class Th> SLAM_HD void lm_gen_phase(const LmGenWs<R>& ws, Th& th) {
  C<float> tr = cjmul(ws.T[0], ws.V[0]);
  for (int e = 1; e < 16; ++e) tr = cadd(tr, cjmul(ws.T[e], ws.V[e]));
  phase_of(tr, th.z, th.mag);
}

// lm_residual: every thread the phase of the f32 chain, then residual entry
// t into out and its square into sq[0], summed over the team
template <class Team> SLAM_HD void lm_gen_residual(Team& tm, const LmGenWs<float>& ws, float* out) {
  SLAM_EACH(tm, t) {
    auto& th = tm.th(t);
    lm_gen_phase(ws, th);
    const float v = lm_residual_entry(t, ws.T, ws.V, th.z);
    out[t] = v;
    th.sq[0] = v * v;
  }
  tm.sum(&TeamThread<Team>::sq);
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
  tm.sum(&TeamThread<Team>::sq);
}

// lm_jacobian_column: column q of J at the last f32 chain built; D =
// dU/dx_q is written into the column first, then the phase factor's term
// is taken off
template <typename R, class Th> SLAM_HD void lm_gen_jacobian_column(int q, const LmGenWs<R>& ws, const Th& th) {
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
// final accepted ||r||^2 in every thread's f0. Slot s of thread t is
// parameter t + 32 s; every slot loop runs to SB and does what lm_team.cuh
// does for s < ns only.
template <typename R, int SB, class Team>
SLAM_HD void lm_gen_team(Team& tm, const LmGenWs<R>& ws, const GateNz<float>* G, const GateNz<R>* GR, int iters) {
  using Th = LmGenThread<R, SB>;
  constexpr int JR = Th::JR;
  const int N = ws.N, NP = ws.NP, ns = lm_gen_slots(ws.K);
  constexpr bool kF64 = std::is_same_v<R, double>;
  if constexpr (kF64) {
    lm_gen_residual_f64(tm, ws, ws.xd, GR, ws.r);
  } else {
    lm_gen_chain_parts(tm, ws, ws.x, G);
    lm_gen_residual(tm, ws, ws.r);
  }
  SLAM_EACH(tm, t) {
    Th& th = tm.th(t);
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
#pragma unroll
          for (int s = 0; s < SB; ++s)
            if (s < ns && t + kLmTeam * s < N) ws.x[t + kLmTeam * s] = (float)ws.xd[t + kLmTeam * s];
        }
        tm.sync();
        lm_gen_chain_parts(tm, ws, ws.x, G);
        SLAM_EACH(tm, t) lm_gen_phase(ws, tm.th(t));
      }  // else the chain parts in ws are those of x already
      SLAM_EACH(tm, t) {  // a rolled loop: no register array here, and one copy of the column's code
#pragma unroll 1
        for (int q = t; q < N; q += kLmTeam) lm_gen_jacobian_column(q, ws, tm.th(t));
      }
      tm.sync();
      SLAM_EACH(tm, t) {  // b
        Th& th = tm.th(t);
#pragma unroll
        for (int s = 0; s < SB; ++s) {
          const int p = t + kLmTeam * s;
          float b = 0.f;
          if (s < ns && p < N) {
            for (int e = 0; e < 32; ++e) b += ws.J[e * NP + p] * ws.r[e];
          }
          th.b[s] = -b;
        }
      }
    }
    SLAM_EACH(tm, t) {
      Th& th = tm.th(t);
      th.part[0] = th.b[0] * th.b[0];
#pragma unroll
      for (int s = 1; s < SB; ++s)
        if (s < ns) th.part[0] += th.b[s] * th.b[s];
    }
    tm.sum(&Th::part);
    SLAM_EACH(tm, t) {  // CG from 0; parameters p >= N carry zeros
      Th& th = tm.th(t);
      th.rs = th.part[0];
      if constexpr (kF64) {
        // CG is linear in b and exact under a power of two: it runs on
        // b 2^-s with b^T b 2^-2s in [1/2, 4), out of f32's slow subnormal
        // divisions, and dx is scaled back in f64 (lm_team.cuh)
        th.shift = th.rs > 0.f && th.rs <= kF32Max ? ilogbf(th.rs) / 2 : 0;
        th.rs = ldexpf(th.rs, -2 * th.shift);
      }
      // every slot is set, also past ns (where b is 0): no CG value then
      // lives from one LM iteration into the next
#pragma unroll
      for (int s = 0; s < SB; ++s) {
        float b = th.b[s];  // th.b stays unscaled: a rejected step reuses it
        if constexpr (kF64) b = ldexpf(b, -th.shift);
        th.xc[s] = 0.f;
        th.rc[s] = b;
        th.pc[s] = b;
        if (t + kLmTeam * s < N) ws.p[t + kLmTeam * s] = b;
      }
#pragma unroll
      for (int s = 0; s < JR; ++s) {  // J's columns into registers (column 0 for a slot past N)
        const int col = t + kLmTeam * s < N ? t + kLmTeam * s : 0;
#pragma unroll
        for (int e = 0; e < 32; ++e) th.jr[s][e] = ws.J[e * NP + col];
      }
    }
    tm.sync();
#pragma unroll 1
    for (int c = 0; c < N + kCgExtra; ++c) {
      const float* p = ws.p + (c & 1) * NP;
      SLAM_EACH(tm, t) {  // (J p)_t into rn: the trial residual's slot is free during CG
        const float* Jt = ws.J + t * NP;
        float acc = 0.f;
        for (int j4 = 0; j4 < (N + 3) / 4; ++j4) {  // past N: 0 x 0
          const F4 a = f4(Jt + 4 * j4), q = f4(p + 4 * j4);
#pragma unroll
          for (int u = 0; u < 4; ++u) acc += a.v[u] * q.v[u];
        }
        ws.rn[t] = acc;
      }
      tm.sync();
      SLAM_EACH(tm, t) {  // columns t + 32 s of J times J p, plus lam p
        Th& th = tm.th(t);
        float acc[SB];
#pragma unroll
        for (int s = 0; s < SB; ++s) acc[s] = (float)th.lam * th.pc[s];
        // slots in groups of 4, one uniform test a group, so that a group's
        // loads are issued together (a slot of a group past ns reads column 0
        // and is dropped below)
#pragma unroll
        for (int g = 0; g < SB; g += 4) {
          if (g >= ns) break;
#pragma unroll
          for (int e4 = 0; e4 < 8; ++e4) {
            const F4 v = f4(ws.rn + 4 * e4);
#pragma unroll
            for (int s = g; s < (g + 4 < SB ? g + 4 : SB); ++s) {
              const int col = t + kLmTeam * s < N ? t + kLmTeam * s : 0;
#pragma unroll
              for (int u = 0; u < 4; ++u)
                acc[s] += (s < JR ? th.jr[s < JR ? s : 0][4 * e4 + u] : ws.J[(4 * e4 + u) * NP + col]) * v.v[u];
            }
          }
        }
#pragma unroll
        for (int s = 0; s < SB; ++s) {
          th.ap[s] = s < ns && t + kLmTeam * s < N ? acc[s] : 0.f;
          if (s < ns) th.part[0] = s == 0 ? th.pc[s] * th.ap[s] : th.part[0] + th.pc[s] * th.ap[s];
        }
      }
      tm.sum(&Th::part);
      SLAM_EACH(tm, t) {
        Th& th = tm.th(t);
        // guards keep NaN (as torch.clamp_min does) but lift 0 and underflow
        const float pAp = th.part[0];
        const float alpha = th.rs / (pAp < kF32Tiny ? kF32Tiny : pAp);
#pragma unroll
        for (int s = 0; s < SB; ++s) {  // every slot, without a branch; the sum takes s < ns
          th.xc[s] += alpha * th.pc[s];
          th.rc[s] -= alpha * th.ap[s];
          if (s < ns) th.part[0] = s == 0 ? th.rc[s] * th.rc[s] : th.part[0] + th.rc[s] * th.rc[s];
        }
      }
      tm.sum(&Th::part);
      SLAM_EACH(tm, t) {
        Th& th = tm.th(t);
        const float rs_new = th.part[0];
        const float beta = rs_new / (th.rs < kF32Tiny ? kF32Tiny : th.rs);
        th.rs = rs_new;
        float* pn = ws.p + ((c + 1) & 1) * NP;
#pragma unroll
        for (int s = 0; s < SB; ++s) {
          th.pc[s] = th.rc[s] + beta * th.pc[s];
          if (t + kLmTeam * s < N) pn[t + kLmTeam * s] = th.pc[s];
        }
      }
      tm.sync();
    }
    if constexpr (kF64) {
      SLAM_EACH(tm, t) {
#pragma unroll
        for (int s = 0; s < SB; ++s)
          if (s < ns && t + kLmTeam * s < N)
            ws.xnd[t + kLmTeam * s] = ws.xd[t + kLmTeam * s] + ldexp((double)tm.th(t).xc[s], tm.th(t).shift);
      }
      tm.sync();
      lm_gen_residual_f64(tm, ws, ws.xnd, GR, ws.rn);
    } else {
      SLAM_EACH(tm, t) {
#pragma unroll
        for (int s = 0; s < SB; ++s)
          if (s < ns && t + kLmTeam * s < N) ws.xn[t + kLmTeam * s] = ws.x[t + kLmTeam * s] + tm.th(t).xc[s];
      }
      tm.sync();
      lm_gen_chain_parts(tm, ws, ws.xn, G);
      lm_gen_residual(tm, ws, ws.rn);
    }
    SLAM_EACH(tm, t) {
      Th& th = tm.th(t);
      const R fn = th.sq[0];
      th.fresh = fn < th.f0;  // a NaN trial step is "not improved"
      if (th.fresh) {
#pragma unroll
        for (int s = 0; s < SB; ++s) {
          const int p = t + kLmTeam * s;
          if (s < ns && p < N) {
            if constexpr (kF64) ws.xd[p] = ws.xnd[p];
            else ws.x[p] = ws.xn[p];
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
}

// lm_team_io: one lane from the raw arrays: zero the padding of J's rows
// and of p, load x0 (the polish reduces its angles mod 4 pi) and the
// target, run, store (only where `store`: a team past the last lane
// repeats lane L-1)
template <typename R, int SB, class Team>
SLAM_HD void lm_gen_team_io(Team& tm, const LmGenWs<R>& ws, const GateNz<float>* G, const GateNz<R>* GR,
                            const R* __restrict__ x0, const R* __restrict__ tgt, int iters, int lane, bool store,
                            R* __restrict__ xout, R* __restrict__ fout) {
  const int N = ws.N, NP = ws.NP;
  constexpr bool kF64 = std::is_same_v<R, double>;
  SLAM_EACH(tm, t) {
    for (int q = N; q < NP; ++q) ws.J[t * NP + q] = 0.f;
    if (N + t < NP) {
      ws.p[N + t] = 0.f;
      ws.p[NP + N + t] = 0.f;
    }
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
  lm_gen_team<R, SB>(tm, ws, G, GR, iters);
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

#if defined(__CUDACC__)
// ------------------------------------------------------------ kernels

// entry idx in [0, 8K) of the launch's gate lists (GR: the polish's f64 ones)
template <typename R>
__global__ void lm_gen_gate_lists_kernel(const R* __restrict__ gates, int K, GateNz<float>* G, GateNz<R>* GR) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 8 * K) return;
  gate_nz_entry(gates, G, idx);
  if constexpr (std::is_same_v<R, double>) gate_nz_entry(gates, GR, idx);
}

// `lanes` lanes a block, warp w on lane blockIdx.x * lanes + w, each on its
// workspace of lane_bytes in the block's dynamic shared memory
template <typename R, int SB>
__global__ void __launch_bounds__(kLmTeam * lm_gen_lanes_cap(SB), 1)
    lm_gen_kernel(const R* __restrict__ x0, const R* __restrict__ tgt, const GateNz<float>* __restrict__ G,
                  const GateNz<R>* __restrict__ GR, int iters, int K, int L, int lanes, int lane_bytes,
                  R* __restrict__ xout, R* __restrict__ fout) {
  extern __shared__ __align__(16) unsigned char lm_gen_smem[];
  const int w = threadIdx.x / kLmTeam;
  const int lane = blockIdx.x * lanes + w;
  const LmGenWs<R> ws(lm_gen_smem + (size_t)w * lane_bytes, K);
  DevTeam<kLmTeam, LmGenThread<R, SB>> tm(threadIdx.x % kLmTeam);
  lm_gen_team_io<R, SB>(tm, ws, G, GR, x0, tgt, iters, lane < L ? lane : L - 1, lane < L, xout, fout);
}

// The current device's memory pool for the launches' gate lists. Freed
// lists stay in it (its release threshold is never reached), so a launch
// after the first maps no memory: the default pool's threshold of 0 returns
// freed memory at every synchronisation.
inline cudaError_t lm_gen_pool(cudaMemPool_t* pool) {
  constexpr int kMaxDevices = 64;
  static cudaMemPool_t pools[kMaxDevices] = {};
  static std::mutex mu;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(mu);
  if (pools[dev] == nullptr) {
    cudaMemPoolProps props = {};
    props.allocType = cudaMemAllocationTypePinned;
    props.location.type = cudaMemLocationTypeDevice;
    props.location.id = dev;
    cudaMemPool_t created;
    err = cudaMemPoolCreate(&created, &props);
    if (err != cudaSuccess) return err;
    unsigned long long keep = ~0ull;
    err = cudaMemPoolSetAttribute(created, cudaMemPoolAttrReleaseThreshold, &keep);
    if (err != cudaSuccess) {
      cudaMemPoolDestroy(created);
      return err;
    }
    pools[dev] = created;
  }
  *pool = pools[dev];
  return cudaSuccess;
}

struct LmGenShape {
  int lanes;
  size_t lane_bytes, smem;
};

template <typename R> inline LmGenShape lm_gen_shape(int k) {
  LmGenShape sh;
  sh.lane_bytes = LmGenWs<R>::lane_bytes(k);
  sh.lanes = lm_gen_block_lanes<R>(k);
  sh.smem = sh.lanes * sh.lane_bytes;
  return sh;
}

// x0 (L, 6(k+1)), tgt (L, 4, 4) and gates (k, 4, 4), complex interleaved,
// in R -> xout (L, 6(k+1)), fout (L,): the gate lists into stream-ordered
// device memory from lm_gen_pool, then the lanes in depth k's bucket
template <typename R>
cudaError_t lm_gen_launch(const void* x0, const void* tgt, const void* gates, int iters, int k, int L, void* xout,
                          void* fout, void* stream) {
  if (k < 1 || k > kMaxK) return cudaErrorInvalidValue;
  if (L <= 0) return cudaSuccess;
  cudaError_t err = use_device_of(x0);
  if (err != cudaSuccess) return err;
  const LmGenShape sh = lm_gen_shape<R>(k);
  if (sh.smem > kBlockSmemMax) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemPool_t pool;
  err = lm_gen_pool(&pool);
  if (err != cudaSuccess) return err;
  unsigned char* lists = nullptr;
  err = cudaMallocFromPoolAsync(reinterpret_cast<void**>(&lists), lm_gen_gate_bytes<R>(k), pool, st);
  if (err != cudaSuccess) return err;
  auto* G = reinterpret_cast<GateNz<float>*>(lists);
  auto* GR = std::is_same_v<R, double>
                 ? reinterpret_cast<GateNz<R>*>(lists + align16(sizeof(GateNz<float>) * k))
                 : reinterpret_cast<GateNz<R>*>(lists);
  lm_gen_gate_lists_kernel<R><<<(8 * k + 127) / 128, 128, 0, st>>>(static_cast<const R*>(gates), k, G, GR);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    err = lm_gen_by_bucket(k, [&](auto sb) {
      auto* kernel = lm_gen_kernel<R, decltype(sb)::value>;
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
      if (e != cudaSuccess) return e;
      kernel<<<(L + sh.lanes - 1) / sh.lanes, sh.lanes * kLmTeam, sh.smem, st>>>(
          static_cast<const R*>(x0), static_cast<const R*>(tgt), G, GR, iters, k, L, sh.lanes, (int)sh.lane_bytes,
          static_cast<R*>(xout), static_cast<R*>(fout));
      return cudaGetLastError();
    });
  }
  const cudaError_t freed = cudaFreeAsync(lists, st);
  return err != cudaSuccess ? err : freed;
}

// resident blocks per SM of the program at depth k on the current device,
// its threads per block, its dynamic shared memory a block and its lanes a
// block
template <typename R> cudaError_t lm_gen_occupancy(int k, int* blocks, int* threads, int* smem, int* lanes) {
  if (k < 1 || k > kMaxK) return cudaErrorInvalidValue;
  const LmGenShape sh = lm_gen_shape<R>(k);
  *threads = sh.lanes * kLmTeam;
  *smem = (int)sh.smem;
  *lanes = sh.lanes;
  return lm_gen_by_bucket(k, [&](auto sb) {
    auto* kernel = lm_gen_kernel<R, decltype(sb)::value>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, *threads, sh.smem);
  });
}
#endif

}  // namespace slam

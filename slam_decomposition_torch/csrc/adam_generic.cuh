// The fused Adam warm start for one lane of a chain of any depth K (a
// runtime argument), run by a team of 16 threads (half a warp) over a
// per-lane workspace in shared memory laid out for K at launch. The kernel
// (adam_chain_generic.cu) and the host build (host_lanes.cpp) run this same
// program.
//
// The math is adam_team.cuh's: each step the gradient of the square cost
// 1 - (|t|^2 + 4)/20, t = tr(T^dag U(x)), from the prefix products P_i
// (P_0 = I, P_{i+1} = G_i L_i P_i) and the suffix products seen from the
// target X_i (X_K = T^dag, X_{i-1} = X_i L_i G_{i-1}): with W_i = P_i X_i,
// dt/dx_p = sum_ab W_i[b][a] dL_i[a][b] for the parameters p of layer i;
// then Adam with the step's [1/bias1, 1/bias2, lr] row.
//
// How the team splits it. adam_team.cuh gives each of 4 threads a column
// of every P_i and a row of every X_i, so a layer is a serial chain of 4x4
// products on each thread and its gradient a butterfly sum. Here the 16
// threads hold the 16 entries of the 4x4 being built:
//  - forward: thread 4r + c holds P_i[r][c]. A layer is two exchanges
//    through shared memory: V = L_i P_i, whose entry (r, c) the thread
//    computes as kron_col computes w[r] from column c of P_i, then P_{i+1}
//    = G_i V, gate_col's row r on column c of V (the gate from device
//    memory). So every P_i, and U, is adam_team.cuh's to the bit where the
//    compiler fuses the same multiply-adds.
//  - reverse: thread t holds X_i[t & 3][t >> 2]: Y = X_i L_i (kron_row's
//    entry) and X_{i-1} = Y G_{i-1} (gate_row's), the same way; and the
//    entry W_i[t >> 2][t & 3] = sum_c P_i[t >> 2][c] X_i[c][t & 3], which
//    replaces P_i in its slot once the layer is done (W needs no slot of
//    its own). The trace sums each column's terms over its rows, then the
//    columns (0 + 2) + (1 + 3), adam_team.cuh's order.
//  - gradient and update: layer i belongs to thread i % 16, which contracts
//    W_i with its two factors' derivatives (adam_team.cuh's CA / CB, from
//    W in one piece rather than a sum of 4 threads' rank-1 terms), so no
//    sum crosses threads, and applies Adam to the layer's six parameters.
//    Their x, m and v never leave the thread's registers: slot l holds
//    layer t + 16 l, in arrays of a compile-time layer bucket LB
//    (adam_gen_bucket: 1..5 layers a thread, K <= 15, 31, 47, 63, 79)
//    whose loops skip the layers past K. The same thread computes its
//    layers' sines and cosines for the next step.
// A lane's workspace is a record of 192 B a layer (P_i, then W_i, and the
// sines and cosines of the layer's two u3 factors) and 256 B of exchange
// buffers. In a record the
// 16-byte chunks of P / W rotate by the layer (chunk k at (k + i) mod 8,
// the factors' at (k + i) mod 4), so that the 8 threads of a 16-byte load
// phase, each reading its own layer in the update, hit distinct banks; and
// a lane's workspace is padded to 64 B past a multiple of 128 B, so that
// the two teams of a warp read 4-byte words in different banks.

#pragma once

#include <type_traits>

#include "adam_team.cuh"

namespace slam {

constexpr int kAdamGenTeam = 16;
constexpr int kAdamRecFloats = 48;  // a layer's record: P / W (32 floats) and two u3 factors (16)

// The layer bucket of depth K: the layers a thread owns (t, t + 16, ... up
// to K), the count the program is compiled for.
SLAM_HD int adam_gen_bucket(int K) { return (K + kAdamGenTeam) / kAdamGenTeam; }

// The most lanes an SM runs of bucket LB: the register budget. Its
// __launch_bounds__(16 cap, 1) holds a thread's registers to what that many
// lanes leave (an SM's 64 K registers in four partitions of 16 K: 24 warps
// leave 80 a thread, 20 warps 96, 16 warps 128, 12 warps 168). Each cap is
// the largest at which the bucket builds without spills (ptxas on the
// H100's toolkit: 91-95 registers at LB = 1, 119 at 2, 122-127 at 3,
// 148-151 at 4, 161-163 at 5; one more step of cap spilled each).
SLAM_HD constexpr int adam_gen_lanes_cap(int LB) { return LB <= 1 ? 40 : LB <= 3 ? 32 : 24; }

// f(std::integral_constant<int, LB>{}) for depth K's bucket
template <class F> inline auto adam_gen_by_bucket(int K, F&& f) {
  switch (adam_gen_bucket(K)) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return f(std::integral_constant<int, 5>{});
  }
}

// The lane workspace for depth K, laid out from base (16-byte aligned).
struct AdamGenWs {
  int K, N;
  float* rec;    // record i at rec + 48 i: P_i (column-major, entry 4 c + r), then W_i (row-major, 4 r + s), in 8
                 // rotated chunks of two complex; then the u3 factors 2i, 2i + 1 in 4 rotated chunks
  C<float>* ex;  // exchange: forward V = L_i P_i and the trace's terms; reverse Y = X_i L_i and X_i
  size_t bytes;

  SLAM_HD AdamGenWs(unsigned char* base, int K_) : K(K_), N(6 * (K_ + 1)) {
    Carve c{base, 0};
    rec = c.take<float>(kAdamRecFloats * (K + 1));
    ex = c.take<C<float>>(32);
    bytes = (c.off + 63) / 128 * 128 + 64;
  }
  static SLAM_HD size_t lane_bytes(int K) { return AdamGenWs(nullptr, K).bytes; }

  // entry e of P_i / W_i
  SLAM_HD C<float>* pw(int i, int e) const {
    return reinterpret_cast<C<float>*>(rec + kAdamRecFloats * i + 4 * (((e >> 1) + i) & 7)) + (e & 1);
  }
  // chunk k (0..3) of layer i's u3 factors: factor k >> 1, its half k & 1
  SLAM_HD float* trig_chunk(int i, int k) const { return rec + kAdamRecFloats * i + 32 + 4 * ((k + i) & 3); }
};

// Lanes a block for lane workspaces of lane_bytes when registers hold at
// most cap lanes an SM: the fewest that put the most lanes on an SM (228 KB,
// 1 KB reserved a block, at most 227 KB a block), in whole warps (a team is
// half a warp: its sums shuffle within the warp), at least one warp.
SLAM_HD int adam_gen_lanes(size_t lane_bytes, int cap) {
  constexpr int unit = 32 / kAdamGenTeam;
  int best = unit, most = 0;
  for (int l = unit; l <= cap && l * lane_bytes <= kBlockSmemMax; l += unit) {
    const int by_smem = (int)(kSmemPerSm / (l * lane_bytes + kSmemReservedPerBlock));
    const int blocks = by_smem < cap / l ? by_smem : cap / l;
    if (l * blocks > most) {
      best = l;
      most = l * blocks;
    }
  }
  return best;
}

SLAM_HD int adam_gen_block_lanes(int K) {
  return adam_gen_lanes(AdamGenWs::lane_bytes(K), adam_gen_lanes_cap(adam_gen_bucket(K)));
}

template <int LB> struct AdamGenThread {
  float x[LB][6], m[LB][6], v[LB][6];  // parameters and Adam state of layer t + 16 l, slot l
  C<float> T;   // T[t >> 2][t & 3]
  C<float> tr;  // tr(T^dag U) (uniform)
  C<float> e;   // this thread's entry of V = L_i P_i (U at the forward chain's end)
  C<float> w;   // W_i[t >> 2][t & 3], until slot i is read no more
};

// ------------------------------------------------------------ shared memory

// one complex as one 8-byte access
SLAM_HD C<float> ld_c(const C<float>* p) {
#if defined(__CUDA_ARCH__)
  const float2 v = *reinterpret_cast<const float2*>(p);
  return cmk(v.x, v.y);
#else
  return *p;
#endif
}
SLAM_HD void st_c(C<float>* p, C<float> z) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<float2*>(p) = make_float2(z.re, z.im);
#else
  *p = z;
#endif
}

// two complex from a 16-byte chunk
SLAM_HD void load2c(const float* p, C<float>* z) {
  const F4 a = f4(p);
  z[0] = cmk(a.v[0], a.v[1]);
  z[1] = cmk(a.v[2], a.v[3]);
}

// 4 complex from 16-byte aligned shared memory, as two 16-byte loads
SLAM_HD void load4c(const C<float>* p, C<float>* z) {
  load2c(&p[0].re, z);
  load2c(&p[2].re, z + 2);
}

// column c of P_i: entries 4c..4c+3, chunks 2c and 2c + 1
SLAM_HD void load_pcol(const AdamGenWs& ws, int i, int c, C<float>* z) {
  load2c(&ws.pw(i, 4 * c)->re, z);
  load2c(&ws.pw(i, 4 * c + 2)->re, z + 2);
}

// u3 factor h (0, 1) of layer i
SLAM_HD Trig<float> load_trig(const AdamGenWs& ws, int i, int h) {
  const F4 a = f4(ws.trig_chunk(i, 2 * h)), b = f4(ws.trig_chunk(i, 2 * h + 1));
  Trig<float> g;
  g.c = a.v[0]; g.s = a.v[1]; g.cp = a.v[2]; g.sp = a.v[3];
  g.cl = b.v[0]; g.sl = b.v[1]; g.cpl = b.v[2]; g.spl = b.v[3];
  return g;
}

SLAM_HD void store_trig(const AdamGenWs& ws, int i, int h, const Trig<float>& g) {
  F4 a, b;
  a.v[0] = g.c; a.v[1] = g.s; a.v[2] = g.cp; a.v[3] = g.sp;
  b.v[0] = g.cl; b.v[1] = g.sl; b.v[2] = g.cpl; b.v[3] = g.spl;
  *reinterpret_cast<F4*>(ws.trig_chunk(i, 2 * h)) = a;
  *reinterpret_cast<F4*>(ws.trig_chunk(i, 2 * h + 1)) = b;
}

// entry (row, col) of gate i of the launch's gates (K, 4, 4) complex
// interleaved (8-byte aligned), through the read-only path on the card
SLAM_HD C<float> gate_at(const float* __restrict__ gates, int i, int row, int col) {
  const float* e = gates + 32 * i + 8 * row + 2 * col;
#if defined(__CUDA_ARCH__)
  const float2 v = __ldg(reinterpret_cast<const float2*>(e));
  return cmk(v.x, v.y);
#else
  return cmk(e[0], e[1]);
#endif
}

// acc += g v as four multiply-adds: where a part of g is zero its two
// terms add an exact zero, so this is cmac_kind on g's kind (gate_col /
// gate_row) without a branch
SLAM_HD void cmac_dense(C<float>& acc, C<float> g, C<float> v) {
  acc.re += g.re * v.re;
  acc.re -= g.im * v.im;
  acc.im += g.re * v.im;
  acc.im += g.im * v.re;
}

// column col (u[0] = U[0][col], u[1] = U[1][col]) and row row of the u3
// built from g (u3_build's entries)
SLAM_HD void u3_col(const Trig<float>& g, int col, C<float>* u) {
  u[0] = col == 0 ? cmk(g.c, 0.f) : cmk(-g.cl * g.s, -g.sl * g.s);
  u[1] = col == 0 ? cmk(g.cp * g.s, g.sp * g.s) : cmk(g.cpl * g.c, g.spl * g.c);
}
SLAM_HD void u3_row(const Trig<float>& g, int row, C<float>* u) {
  u[0] = row == 0 ? cmk(g.c, 0.f) : cmk(g.cp * g.s, g.sp * g.s);
  u[1] = row == 0 ? cmk(-g.cl * g.s, -g.sl * g.s) : cmk(g.cpl * g.c, g.spl * g.c);
}

// ------------------------------------------------------------ the chains

// the sines and cosines of every u3 at the thread's x (each thread its
// layers')
template <int LB, class Team> SLAM_HD void adam_gen_trig(Team& tm, const AdamGenWs& ws) {
  SLAM_EACH(tm, t) {
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int i = t + kAdamGenTeam * l;
      if (i <= ws.K) {
        store_trig(ws, i, 0, u3_trig(tm.th(t).x[l]));
        store_trig(ws, i, 1, u3_trig(tm.th(t).x[l] + 3));
      }
    }
  }
  tm.sync();
}

// The forward chain at the threads' x: the u3 factors, P_0..P_K into their
// slots, thread 4r + c's U[r][c] in th.e; leaves t = tr(T^dag U) in every
// th.tr; ends with a barrier
template <int LB, class Team>
SLAM_HD void adam_gen_forward(Team& tm, const AdamGenWs& ws, const float* __restrict__ gates) {
  const int K = ws.K;
  C<float>* V = ws.ex;       // V[4 c + r], column-major
  C<float>* z = ws.ex + 16;  // the trace's terms
  adam_gen_trig<LB>(tm, ws);
  SLAM_EACH(tm, t) {  // P_0 = I
    const int r = t >> 2, c = t & 3;
    st_c(ws.pw(0, 4 * c + r), cmk(r == c ? 1.f : 0.f, 0.f));
  }
  tm.sync();
#pragma unroll 1
  for (int i = 0;; ++i) {
    SLAM_EACH(tm, t) {  // V[r][c] = sum_b A[r>>1][b] sum_d B[r&1][d] P_i[2b+d][c]
      const int r = t >> 2, c = t & 3;
      C<float> v[4], a[2], b[2];
      load_pcol(ws, i, c, v);
      u3_row(load_trig(ws, i, 0), r >> 1, a);
      u3_row(load_trig(ws, i, 1), r & 1, b);
      const C<float> y0 = cadd(cmul(b[0], v[0]), cmul(b[1], v[1]));
      const C<float> y1 = cadd(cmul(b[0], v[2]), cmul(b[1], v[3]));
      const C<float> w = cadd(cmul(a[0], y0), cmul(a[1], y1));
      tm.th(t).e = w;
      st_c(V + 4 * c + r, w);
    }
    tm.sync();
    if (i == K) break;
    SLAM_EACH(tm, t) {  // P_{i+1}[r][c] = sum_j G_i[r][j] V[j][c]
      const int r = t >> 2, c = t & 3;
      C<float> v[4];
      load4c(V + 4 * c, v);
      C<float> acc = cmk(0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 4; ++j) cmac_dense(acc, gate_at(gates, i, r, j), v[j]);
      st_c(ws.pw(i + 1, 4 * c + r), acc);
    }
    tm.sync();
  }
  SLAM_EACH(tm, t) st_c(z + t, cjmul(tm.th(t).T, tm.th(t).e));
  tm.sync();
  SLAM_EACH(tm, t) {  // adam_team.cuh's order: each column's sum over rows, then (0 + 2) + (1 + 3)
    C<float> col[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      col[c] = ld_c(z + c);
#pragma unroll
      for (int r = 1; r < 4; ++r) col[c] = cadd(col[c], ld_c(z + 4 * r + c));
    }
    tm.th(t).tr = cadd(cadd(col[0], col[2]), cadd(col[1], col[3]));
  }
  tm.sync();
}

// The reverse sweep: X_K = T^dag down to X_0, with W_i = P_i X_i written
// over P_i; ends with a barrier. Thread t holds the entry (a, b) = (t & 3,
// t >> 2) of X and Y and W's (t >> 2, t & 3).
template <int LB, class Team>
SLAM_HD void adam_gen_reverse(Team& tm, const AdamGenWs& ws, const float* __restrict__ gates) {
  const int K = ws.K;
  C<float>* Y = ws.ex;       // Y[4 a + b], row-major
  C<float>* X = ws.ex + 16;  // X_i[4 a + b], row-major
  SLAM_EACH(tm, t) {  // X_K[a][b] = conj(T[b][a])
    const C<float> T = tm.th(t).T;
    st_c(X + 4 * (t & 3) + (t >> 2), cmk(T.re, -T.im));
  }
  tm.sync();
#pragma unroll 1
  for (int i = K; i >= 0; --i) {
    SLAM_EACH(tm, t) {  // W_i[r][s] = sum_c P_i[r][c] X_i[c][s]; Y[a][b] = sum_q A[q][b>>1] sum_p X_i[a][2q+p] B[p][b&1]
      AdamGenThread<LB>& th = tm.th(t);
      const int r = t >> 2, s = t & 3, a = s, b = r;
      C<float> w = cmul(ld_c(ws.pw(i, r)), ld_c(X + s));
#pragma unroll
      for (int c = 1; c < 4; ++c) w = cadd(w, cmul(ld_c(ws.pw(i, 4 * c + r)), ld_c(X + 4 * c + s)));
      th.w = w;
      if (i > 0) {
        C<float> u[4], ca[2], cb[2];
        load4c(X + 4 * a, u);
        u3_col(load_trig(ws, i, 0), b >> 1, ca);
        u3_col(load_trig(ws, i, 1), b & 1, cb);
        const C<float> y0 = cadd(cmul(u[0], cb[0]), cmul(u[1], cb[1]));
        const C<float> y1 = cadd(cmul(u[2], cb[0]), cmul(u[3], cb[1]));
        st_c(Y + 4 * a + b, cadd(cmul(ca[0], y0), cmul(ca[1], y1)));
      }
    }
    tm.sync();
    SLAM_EACH(tm, t) {  // W_i into slot i; X_{i-1}[a][b] = sum_j Y[a][j] G_{i-1}[j][b]
      const int r = t >> 2, s = t & 3, a = s, b = r;
      st_c(ws.pw(i, 4 * r + s), tm.th(t).w);
      if (i > 0) {
        C<float> u[4];
        load4c(Y + 4 * a, u);
        C<float> acc = cmk(0.f, 0.f);
#pragma unroll
        for (int j = 0; j < 4; ++j) cmac_dense(acc, gate_at(gates, i - 1, j, b), u[j]);
        st_c(X + 4 * a + b, acc);
      }
    }
    tm.sync();
  }
}

// Adam on the three parameters of one u3 from the derivatives of the
// layer's contraction C (adam_team.cuh's CA or CB) with its factor g
SLAM_HD void adam_gen_step3(const Trig<float>& g, const M2<float>& Cm, C<float> tr, float s0, float s1, float s2,
                            float* x, float* m, float* v) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    M2<float> d;
    u3_deriv(g, j, d);
    C<float> sd = cmul(d.e[0], Cm.e[0]);
#pragma unroll
    for (int e = 1; e < 4; ++e) sd = cadd(sd, cmul(d.e[e], Cm.e[e]));
    // d/dx (1 - (|t|^2 + 4)/20) = -(2/20) Re(conj(t) dt)
    const float gr = -0.1f * (tr.re * sd.re + tr.im * sd.im);
    m[j] = 0.9f * m[j] + 0.1f * gr;
    v[j] = 0.999f * v[j] + 0.001f * (gr * gr);
    const float mhat = m[j] * s0;
    const float vhat = v[j] * s1;
    x[j] = x[j] - s2 * mhat / (sqrtf(vhat) + 1e-8f);
  }
}

// The gradient of each layer's six parameters from W_i and its two
// factors, and Adam on them with schedule row sch; ends with a barrier
template <int LB, class Team>
SLAM_HD void adam_gen_update(Team& tm, const AdamGenWs& ws, const float* __restrict__ sch) {
  const float s0 = sch[0], s1 = sch[1], s2 = sch[2];
  SLAM_EACH(tm, t) {
    AdamGenThread<LB>& th = tm.th(t);
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int i = t + kAdamGenTeam * l;
      if (i <= ws.K) {
        const Trig<float> ta = load_trig(ws, i, 0), tb = load_trig(ws, i, 1);
        M2<float> A, B, Cm;
        u3_build(tb, B, (M2<float>*)nullptr);
        // CA[u][v] = sum_pq W[2v+q][2u+p] B[p][q]: rows 2v and 2v + 1 at columns 2u, 2u + 1, two chunks
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            C<float> r0[2], r1[2];
            load2c(&ws.pw(i, 8 * v + 2 * u)->re, r0);
            load2c(&ws.pw(i, 8 * v + 4 + 2 * u)->re, r1);
            C<float> acc = cmul(r0[0], B.e[0]);
            acc = cadd(acc, cmul(r1[0], B.e[1]));
            acc = cadd(acc, cmul(r0[1], B.e[2]));
            acc = cadd(acc, cmul(r1[1], B.e[3]));
            Cm.e[2 * u + v] = acc;
          }
        adam_gen_step3(ta, Cm, th.tr, s0, s1, s2, th.x[l], th.m[l], th.v[l]);
        u3_build(ta, A, (M2<float>*)nullptr);
        // CB[u][v] = sum_pq W[2q+v][2p+u] A[p][q]
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            C<float> acc = cmul(ld_c(ws.pw(i, 4 * v + u)), A.e[0]);
            acc = cadd(acc, cmul(ld_c(ws.pw(i, 4 * (2 + v) + u)), A.e[1]));
            acc = cadd(acc, cmul(ld_c(ws.pw(i, 4 * v + 2 + u)), A.e[2]));
            acc = cadd(acc, cmul(ld_c(ws.pw(i, 4 * (2 + v) + 2 + u)), A.e[3]));
            Cm.e[2 * u + v] = acc;
          }
        adam_gen_step3(tb, Cm, th.tr, s0, s1, s2, th.x[l] + 3, th.m[l] + 3, th.v[l] + 3);
      }
    }
  }
  tm.sync();
}

// One lane from the raw arrays: load x0 and the target, run iters steps,
// store (only where `store`: a team past the last lane repeats lane L-1);
// with Cost, the forward chain runs once more, at the final x, for its
// square cost (the same code as a step's, so the instance with the cost
// keeps the registers of the one without)
template <int LB, bool Cost, class Team>
SLAM_HD void adam_gen_team_io(Team& tm, const AdamGenWs& ws, const float* __restrict__ gates,
                              const float* __restrict__ x0, const float* __restrict__ tgt,
                              const float* __restrict__ sched, int iters, int lane, bool store,
                              float* __restrict__ xout, float* __restrict__ fout) {
  const int N = ws.N;
  SLAM_EACH(tm, t) {
    AdamGenThread<LB>& th = tm.th(t);
    th.T = cmk(tgt[32 * (size_t)lane + 2 * t], tgt[32 * (size_t)lane + 2 * t + 1]);
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int i = t + kAdamGenTeam * l;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        th.x[l][j] = 0.f;
        if (i <= ws.K) th.x[l][j] = x0[(size_t)lane * N + 6 * i + j];
        th.m[l][j] = 0.f;
        th.v[l][j] = 0.f;
      }
    }
  }
#pragma unroll 1
  for (int it = 0;; ++it) {
    if (!Cost && it == iters) break;
    adam_gen_forward<LB>(tm, ws, gates);
    if (it == iters) break;
    adam_gen_reverse<LB>(tm, ws, gates);
    adam_gen_update<LB>(tm, ws, sched + 3 * it);
  }
  SLAM_EACH(tm, t) {
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int i = t + kAdamGenTeam * l;
      if (store && i <= ws.K) {
#pragma unroll
        for (int j = 0; j < 6; ++j) xout[(size_t)lane * N + 6 * i + j] = tm.th(t).x[l][j];
      }
    }
    if (Cost && store && t == 0) {
      const C<float> tr = tm.th(t).tr;
      fout[lane] = 1.f - (tr.re * tr.re + tr.im * tr.im + 4.f) / 20.f;
    }
  }
}

#if defined(__CUDACC__)
// ------------------------------------------------------------ kernels

// `lanes` lanes a block, team w (half a warp) on lane blockIdx.x * lanes + w,
// each on its workspace of lane_bytes in the block's dynamic shared memory
template <int LB, bool Cost>
__global__ void __launch_bounds__(kAdamGenTeam * adam_gen_lanes_cap(LB), 1)
    adam_gen_kernel(const float* __restrict__ x0, const float* __restrict__ tgt, const float* __restrict__ gates,
                    const float* __restrict__ sched, int iters, int K, int L, int lanes, int lane_bytes,
                    float* __restrict__ xout, float* __restrict__ fout) {
  extern __shared__ __align__(16) unsigned char adam_gen_smem[];
  const int w = threadIdx.x / kAdamGenTeam;
  const int lane = blockIdx.x * lanes + w;
  const AdamGenWs ws(adam_gen_smem + (size_t)w * lane_bytes, K);
  DevTeam<kAdamGenTeam, AdamGenThread<LB>> tm(threadIdx.x % kAdamGenTeam);
  adam_gen_team_io<LB, Cost>(tm, ws, gates, x0, tgt, sched, iters, lane < L ? lane : L - 1, lane < L, xout, fout);
}

struct AdamGenShape {
  int lanes;
  size_t lane_bytes, smem;
};

inline AdamGenShape adam_gen_shape(int k) {
  AdamGenShape sh;
  sh.lane_bytes = AdamGenWs::lane_bytes(k);
  sh.lanes = adam_gen_block_lanes(k);
  sh.smem = sh.lanes * sh.lane_bytes;
  return sh;
}

template <int LB> inline auto* adam_gen_kernel_of(bool cost) {
  return cost ? adam_gen_kernel<LB, true> : adam_gen_kernel<LB, false>;
}
#endif

}  // namespace slam

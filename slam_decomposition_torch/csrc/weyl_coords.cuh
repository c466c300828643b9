// The magic-basis eigenphases of one 2Q unitary (ops/weyl.py
// gamma_eigenphases_ref), as host and device code: the kernel
// (weyl_coords.cu) runs it one target a thread, host_lanes.cpp on the host
// for the CPU tests.
//
// The same mathematics in the same precision (f64) as the plain chain:
// det U by weyl.det4's Laplace expansion, U_s = det^(-1/4) U on the
// principal branch (weyl.su4_normalize), M = B^dag U_s B, m = M^T M, then
// ops/eig.joint_diag's 12 fixed sweeps of Cardoso-Souloumiac rotations over
// the pivots (0,1), (0,2), (0,3), (1,2), (1,3), (2,3) on X = Re m and
// Y = Im m, and atan2(diag Y, diag X). Only the diagonals are read, so the
// rotations are not accumulated. M is formed as 2 B^dag U_s B: B's entries
// are 0 and +-1/sqrt2 (some times i), so the products are sums and
// differences of U's entries, and the factor 2 (4 on m) is exact and leaves
// every angle and phase as it was (atan2 and the rotation angle read ratios).
// X and Y are symmetric: their upper triangles, 10 doubles each, stay in
// registers.

#pragma once

#include "chain_common.cuh"

namespace slam_weyl {

using Z = slam::C<double>;

constexpr int kSweeps = 12;  // ops/eig.joint_diag's default

SLAM_HD Z zsub(Z a, Z b) { return slam::cmk(a.re - b.re, a.im - b.im); }
SLAM_HD Z zmi(Z a) { return slam::cmk(a.im, -a.re); }  // -i a
SLAM_HD Z zi(Z a) { return slam::cmk(-a.im, a.re); }   // i a

// entry (p, q) of a symmetric 4x4 matrix kept as its upper triangle, row by row
SLAM_HD constexpr int sym(int p, int q) { return p <= q ? p * (7 - p) / 2 + q : q * (7 - q) / 2 + p; }

SLAM_HD Z minor2(const Z* u, int r0, int r1, int c0, int c1) {
  return zsub(slam::cmul(u[4 * r0 + c0], u[4 * r1 + c1]), slam::cmul(u[4 * r0 + c1], u[4 * r1 + c0]));
}

// minor(rows 0, 1; c0, c1) * minor(rows 2, 3; c2, c3)
SLAM_HD Z det_term(const Z* u, int c0, int c1, int c2, int c3) {
  return slam::cmul(minor2(u, 0, 1, c0, c1), minor2(u, 2, 3, c2, c3));
}

// weyl.det4: the 2x2 minors of the first two rows times their complements,
// the column pairs in itertools.combinations' order, each term with the
// sign of its permutation
SLAM_HD Z det4(const Z* u) {
  Z d = det_term(u, 0, 1, 2, 3);
  d = zsub(d, det_term(u, 0, 2, 1, 3));
  d = slam::cadd(d, det_term(u, 0, 3, 1, 2));
  d = slam::cadd(d, det_term(u, 1, 2, 0, 3));
  d = zsub(d, det_term(u, 1, 3, 0, 2));
  return slam::cadd(d, det_term(u, 2, 3, 0, 1));
}

// column c of 2 B^dag W into u's column c, from column c of W = 2^(1/2) U_s B
SLAM_HD void magic_col(const Z* w, Z* u, int c) {
  u[c] = slam::cadd(w[0], w[3]);
  u[4 + c] = zmi(slam::cadd(w[1], w[2]));
  u[8 + c] = zsub(w[1], w[2]);
  u[12 + c] = zmi(zsub(w[0], w[3]));
}

// A <- G A G^T on the pivot (P, Q), G = [[c, s], [-s, c]] there: the two
// other rows R0, R1 by the column step, the 2x2 block by ops/eig's row step
// then column step
template <int P, int Q> SLAM_HD void rotate(double* A, double c, double s) {
  constexpr int R0 = (P != 0 && Q != 0) ? 0 : (P != 1 && Q != 1) ? 1 : 2;
  constexpr int R1 = 6 - P - Q - R0;
  constexpr int rp0 = sym(R0, P), rq0 = sym(R0, Q), rp1 = sym(R1, P), rq1 = sym(R1, Q);
  constexpr int pp = sym(P, P), pq = sym(P, Q), qq = sym(Q, Q);
  const double a0 = A[rp0], b0 = A[rq0], a1 = A[rp1], b1 = A[rq1];
  A[rp0] = a0 * c + b0 * s;
  A[rq0] = -a0 * s + b0 * c;
  A[rp1] = a1 * c + b1 * s;
  A[rq1] = -a1 * s + b1 * c;
  const double app = A[pp], apq = A[pq], aqq = A[qq];
  const double rpp = app * c + apq * s, rpq = apq * c + aqq * s;    // row P after the row step
  const double rqp = -app * s + apq * c, rqq = -apq * s + aqq * c;  // row Q
  A[pp] = rpp * c + rpq * s;
  A[qq] = -rqp * s + rqq * c;
  A[pq] = -rpp * s + rpq * c;
}

// one joint rotation (ops/eig._joint_angle, then both matrices rotated)
template <int P, int Q> SLAM_HD void pivot(double* X, double* Y) {
  constexpr int pp = sym(P, P), pq = sym(P, Q), qq = sym(Q, Q);
  const double ux = X[pq], vx = 0.5 * (X[pp] - X[qq]);
  const double uy = Y[pq], vy = 0.5 * (Y[pp] - Y[qq]);
  const double num = 2.0 * (ux * vx + uy * vy);
  const double den = vx * vx + vy * vy - ux * ux - uy * uy;
  double s, c;
  slam::sincos_(0.25 * atan2(num, den), &s, &c);
  rotate<P, Q>(X, c, s);
  rotate<P, Q>(Y, c, s);
}

// u: U's 16 entries, row-major; overwritten with 2 M. out: the 4 phases.
SLAM_HD void gamma_eigenphases(Z* u, double* out) {
  const Z det = det4(u);
  const double phase = atan2(det.im, det.re) / 4.0;
  const double mag = pow(det.re * det.re + det.im * det.im, -0.125);
  double sn, cs;
  slam::sincos_(-phase, &sn, &cs);
  const Z sc = slam::cmk(mag * cs, mag * sn);
  // M's columns 0 and 3 read U's columns 0 and 3 alone, 1 and 2 read 1 and 2
  Z w0[4], w1[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const Z a = slam::cmul(u[4 * r], sc), b = slam::cmul(u[4 * r + 3], sc);
    w0[r] = slam::cadd(a, b);
    w1[r] = zi(zsub(a, b));
  }
  magic_col(w0, u, 0);
  magic_col(w1, u, 3);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const Z a = slam::cmul(u[4 * r + 1], sc), b = slam::cmul(u[4 * r + 2], sc);
    w0[r] = zi(slam::cadd(a, b));
    w1[r] = zsub(a, b);
  }
  magic_col(w0, u, 1);
  magic_col(w1, u, 2);
  double X[10], Y[10];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = a; b < 4; ++b) {
      Z acc = slam::cmul(u[a], u[b]);
#pragma unroll
      for (int k = 1; k < 4; ++k) acc = slam::cadd(acc, slam::cmul(u[4 * k + a], u[4 * k + b]));
      X[sym(a, b)] = acc.re;
      Y[sym(a, b)] = acc.im;
    }
#pragma unroll 1
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    pivot<0, 1>(X, Y);
    pivot<0, 2>(X, Y);
    pivot<0, 3>(X, Y);
    pivot<1, 2>(X, Y);
    pivot<1, 3>(X, Y);
    pivot<2, 3>(X, Y);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = atan2(Y[sym(k, k)], X[sym(k, k)]);
}

}  // namespace slam_weyl

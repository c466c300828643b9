// Exact-rational polytope kernels: simplex LP, redundancy elimination.
// The host core of the coverage engine (coverage/polytope.py lp_max and
// ConvexPolytope.reduce), a copy of the JAX package's
// native/polytope_core.cpp; coverage/native.py builds it with g++ at first
// use and loads it with ctypes.
//
// Rational arithmetic over int64 numerator/denominator with __int128
// intermediates and gcd normalization; overflow returns an error code so the
// Python caller falls back to arbitrary-precision Fractions, which give the
// same exact answer.
//
// C ABI (ctypes): rows are flat arrays of (num, den) int64 pairs, row-major,
// each row = [d, c1, ..., cn].

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

using i64 = int64_t;
using i128 = __int128;

struct RatOverflow {};

static i64 gcd64(i64 a, i64 b) {
    if (a < 0) a = -a;
    if (b < 0) b = -b;
    while (b) { i64 t = a % b; a = b; b = t; }
    return a;
}

struct Rat {
    i64 n, d;  // d > 0 always
    Rat() : n(0), d(1) {}
    Rat(i64 nn, i64 dd) { set(nn, dd); }
    void set(i64 nn, i64 dd) {
        if (dd == 0) throw RatOverflow{};
        if (dd < 0) { nn = -nn; dd = -dd; }
        i64 g = gcd64(nn, dd);
        if (g > 1) { nn /= g; dd /= g; }
        n = nn; d = dd;
    }
    static Rat from128(i128 nn, i128 dd) {
        if (dd == 0) throw RatOverflow{};
        if (dd < 0) { nn = -nn; dd = -dd; }
        // reduce in 128-bit first
        i128 a = nn < 0 ? -nn : nn, b = dd;
        while (b) { i128 t = a % b; a = b; b = t; }
        if (a > 1) { nn /= a; dd /= a; }
        if (nn > INT64_MAX || nn < INT64_MIN || dd > INT64_MAX) throw RatOverflow{};
        Rat r; r.n = (i64)nn; r.d = (i64)dd; return r;
    }
    bool is_zero() const { return n == 0; }
};

static Rat add(const Rat& a, const Rat& b) {
    return Rat::from128((i128)a.n * b.d + (i128)b.n * a.d, (i128)a.d * b.d);
}
static Rat sub(const Rat& a, const Rat& b) {
    return Rat::from128((i128)a.n * b.d - (i128)b.n * a.d, (i128)a.d * b.d);
}
static Rat mul(const Rat& a, const Rat& b) {
    return Rat::from128((i128)a.n * b.n, (i128)a.d * b.d);
}
static Rat div(const Rat& a, const Rat& b) {
    if (b.n == 0) throw RatOverflow{};
    return Rat::from128((i128)a.n * b.d, (i128)a.d * b.n);
}
static Rat neg(const Rat& a) { Rat r; r.n = -a.n; r.d = a.d; return r; }
static int cmp(const Rat& a, const Rat& b) {
    i128 lhs = (i128)a.n * b.d, rhs = (i128)b.n * a.d;
    return lhs < rhs ? -1 : (lhs > rhs ? 1 : 0);
}
static int sgn(const Rat& a) { return a.n < 0 ? -1 : (a.n > 0 ? 1 : 0); }

using Row = std::vector<Rat>;

// ---------------------------------------------------------------- simplex
// Maximize c.x s.t. rows d + a.x >= 0 (+ equality rows). Returns status:
// 0 optimal (val out), 1 unbounded, 2 infeasible.

struct Tableau {
    int m, ncols;
    std::vector<Row> T;   // m rows, each ncols+1
    std::vector<int> basis;
};

static void pivot(Tableau& tb, int r, int c) {
    Rat piv = tb.T[r][c];
    for (auto& v : tb.T[r]) v = div(v, piv);
    for (int i = 0; i < tb.m; i++) {
        if (i == r || tb.T[i][c].is_zero()) continue;
        Rat f = tb.T[i][c];
        for (int j = 0; j <= tb.ncols; j++)
            tb.T[i][j] = sub(tb.T[i][j], mul(f, tb.T[r][j]));
    }
    tb.basis[r] = c;
}

static int simplex_core(Tableau& tb, std::vector<Rat>& cost, Rat* val) {
    std::vector<Rat> z = cost;  // reduced costs, length ncols+1
    for (int i = 0; i < tb.m; i++) {
        Rat cb = cost[tb.basis[i]];
        if (cb.is_zero()) continue;
        for (int j = 0; j <= tb.ncols; j++)
            z[j] = sub(z[j], mul(cb, tb.T[i][j]));
    }
    for (long iter = 0; iter < 100000; iter++) {
        int e = -1;
        for (int j = 0; j < tb.ncols; j++)
            if (sgn(z[j]) > 0) { e = j; break; }  // Bland
        if (e == -1) { *val = neg(z[tb.ncols]); return 0; }
        int r = -1;
        Rat best;
        for (int i = 0; i < tb.m; i++) {
            if (sgn(tb.T[i][e]) > 0) {
                Rat ratio = div(tb.T[i][tb.ncols], tb.T[i][e]);
                if (r == -1 || cmp(ratio, best) < 0 ||
                    (cmp(ratio, best) == 0 && tb.basis[i] < tb.basis[r])) {
                    best = ratio; r = i;
                }
            }
        }
        if (r == -1) return 1;  // unbounded
        pivot(tb, r, e);
        Rat cb = z[e];
        if (!cb.is_zero())
            for (int j = 0; j <= tb.ncols; j++)
                z[j] = sub(z[j], mul(cb, tb.T[r][j]));
    }
    throw RatOverflow{};  // iteration blowup -> let caller fall back
}

// Build phase-1 feasible tableau for rows -a.x <= d (from d + a.x >= 0).
static int lp_max(const std::vector<Row>& ineqs, const std::vector<Row>& eqs,
                  const std::vector<Rat>& objective, int n, Rat* val) {
    std::vector<Row> A;
    std::vector<Rat> b;
    for (auto& r : ineqs) {
        Row a(n);
        for (int j = 0; j < n; j++) a[j] = neg(r[j + 1]);
        A.push_back(a); b.push_back(r[0]);
    }
    for (auto& r : eqs) {
        Row a1(n), a2(n);
        for (int j = 0; j < n; j++) { a1[j] = neg(r[j + 1]); a2[j] = r[j + 1]; }
        A.push_back(a1); b.push_back(r[0]);
        A.push_back(a2); b.push_back(neg(r[0]));
    }
    int m = (int)A.size();
    if (m == 0) {
        bool zero = true;
        for (auto& c : objective) if (!c.is_zero()) zero = false;
        if (zero) { *val = Rat(); return 0; }
        return 1;
    }
    bool has_neg = false;
    for (auto& bi : b) if (sgn(bi) < 0) has_neg = true;

    Tableau tb;
    if (!has_neg) {
        tb.m = m; tb.ncols = 2 * n + m;
        tb.T.assign(m, Row(tb.ncols + 1));
        tb.basis.resize(m);
        for (int i = 0; i < m; i++) {
            for (int j = 0; j < n; j++) {
                tb.T[i][j] = A[i][j];
                tb.T[i][n + j] = neg(A[i][j]);
            }
            tb.T[i][2 * n + i] = Rat(1, 1);
            tb.T[i][tb.ncols] = b[i];
            tb.basis[i] = 2 * n + i;
        }
    } else {
        // phase 1 with artificials
        int ncols = 2 * n + m + m;
        tb.m = m; tb.ncols = ncols;
        tb.T.assign(m, Row(ncols + 1));
        tb.basis.resize(m);
        for (int i = 0; i < m; i++) {
            int s = sgn(b[i]) < 0 ? -1 : 1;
            for (int j = 0; j < n; j++) {
                Rat v = A[i][j];
                if (s < 0) v = neg(v);
                tb.T[i][j] = v;
                tb.T[i][n + j] = neg(v);
            }
            tb.T[i][2 * n + i] = Rat(s, 1);
            tb.T[i][2 * n + m + i] = Rat(1, 1);
            tb.T[i][ncols] = s < 0 ? neg(b[i]) : b[i];
            tb.basis[i] = 2 * n + m + i;
        }
        std::vector<Rat> cost1(ncols + 1);
        for (int i = 0; i < m; i++) cost1[2 * n + m + i] = Rat(-1, 1);
        Rat v1;
        int st = simplex_core(tb, cost1, &v1);
        if (st != 0 || !v1.is_zero()) return 2;  // infeasible
        // drive artificials out
        for (int i = 0; i < m; i++) {
            if (tb.basis[i] >= 2 * n + m) {
                for (int j = 0; j < 2 * n + m; j++)
                    if (!tb.T[i][j].is_zero()) { pivot(tb, i, j); break; }
            }
        }
        // drop artificial columns and dead rows
        std::vector<Row> T2; std::vector<int> basis2;
        for (int i = 0; i < m; i++) {
            if (tb.basis[i] >= 2 * n + m) continue;
            Row row(2 * n + m + 1);
            for (int j = 0; j < 2 * n + m; j++) row[j] = tb.T[i][j];
            row[2 * n + m] = tb.T[i][ncols];
            T2.push_back(row); basis2.push_back(tb.basis[i]);
        }
        tb.T = T2; tb.basis = basis2; tb.m = (int)T2.size(); tb.ncols = 2 * n + m;
    }
    std::vector<Rat> cost(tb.ncols + 1);
    for (int j = 0; j < n; j++) {
        cost[j] = objective[j];
        cost[n + j] = neg(objective[j]);
    }
    return simplex_core(tb, cost, val);
}

// parse/emit flat (num, den) arrays
static std::vector<Row> parse_rows(const i64* data, int nrows, int width) {
    std::vector<Row> rows(nrows, Row(width));
    for (int i = 0; i < nrows; i++)
        for (int j = 0; j < width; j++)
            rows[i][j] = Rat(data[2 * (i * width + j)], data[2 * (i * width + j) + 1]);
    return rows;
}

}  // namespace

extern "C" {

// status: 0 optimal, 1 unbounded, 2 infeasible, -1 overflow/fallback
int slam_lp_max(const i64* ineqs, int n_ineqs, const i64* eqs, int n_eqs,
                const i64* objective, int n_vars, i64* out_num, i64* out_den) {
    try {
        auto I = parse_rows(ineqs, n_ineqs, n_vars + 1);
        auto E = parse_rows(eqs, n_eqs, n_vars + 1);
        std::vector<Rat> obj(n_vars);
        for (int j = 0; j < n_vars; j++)
            obj[j] = Rat(objective[2 * j], objective[2 * j + 1]);
        Rat val;
        int st = lp_max(I, E, obj, n_vars, &val);
        if (st == 0) { *out_num = val.n; *out_den = val.d; }
        return st;
    } catch (RatOverflow&) {
        return -1;
    } catch (...) {
        return -1;
    }
}

// Redundancy elimination: keep[i]=1 if row i is non-redundant. Implied
// equalities: eq_flag[i]=1 if max(d + a.x) == 0 over the system.
// Returns 0 ok, -1 fallback.
int slam_reduce(const i64* ineqs, int n_ineqs, const i64* eqs, int n_eqs,
                int n_vars, unsigned char* keep, unsigned char* eq_flag) {
    try {
        auto I = parse_rows(ineqs, n_ineqs, n_vars + 1);
        auto E = parse_rows(eqs, n_eqs, n_vars + 1);
        // feasibility
        std::vector<Rat> zero(n_vars);
        Rat val;
        int st = lp_max(I, E, zero, n_vars, &val);
        if (st == 2) {
            for (int i = 0; i < n_ineqs; i++) { keep[i] = 0; eq_flag[i] = 0; }
            return 1;  // empty polytope
        }
        // implied equalities
        std::vector<Row> still;
        std::vector<int> still_idx;
        for (int i = 0; i < n_ineqs; i++) {
            std::vector<Rat> obj(n_vars);
            for (int j = 0; j < n_vars; j++) obj[j] = I[i][j + 1];
            st = lp_max(I, E, obj, n_vars, &val);
            if (st == 0 && cmp(add(I[i][0], val), Rat()) == 0) {
                eq_flag[i] = 1; keep[i] = 0;
                E.push_back(I[i]);
            } else {
                eq_flag[i] = 0;
                still.push_back(I[i]);
                still_idx.push_back(i);
            }
        }
        // redundancy
        std::vector<Row> kept;
        for (size_t k = 0; k < still.size(); k++) {
            std::vector<Row> others = kept;
            for (size_t j = k + 1; j < still.size(); j++) others.push_back(still[j]);
            std::vector<Rat> obj(n_vars);
            for (int j = 0; j < n_vars; j++) obj[j] = neg(still[k][j + 1]);
            st = lp_max(others, E, obj, n_vars, &val);
            bool redundant =
                (st == 0 && cmp(sub(still[k][0], val), Rat()) >= 0);
            if (redundant) {
                keep[still_idx[k]] = 0;
            } else {
                keep[still_idx[k]] = 1;
                kept.push_back(still[k]);
            }
        }
        return 0;
    } catch (RatOverflow&) {
        return -1;
    } catch (...) {
        return -1;
    }
}

}  // extern "C"

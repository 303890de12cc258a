/* Native (host) PFDR solver for small reduced problems.
 *
 * Cut-pursuit contracts the problem onto a handful of components; on an
 * accelerator the per-dispatch latency then dwarfs the math (the reduced
 * solve is O(rV^2) with rV ~ 10..100).  This is a from-scratch C++
 * implementation of the same preconditioned forward-Douglas-Rachford
 * iteration as solvers/pfdr_quadratic.py (which follows
 * PFDR_graph_quadratic_d1_l1.cpp:57-532 semantically);
 * float64 throughout; single-threaded on purpose (problems are tiny).
 *
 * Operator modes, keyed like the reference's sign-of-N convention:
 *   n_mode > 0 : A is the dense n_mode-by-V matrix (row-major), Y is [N].
 *   n_mode = -1: A is the Gram matrix A^t A ([V, V]), Y is A^t y.
 *   n_mode = 0 : A is diag(A^t A) ([V]) or NULL for identity, Y is A^t y.
 */
#include <cfloat>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

inline double safe_div(double num, double den, double fill) {
  return den != 0.0 ? num / den : fill;
}

struct Problem {
  int v, e, n_mode;
  const double *a, *y;
  const int *eu, *ev;
  const double *la_d1, *la_l1;
  int positivity, use_bounds;
  double lo, hi;
  const double *lip_diag;
  double lip_scal;
  double rho, cond_min;
};

// gradient of the smooth part into g; returns nothing
void gradient(const Problem &p, const double *x, double *g, double *work_n) {
  if (p.n_mode > 0) {
    const int n = p.n_mode;
    for (int i = 0; i < n; ++i) {
      double s = 0;
      const double *row = p.a + static_cast<size_t>(i) * p.v;
      for (int j = 0; j < p.v; ++j) s += row[j] * x[j];
      work_n[i] = s - p.y[i];  // -(residual)
    }
    for (int j = 0; j < p.v; ++j) g[j] = 0;
    for (int i = 0; i < n; ++i) {
      const double *row = p.a + static_cast<size_t>(i) * p.v;
      const double r = work_n[i];
      for (int j = 0; j < p.v; ++j) g[j] += row[j] * r;
    }
  } else if (p.n_mode == -1) {
    for (int i = 0; i < p.v; ++i) {
      double s = 0;
      const double *row = p.a + static_cast<size_t>(i) * p.v;
      for (int j = 0; j < p.v; ++j) s += row[j] * x[j];
      g[i] = s - p.y[i];
    }
  } else {
    for (int i = 0; i < p.v; ++i)
      g[i] = (p.a ? p.a[i] : 1.0) * x[i] - p.y[i];
  }
}

void gram_diag(const Problem &p, double *h) {
  if (p.n_mode > 0) {
    for (int j = 0; j < p.v; ++j) h[j] = 0;
    for (int i = 0; i < p.n_mode; ++i) {
      const double *row = p.a + static_cast<size_t>(i) * p.v;
      for (int j = 0; j < p.v; ++j) h[j] += row[j] * row[j];
    }
  } else if (p.n_mode == -1) {
    for (int j = 0; j < p.v; ++j)
      h[j] = p.a[static_cast<size_t>(j) * p.v + j];
  } else {
    for (int j = 0; j < p.v; ++j) h[j] = p.a ? p.a[j] : 1.0;
  }
}

struct Precond {
  std::vector<double> ga, wu, wv, w_d1u, w_d1v, th_d1, th_l1;
};

// common tail of (re)conditioning — mirrors _finalize_precond in
// solvers/pfdr_quadratic.py
void finalize(const Problem &p, std::vector<double> &h,
              const std::vector<double> &w_raw,
              const std::vector<double> &l1_h, Precond &pre) {
  const int v = p.v, e = p.e;
  std::vector<double> aux(v, 0.0);
  for (int k = 0; k < e; ++k) {
    aux[p.eu[k]] += w_raw[k];
    aux[p.ev[k]] += w_raw[k];
  }
  pre.wu.resize(e);
  pre.wv.resize(e);
  for (int k = 0; k < e; ++k) {
    pre.wu[k] = w_raw[k] * safe_div(1.0, aux[p.eu[k]], 0.0);
    pre.wv[k] = w_raw[k] * safe_div(1.0, aux[p.ev[k]], 0.0);
  }
  pre.ga.resize(v);
  const double amt = 1.9 * (2.0 - p.rho);
  for (int j = 0; j < v; ++j) {
    double hj = h[j] + aux[j];
    if (!l1_h.empty()) hj += l1_h[j];
    double ga = safe_div(1.0, hj, 1.0);
    if (p.lip_diag) {
      if (p.lip_diag[j] > 0) {
        double cap = amt / p.lip_diag[j];
        if (ga > cap) ga = cap;
      }
    } else if (p.lip_scal > 0) {
      double cap = amt / p.lip_scal;
      if (ga > cap) ga = cap;
    } else {
      if (ga > amt) ga = amt;
    }
    pre.ga[j] = ga;
  }
  pre.w_d1u.resize(e);
  pre.w_d1v.resize(e);
  pre.th_d1.resize(e);
  for (int k = 0; k < e; ++k) {
    double du = pre.wu[k] / pre.ga[p.eu[k]];
    double dv = pre.wv[k] / pre.ga[p.ev[k]];
    double s = du + dv, prod = du * dv;
    pre.th_d1[k] = prod > 0 ? p.la_d1[k] * safe_div(s, prod, 0.0) : 0.0;
    pre.w_d1u[k] = safe_div(du, s, 0.5);
    pre.w_d1v[k] = safe_div(dv, s, 0.5);
  }
  pre.th_l1.assign(v, 0.0);
  if (p.la_l1)
    for (int j = 0; j < v; ++j) pre.th_l1[j] = pre.ga[j] * p.la_l1[j];
}

// amplitude statistic over nonzero coordinates (see _amplitude_scale)
double amplitude(const double *x, int v, bool inverse) {
  double n = 0, s = 0;
  for (int j = 0; j < v; ++j) {
    if (x[j] != 0) n += 1;
    s += std::fabs(x[j]);
  }
  if (inverse) return safe_div(n, s, 1.0);
  return safe_div(s, n, 1.0);
}

void initial_precondition(const Problem &p, Precond &pre) {
  std::vector<double> h(p.v);
  gram_diag(p, h.data());
  // pseudo-inverse of the observation in the operator's convention
  std::vector<double> pinv(p.v);
  if (p.n_mode > 0) {
    for (int j = 0; j < p.v; ++j) pinv[j] = 0;
    for (int i = 0; i < p.n_mode; ++i) {
      const double *row = p.a + static_cast<size_t>(i) * p.v;
      for (int j = 0; j < p.v; ++j) pinv[j] += row[j] * p.y[i];
    }
    for (int j = 0; j < p.v; ++j) pinv[j] = safe_div(pinv[j], h[j], 0.0);
  } else {
    for (int j = 0; j < p.v; ++j) pinv[j] = safe_div(p.y[j], h[j], 0.0);
  }
  const double c = amplitude(pinv.data(), p.v, true);
  std::vector<double> w_raw(p.e);
  for (int k = 0; k < p.e; ++k) w_raw[k] = c * p.la_d1[k];
  std::vector<double> l1_h;
  if (p.la_l1) {
    l1_h.resize(p.v);
    for (int j = 0; j < p.v; ++j) l1_h[j] = c * p.la_l1[j];
  }
  finalize(p, h, w_raw, l1_h, pre);
}

void recondition(const Problem &p, const double *x, const double *g,
                 std::vector<double> &zu, std::vector<double> &zv,
                 Precond &pre) {
  const int v = p.v, e = p.e;
  // auxiliary subgradients in the old metric
  std::vector<double> sub_u(e), sub_v(e);
  for (int k = 0; k < e; ++k) {
    int u = p.eu[k], w = p.ev[k];
    sub_u[k] = (pre.wu[k] / pre.ga[u]) * (x[u] - pre.ga[u] * g[u] - zu[k]);
    sub_v[k] = (pre.wv[k] / pre.ga[w]) * (x[w] - pre.ga[w] * g[w] - zv[k]);
  }
  std::vector<double> h(v);
  gram_diag(p, h.data());
  const double c = amplitude(x, v, false);
  std::vector<double> w_raw(e);
  for (int k = 0; k < e; ++k) {
    int u = p.eu[k], w = p.ev[k];
    double au = std::fabs(x[u]), av = std::fabs(x[w]);
    double amp = au > av ? au : av;
    if (c > amp) amp = c;
    double d = std::fabs(x[u] - x[w]);
    double floor_d = p.cond_min * amp;
    if (d < floor_d) d = floor_d;
    w_raw[k] = safe_div(p.la_d1[k], d, 0.0);
  }
  std::vector<double> l1_h;
  if (p.la_l1) {
    l1_h.resize(v);
    for (int j = 0; j < v; ++j) {
      double den = std::fabs(x[j]);
      double floor_d = c * p.cond_min;
      if (den < floor_d) den = floor_d;
      l1_h[j] = p.la_l1[j] / den;
    }
  }
  finalize(p, h, w_raw, l1_h, pre);
  for (int k = 0; k < e; ++k) {
    int u = p.eu[k], w = p.ev[k];
    zu[k] = x[u] - pre.ga[u] * (g[u] + safe_div(sub_u[k], pre.wu[k], 0.0));
    zv[k] = x[w] - pre.ga[w] * (g[w] + safe_div(sub_v[k], pre.wv[k], 0.0));
  }
}

}  // namespace

extern "C" int native_pfdr_quadratic_d1(
    int v, int e, int n_mode, const double *a, const double *y,
    const int *eu, const int *ev, const double *la_d1, const double *la_l1,
    int positivity, double lo, double hi, int use_bounds,
    const double *lip_diag, double lip_scal, double rho, double cond_min,
    double dif_rcd, double dif_tol, int it_max,
    double *x /* [v] in: init, out: solution */, int *it_out) {
  Problem p{v, e, n_mode, a, y, eu, ev, la_d1, la_l1, positivity,
            use_bounds, lo, hi, lip_diag, lip_scal, rho, cond_min};
  Precond pre;
  initial_precondition(p, pre);
  std::vector<double> zu(e), zv(e);
  for (int k = 0; k < e; ++k) {
    zu[k] = x[p.eu[k]];
    zv[k] = x[p.ev[k]];
  }
  std::vector<double> g(v), work_n(n_mode > 0 ? n_mode : 1), fp(v),
      x_prev(x, x + v);
  const double eps_mach = DBL_EPSILON;
  const double eps = (dif_tol > 0 && dif_tol < eps_mach) ? dif_tol
                                                         : eps_mach;
  const double dif_tol2 = dif_tol * dif_tol;
  double dif_rcd2 = dif_rcd * dif_rcd;
  double dif = dif_tol2 > dif_rcd2 ? dif_tol2 : dif_rcd2;
  int it = 0;
  while (it < it_max && dif >= dif_tol2) {
    gradient(p, x, g.data(), work_n.data());
    if (dif_rcd > 0 && dif < dif_rcd2) {
      recondition(p, x, g.data(), zu, zv, pre);
      dif_rcd2 *= 0.01;
    }
    // forward step
    for (int j = 0; j < v; ++j) fp[j] = 2.0 * x[j] - pre.ga[j] * g[j];
    // per-edge d1 prox + relaxation
    for (int k = 0; k < e; ++k) {
      int u = p.eu[k], w = p.ev[k];
      double au = fp[u] - zu[k], av = fp[w] - zv[k];
      double avg = pre.w_d1u[k] * au + pre.w_d1v[k] * av;
      double diff = au - av;
      double mag = std::fabs(diff) - pre.th_d1[k];
      double shr = mag > 0 ? (diff > 0 ? mag : -mag) : 0.0;
      double pu = avg + pre.w_d1v[k] * shr;
      double pv = avg - pre.w_d1u[k] * shr;
      zu[k] += rho * (pu - x[u]);
      zv[k] += rho * (pv - x[w]);
    }
    // weighted average back to the iterate
    for (int j = 0; j < v; ++j) x[j] = 0;
    for (int k = 0; k < e; ++k) {
      x[p.eu[k]] += pre.wu[k] * zu[k];
      x[p.ev[k]] += pre.wv[k] * zv[k];
    }
    // vertex prox
    if (use_bounds) {
      for (int j = 0; j < v; ++j) {
        if (x[j] < lo) x[j] = lo;
        if (x[j] > hi) x[j] = hi;
      }
    } else if (la_l1) {
      for (int j = 0; j < v; ++j) {
        double pos = x[j] - pre.th_l1[j];
        if (pos < 0) pos = 0;
        if (positivity) {
          x[j] = pos;
        } else {
          double neg = x[j] + pre.th_l1[j];
          if (neg > 0) neg = 0;
          x[j] = pos + neg;
        }
      }
    } else if (positivity) {
      for (int j = 0; j < v; ++j)
        if (x[j] < 0) x[j] = 0;
    }
    // relative evolution
    double num = 0, den = 0;
    for (int j = 0; j < v; ++j) {
      double d = x[j] - x_prev[j];
      num += d * d;
      den += x[j] * x[j];
      x_prev[j] = x[j];
    }
    dif = den > eps ? num / den : num / eps;
    ++it;
  }
  *it_out = it;
  return 0;
}

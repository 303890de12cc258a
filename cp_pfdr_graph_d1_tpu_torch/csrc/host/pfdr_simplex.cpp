/* Native (host) multi-label PFDR for small reduced problems.
 *
 * From-scratch C++ float64 twin of solvers/pfdr_simplex.py (which follows
 * PFDR_graph_loss_d1_simplex.cpp:64-726 semantically):
 * loss keyed on al (0 linear, 1 quadratic, in ]0,1[ smoothed-KL), optional
 * per-vertex weights la_f, per-(edge,label) d1 prox, exact sort-based
 * simplex projection in the (per-vertex max-normalized) metric Gamma,
 * reconditioning with 0.1 decay, and the two stopping modes (label counts
 * when dif_tol >= 1, mean l1 evolution otherwise).
 * Layout: vertex-major P[v*K + k], matching the reference.
 */
#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

inline double safe_div(double num, double den, double fill) {
  return den != 0.0 ? num / den : fill;
}

struct Problem {
  int v, e, k;
  double al;
  const double *q, *la_f;
  const int *eu, *ev;
  const double *la_d1;
  double rho, cond_min;
};

void loss_grad(const Problem &p, const double *pp, double *g) {
  const int n = p.v * p.k;
  if (p.al == 0.0) {
    for (int i = 0; i < n; ++i) g[i] = -p.q[i];
    return;
  }
  if (p.al == 1.0) {
    for (int i = 0; i < n; ++i) g[i] = pp[i] - p.q[i];
  } else {
    const double al_k = p.al / p.k, al_1 = 1.0 - p.al;
    for (int i = 0; i < n; ++i)
      g[i] = -al_1 * (al_k + al_1 * p.q[i]) / (al_k + al_1 * pp[i]);
  }
  if (p.la_f)
    for (int j = 0; j < p.v; ++j)
      for (int c = 0; c < p.k; ++c) g[j * p.k + c] *= p.la_f[j];
}

void loss_hessian(const Problem &p, const double *pp, double *h) {
  const int n = p.v * p.k;
  if (p.al == 0.0) {
    for (int i = 0; i < n; ++i) h[i] = 0.0;
    return;
  }
  if (p.al == 1.0) {
    for (int i = 0; i < n; ++i) h[i] = 1.0;
  } else {
    const double al_k = p.al / p.k, al_1 = 1.0 - p.al;
    for (int i = 0; i < n; ++i) {
      const double d = al_k / al_1 + pp[i];
      h[i] = (al_k + al_1 * p.q[i]) / (d * d);
    }
  }
  if (p.la_f)
    for (int j = 0; j < p.v; ++j)
      for (int c = 0; c < p.k; ++c) h[j * p.k + c] *= p.la_f[j];
}

// per-coordinate Lipschitz bound; returns false for the linear loss
bool loss_lipschitz(const Problem &p, std::vector<double> &lip) {
  if (p.al == 0.0) return false;
  const int n = p.v * p.k;
  lip.resize(n);
  if (p.al == 1.0) {
    for (int i = 0; i < n; ++i) lip[i] = 1.0;
  } else {
    const double al_k = p.al / p.k, al_1 = 1.0 - p.al;
    const double d2 = (al_k / al_1) * (al_k / al_1);
    for (int i = 0; i < n; ++i) lip[i] = (al_k + al_1 * p.q[i]) / d2;
  }
  if (p.la_f)
    for (int j = 0; j < p.v; ++j)
      for (int c = 0; c < p.k; ++c) lip[j * p.k + c] *= p.la_f[j];
  return true;
}

struct Precond {
  std::vector<double> ga, ga_proj, wu, wv, w_d1u, w_d1v, th_d1;
};

void precondition(const Problem &p, const double *pp,
                  const std::vector<double> &w_raw, Precond &pre) {
  const int v = p.v, e = p.e, k = p.k;
  const int n = v * k, m = e * k;
  std::vector<double> aux(n, 0.0);
  for (int t = 0; t < e; ++t)
    for (int c = 0; c < k; ++c) {
      aux[p.eu[t] * k + c] += w_raw[t * k + c];
      aux[p.ev[t] * k + c] += w_raw[t * k + c];
    }
  pre.wu.resize(m);
  pre.wv.resize(m);
  for (int t = 0; t < e; ++t)
    for (int c = 0; c < k; ++c) {
      pre.wu[t * k + c] =
          w_raw[t * k + c] * safe_div(1.0, aux[p.eu[t] * k + c], 0.0);
      pre.wv[t * k + c] =
          w_raw[t * k + c] * safe_div(1.0, aux[p.ev[t] * k + c], 0.0);
    }
  pre.ga.resize(n);
  if (p.al == 0.0) {
    for (int i = 0; i < n; ++i) pre.ga[i] = safe_div(1.0, aux[i], 0.0);
  } else {
    std::vector<double> h(n);
    loss_hessian(p, pp, h.data());
    for (int i = 0; i < n; ++i)
      pre.ga[i] = safe_div(1.0, h[i] + aux[i], 1.0);
  }
  const double amt = 1.9 * (2.0 - p.rho);
  std::vector<double> lip;
  if (loss_lipschitz(p, lip)) {
    for (int i = 0; i < n; ++i) {
      const double cap = amt / lip[i];
      if (pre.ga[i] > cap) pre.ga[i] = cap;
    }
  }
  pre.w_d1u.resize(m);
  pre.w_d1v.resize(m);
  pre.th_d1.resize(m);
  if (p.al == 0.0) {
    for (int i = 0; i < m; ++i) {
      pre.w_d1u[i] = 0.5;
      pre.w_d1v[i] = 0.5;
      pre.th_d1[i] = 2.0;
    }
  } else {
    for (int t = 0; t < e; ++t)
      for (int c = 0; c < k; ++c) {
        const int i = t * k + c;
        const double du = pre.wu[i] / pre.ga[p.eu[t] * k + c];
        const double dv = pre.wv[i] / pre.ga[p.ev[t] * k + c];
        const double s = du + dv, prod = du * dv;
        pre.th_d1[i] =
            prod > 0 ? p.la_d1[t] * safe_div(s, prod, 0.0) : 0.0;
        pre.w_d1u[i] = safe_div(du, s, 0.5);
        pre.w_d1v[i] = safe_div(dv, s, 0.5);
      }
  }
  // per-vertex max-normalization for projection stability
  pre.ga_proj.resize(n);
  for (int j = 0; j < v; ++j) {
    double mx = 0.0;
    for (int c = 0; c < k; ++c)
      if (pre.ga[j * k + c] > mx) mx = pre.ga[j * k + c];
    for (int c = 0; c < k; ++c)
      pre.ga_proj[j * k + c] = safe_div(pre.ga[j * k + c], mx, 1.0);
  }
}

void initial_precondition(const Problem &p, const double *pp,
                          Precond &pre) {
  std::vector<double> w_raw(static_cast<size_t>(p.e) * p.k);
  for (int t = 0; t < p.e; ++t)
    for (int c = 0; c < p.k; ++c) w_raw[t * p.k + c] = p.la_d1[t];
  precondition(p, pp, w_raw, pre);
}

void recondition(const Problem &p, const double *pp, const double *g,
                 std::vector<double> &zu, std::vector<double> &zv,
                 Precond &pre) {
  const int e = p.e, k = p.k;
  const int m = e * k;
  std::vector<double> sub_u(m), sub_v(m);
  for (int t = 0; t < e; ++t)
    for (int c = 0; c < k; ++c) {
      const int i = t * k + c, iu = p.eu[t] * k + c, iv = p.ev[t] * k + c;
      sub_u[i] = (pre.wu[i] / pre.ga[iu]) *
                 (pp[iu] - pre.ga[iu] * g[iu] - zu[i]);
      sub_v[i] = (pre.wv[i] / pre.ga[iv]) *
                 (pp[iv] - pre.ga[iv] * g[iv] - zv[i]);
    }
  std::vector<double> w_raw(m);
  for (int t = 0; t < e; ++t)
    for (int c = 0; c < k; ++c) {
      const int iu = p.eu[t] * k + c, iv = p.ev[t] * k + c;
      double d = std::fabs(pp[iu] - pp[iv]);
      if (d < p.cond_min) d = p.cond_min;
      w_raw[t * k + c] = p.la_d1[t] / d;
    }
  precondition(p, pp, w_raw, pre);
  for (int t = 0; t < e; ++t)
    for (int c = 0; c < k; ++c) {
      const int i = t * k + c, iu = p.eu[t] * k + c, iv = p.ev[t] * k + c;
      zu[i] = pp[iu] -
              pre.ga[iu] * (g[iu] + safe_div(sub_u[i], pre.wu[i], 0.0));
      zv[i] = pp[iv] -
              pre.ga[iv] * (g[iv] + safe_div(sub_v[i], pre.wv[i], 0.0));
    }
}

// exact sort-based projection of one row onto the simplex in metric
// diag(1/m): p = max(0, x - la*m) with la from the sorted breakpoints
// (same fixed point as solvers/ops/prox.py::proj_simplex_metric)
void proj_simplex_row(double *x, const double *m, int k,
                      std::vector<int> &order) {
  order.resize(k);
  for (int c = 0; c < k; ++c) order[c] = c;
  std::sort(order.begin(), order.end(), [&](int a, int b) {
    return x[a] / m[a] > x[b] / m[b];
  });
  double cx = 0.0, cm = 0.0, la = 0.0;
  int j_star = -1;
  double la_star = 0.0;
  for (int j = 0; j < k; ++j) {
    const int c = order[j];
    cx += x[c];
    cm += m[c];
    la = (cx - 1.0) / cm;
    if (x[c] / m[c] > la) {
      j_star = j;
      la_star = la;
    }
  }
  if (j_star < 0) {
    // degenerate ties: use the first prefix, as the vectorized version
    const int c = order[0];
    la_star = (x[c] - 1.0) / m[c];
  }
  for (int c = 0; c < k; ++c) {
    double val = x[c] - la_star * m[c];
    x[c] = val > 0 ? val : 0.0;
  }
}

}  // namespace

extern "C" int native_pfdr_loss_d1_simplex(
    int v, int e, int k, double al, const double *q, const double *la_f,
    const int *eu, const int *ev, const double *la_d1, double rho,
    double cond_min, double dif_rcd, double dif_tol, int it_max,
    double *pp /* [v*k] in: init, out: solution */, int *it_out) {
  Problem p{v, e, k, al, q, la_f, eu, ev, la_d1, rho, cond_min};
  const int n = v * k, m = e * k;
  Precond pre;
  initial_precondition(p, pp, pre);
  std::vector<double> zu(m), zv(m);
  for (int t = 0; t < e; ++t)
    for (int c = 0; c < k; ++c) {
      zu[t * k + c] = pp[eu[t] * k + c];
      zv[t * k + c] = pp[ev[t] * k + c];
    }
  const bool label_mode = dif_tol >= 1.0;
  std::vector<int> prev_labels(v);
  std::vector<double> prev_p;
  if (label_mode) {
    for (int j = 0; j < v; ++j)
      prev_labels[j] = static_cast<int>(
          std::max_element(pp + j * k, pp + (j + 1) * k) - (pp + j * k));
  } else {
    prev_p.assign(pp, pp + n);
  }
  std::vector<double> g(n), fp(n);
  std::vector<int> order;
  double dif_rcd_cur = dif_rcd;
  double dif = dif_tol > dif_rcd ? dif_tol : dif_rcd;
  int it = 0;
  while (it < it_max && dif >= dif_tol) {
    loss_grad(p, pp, g.data());
    if (dif_rcd > 0 && dif < dif_rcd_cur) {
      recondition(p, pp, g.data(), zu, zv, pre);
      dif_rcd_cur *= 0.1;
    }
    for (int i = 0; i < n; ++i) fp[i] = 2.0 * pp[i] - pre.ga[i] * g[i];
    for (int t = 0; t < e; ++t)
      for (int c = 0; c < k; ++c) {
        const int i = t * k + c, iu = eu[t] * k + c, iv = ev[t] * k + c;
        const double au = fp[iu] - zu[i], av = fp[iv] - zv[i];
        const double avg = pre.w_d1u[i] * au + pre.w_d1v[i] * av;
        const double diff = au - av;
        const double mag = std::fabs(diff) - pre.th_d1[i];
        const double shr = mag > 0 ? (diff > 0 ? mag : -mag) : 0.0;
        zu[i] += rho * (avg + pre.w_d1v[i] * shr - pp[iu]);
        zv[i] += rho * (avg - pre.w_d1u[i] * shr - pp[iv]);
      }
    for (int i = 0; i < n; ++i) pp[i] = 0.0;
    for (int t = 0; t < e; ++t)
      for (int c = 0; c < k; ++c) {
        const int i = t * k + c;
        pp[eu[t] * k + c] += pre.wu[i] * zu[i];
        pp[ev[t] * k + c] += pre.wv[i] * zv[i];
      }
    for (int j = 0; j < v; ++j)
      proj_simplex_row(pp + j * k, pre.ga_proj.data() + j * k, k, order);
    if (label_mode) {
      int changed = 0;
      for (int j = 0; j < v; ++j) {
        const int lab = static_cast<int>(
            std::max_element(pp + j * k, pp + (j + 1) * k) - (pp + j * k));
        if (lab != prev_labels[j]) ++changed;
        prev_labels[j] = lab;
      }
      dif = changed;
    } else {
      double s = 0.0;
      for (int i = 0; i < n; ++i) {
        s += std::fabs(pp[i] - prev_p[i]);
        prev_p[i] = pp[i];
      }
      dif = s / v;
    }
    ++it;
  }
  *it_out = it;
  return 0;
}

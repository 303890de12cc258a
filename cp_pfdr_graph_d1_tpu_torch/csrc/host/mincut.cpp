/* Native min-cut solver for cut-pursuit steepest-cut steps.
 *
 * Problem: given an undirected graph (Eu, Ev, w >= 0) and per-vertex signed
 * costs c, find U subset of V minimizing
 *     sum_{v in U} c_v  +  sum_{e = (u,v): [u in U] != [v in U]} w_e .
 *
 * Encoding as s-t min cut: c_v > 0 -> arc (v, t) with capacity c_v (paid when
 * v in U = source side); c_v < 0 -> implicit arc (s, v) with capacity -c_v
 * (paid when v stays out of U), realized as initial excess.  Undirected edges
 * carry capacity w in both directions.
 *
 * Algorithm: FIFO push-relabel with gap relabeling and periodic global
 * relabeling (BFS from the sink on the residual graph).  This is an
 * original implementation; the reference library uses the unrelated
 * Boykov-Kolmogorov augmenting-path scheme
 * (maxflow.cpp:484).
 *
 * After the preflow stage (no active vertex below height n), the sink side
 * T = {v : v reaches t in the residual graph} yields a minimum cut; the
 * output marks U = V \ T (vertices cut away from the sink).
 */
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct Solver {
  int n;
  std::vector<int> head;      // first arc per vertex (-1 = none)
  std::vector<int> nxt;       // next arc in list
  std::vector<int> to;        // arc target
  std::vector<double> cap;    // residual capacity; arc a pairs with a^1
  std::vector<double> excess;
  std::vector<double> cap_sink;  // residual capacity of (v, t)
  std::vector<int> height;
  std::vector<int> hcount;    // #vertices at each height (gap heuristic)
  std::queue<int> active;
  std::vector<uint8_t> in_queue;

  explicit Solver(int n_)
      : n(n_), head(n_, -1), excess(n_, 0.0), cap_sink(n_, 0.0),
        height(n_, 0), hcount(2 * n_ + 2, 0), in_queue(n_, 0) {}

  void add_edge(int u, int v, double w) { add_edge2(u, v, w, w); }

  // directed residual pair: capacity w_uv on arc u->v, w_vu on arc v->u
  void add_edge2(int u, int v, double w_uv, double w_vu) {
    if (u == v || (w_uv <= 0 && w_vu <= 0)) return;
    int a = static_cast<int>(to.size());
    to.push_back(v); cap.push_back(w_uv > 0 ? w_uv : 0);
    nxt.push_back(head[u]); head[u] = a;
    to.push_back(u); cap.push_back(w_vu > 0 ? w_vu : 0);
    nxt.push_back(head[v]); head[v] = a + 1;
  }

  void enqueue(int v) {
    if (!in_queue[v] && excess[v] > 0 && height[v] < n) {
      in_queue[v] = 1;
      active.push(v);
    }
  }

  // BFS from the sink over residual arcs; unreachable vertices go to height n.
  void global_relabel() {
    std::fill(hcount.begin(), hcount.end(), 0);
    std::vector<int> bfs;
    bfs.reserve(n);
    for (int v = 0; v < n; ++v) {
      height[v] = (cap_sink[v] > 0) ? 1 : n;
      if (height[v] == 1) bfs.push_back(v);
    }
    for (size_t i = 0; i < bfs.size(); ++i) {
      int v = bfs[i];
      for (int a = head[v]; a != -1; a = nxt[a]) {
        int u = to[a];
        if (height[u] == n && cap[a ^ 1] > 0) {  // residual arc u -> v
          height[u] = height[v] + 1;
          if (height[u] < n) bfs.push_back(u);
          else height[u] = n;
        }
      }
    }
    for (int v = 0; v < n; ++v) {
      ++hcount[height[v]];
      enqueue(v);
    }
  }

  void gap(int h) {
    // no vertex left at height h: lift everything in (h, n) to n + 1
    for (int v = 0; v < n; ++v) {
      if (height[v] > h && height[v] < n) {
        --hcount[height[v]];
        height[v] = n + 1;
        ++hcount[height[v]];
      }
    }
  }

  void discharge(int v) {
    while (excess[v] > 0 && height[v] < n) {
      if (height[v] == 1 && cap_sink[v] > 0) {  // push to sink
        double d = excess[v] < cap_sink[v] ? excess[v] : cap_sink[v];
        cap_sink[v] -= d;
        excess[v] -= d;
        if (excess[v] <= 0) break;
      }
      bool pushed = false;
      for (int a = head[v]; a != -1; a = nxt[a]) {
        if (cap[a] > 0 && height[v] == height[to[a]] + 1) {
          double d = excess[v] < cap[a] ? excess[v] : cap[a];
          cap[a] -= d;
          cap[a ^ 1] += d;
          excess[v] -= d;
          excess[to[a]] += d;
          enqueue(to[a]);
          if (excess[v] <= 0) { pushed = true; break; }
        }
      }
      if (pushed) break;
      // relabel
      int old = height[v];
      int best = 2 * n;
      if (cap_sink[v] > 0) best = 0;
      for (int a = head[v]; a != -1; a = nxt[a])
        if (cap[a] > 0 && height[to[a]] < best) best = height[to[a]];
      --hcount[old];
      height[v] = (best >= n - 1) ? n : best + 1;
      ++hcount[height[v]];
      if (hcount[old] == 0 && old < n) gap(old);
      if (height[v] >= n) break;
    }
  }

  void run() {
    global_relabel();
    long long work = 0;
    const long long relabel_period = 6LL * n + static_cast<long long>(to.size());
    while (!active.empty()) {
      int v = active.front();
      active.pop();
      in_queue[v] = 0;
      discharge(v);
      work += 12;
      if (work > relabel_period) {
        work = 0;
        global_relabel();
      }
    }
  }

  // marks the sink side T (residual-reachability to t)
  void sink_side(uint8_t *t_side) const {
    std::memset(t_side, 0, n);
    std::vector<int> bfs;
    bfs.reserve(n);
    for (int v = 0; v < n; ++v)
      if (cap_sink[v] > 0) { t_side[v] = 1; bfs.push_back(v); }
    for (size_t i = 0; i < bfs.size(); ++i) {
      int v = bfs[i];
      for (int a = head[v]; a != -1; a = nxt[a]) {
        int u = to[a];
        if (!t_side[u] && cap[a ^ 1] > 0) {  // residual arc u -> v
          t_side[u] = 1;
          bfs.push_back(u);
        }
      }
    }
  }
};

}  // namespace

namespace {

double clamp_big(int V, int E, const double *wa, const double *wb,
                 const double *c) {
  double big = 1.0;
  for (int e = 0; e < E; ++e) {
    if (wa[e] > 0 && wa[e] < 1e300) big += wa[e];
    if (wb && wb[e] > 0 && wb[e] < 1e300) big += wb[e];
  }
  for (int v = 0; v < V; ++v) {
    double a = c[v] < 0 ? -c[v] : c[v];
    if (a < 1e300) big += a;
  }
  return big;
}

int finish(Solver &s, int V, const double *c, double big, uint8_t *side) {
  for (int v = 0; v < V; ++v) {
    double cv = c[v];
    if (cv > big) cv = big;
    if (cv < -big) cv = -big;
    if (cv > 0) s.cap_sink[v] = cv;       // arc (v, t): paid when v in U
    else if (cv < 0) s.excess[v] = -cv;   // arc (s, v): paid when v not in U
  }
  s.run();
  s.sink_side(side);
  int cnt = 0;
  for (int v = 0; v < V; ++v) {
    side[v] = side[v] ? 0 : 1;  // U = complement of the sink side
    cnt += side[v];
  }
  return cnt;
}

}  // namespace

extern "C" {

/* Finds U minimizing sum_{U} c_v + sum_{cut e} w_e; writes side[v] = 1 for
 * v in U.  Infinite |c_v| values are clamped to (sum of finite magnitudes
 * + 1), which no finite cut can pay.  Returns the number of vertices in U. */
int cp_steepest_cut(int V, int E, const int32_t *Eu, const int32_t *Ev,
                    const double *w, const double *c, uint8_t *side) {
  double big = clamp_big(V, E, w, w, c);
  Solver s(V);
  for (int e = 0; e < E; ++e) {
    double we = w[e];
    if (we > big) we = big;
    s.add_edge(Eu[e], Ev[e], we);
  }
  return finish(s, V, c, big, side);
}

/* Directed variant: per edge e, capacity w_uv[e] on the residual arc
 * Eu->Ev and w_vu[e] on Ev->Eu.  An arc (x -> y) is paid when x is in U
 * and y is not.  Used by the duplex two-layer ternary cut. */
int cp_steepest_cut_directed(int V, int E, const int32_t *Eu,
                             const int32_t *Ev, const double *w_uv,
                             const double *w_vu, const double *c,
                             uint8_t *side) {
  double big = clamp_big(V, E, w_uv, w_vu, c);
  Solver s(V);
  for (int e = 0; e < E; ++e) {
    double a = w_uv[e] > big ? big : w_uv[e];
    double b = w_vu[e] > big ? big : w_vu[e];
    s.add_edge2(Eu[e], Ev[e], a, b);
  }
  return finish(s, V, c, big, side);
}

}  // extern "C"

// Host-side serial oracles for graphlearning_tpu_torch's data-parallel
// solvers: the port's own copy of graphlearning_tpu/native/oracles.cpp, with
// the same code, built with the same flags, so both packages' oracles give
// the same bits.
//
// These are exact sequential algorithms (binary-heap Dijkstra, Hopf-Lax
// variant, Gauss-Seidel and fast-marching p-eikonal, the Lipschitz
// iteration, the auction) used as correctness oracles for the on-device
// Bellman-Ford / Jacobi fixed-point iterations
// (graphlearning_tpu_torch/solvers/eikonal.py, solvers/plaplace.py).
//
// Own implementation (std::priority_queue; CSR in, distances out) of the
// same mathematical recursions the reference implements with a hand-rolled
// heap in c_code/hjsolvers.cpp:37-227 — cited for parity, not copied.
//
// Build (graphlearning_tpu_torch/native/__init__.py does it on first use):
//   g++ -O3 -shared -fPIC -std=c++17 oracles.cpp -o liboracles.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <queue>
#include <utility>
#include <vector>

extern "C" {

// Graph in CSR: row_ptr[n+1], col_idx[nnz], weights[nnz].
// bdy_idx[m] starting nodes with values bdy_val[m]; f[n] per-node RHS.
// Output: dist[n] (pre-filled with +inf by caller), cp[n] closest points.
// hopf_lax selects the quadratic HJ update.
void dijkstra_oracle(const int64_t* row_ptr, const int32_t* col_idx,
                     const double* weights, int32_t n,
                     const int32_t* bdy_idx, const double* bdy_val, int32_t m,
                     const double* f, double max_dist, int32_t hopf_lax,
                     double* dist, int32_t* cp) {
  using QE = std::pair<double, int32_t>;  // (dist, node), min-heap
  std::priority_queue<QE, std::vector<QE>, std::greater<QE>> heap;
  std::vector<char> done(n, 0);

  for (int32_t i = 0; i < m; ++i) {
    int32_t v = bdy_idx[i];
    if (bdy_val[i] < dist[v]) {
      dist[v] = bdy_val[i];
      cp[v] = v;
    }
  }
  for (int32_t i = 0; i < m; ++i) heap.emplace(dist[bdy_idx[i]], bdy_idx[i]);

  while (!heap.empty()) {
    auto [d, u] = heap.top();
    heap.pop();
    if (done[u] || d > dist[u]) continue;
    done[u] = 1;
    if (d > max_dist) break;
    for (int64_t e = row_ptr[u]; e < row_ptr[u + 1]; ++e) {
      int32_t v = col_idx[e];
      if (v == u || done[v]) continue;
      double cand;
      if (hopf_lax) {
        double fw = f[u] * weights[e];
        cand = 0.5 * (fw + std::sqrt(fw * fw + 4.0 * dist[u] * dist[u]));
      } else {
        cand = dist[u] + weights[e] * f[u];
      }
      if (cand < dist[v]) {
        dist[v] = cand;
        cp[v] = cp[u];
        heap.emplace(cand, v);
      }
    }
  }
}

// Gauss-Seidel p-eikonal: solve sum_j w_ij (u_i - u_j)_+^p = f_i per node,
// sweeping until max update < tol.  p==1 uses the exact sorted-prefix
// formula; p!=1 bisection (num_bisection_it steps).
void peikonal_oracle(const int64_t* row_ptr, const int32_t* col_idx,
                     const double* weights, int32_t n,
                     const int32_t* bdy_idx, const double* bdy_val, int32_t m,
                     const double* f, double p, int32_t max_num_it, double tol,
                     int32_t num_bisection_it, double* u) {
  std::vector<char> is_bdy(n, 0);
  for (int32_t i = 0; i < m; ++i) {
    is_bdy[bdy_idx[i]] = 1;
    u[bdy_idx[i]] = bdy_val[i];
  }
  std::vector<std::pair<double, double>> nb;  // (u_j, w_j)
  double err = tol + 1;
  for (int32_t it = 0; it < max_num_it && err > tol; ++it) {
    err = 0;
    for (int32_t i = 0; i < n; ++i) {
      if (is_bdy[i]) continue;
      nb.clear();
      for (int64_t e = row_ptr[i]; e < row_ptr[i + 1]; ++e)
        nb.emplace_back(u[col_idx[e]], weights[e]);
      if (nb.empty()) continue;
      double newu;
      if (p == 1.0) {
        std::sort(nb.begin(), nb.end());
        double wsum = nb[0].second, wusum = nb[0].first * nb[0].second;
        double t = (f[i] + wusum) / wsum;
        size_t k = 0;
        while (k + 1 < nb.size() && t > nb[k + 1].first) {
          ++k;
          wusum += nb[k].first * nb[k].second;
          wsum += nb[k].second;
          t = (f[i] + wusum) / wsum;
        }
        newu = t;
      } else {
        double umin = nb[0].first, umax = nb[0].first, deg = 0;
        for (auto& [uj, wj] : nb) {
          umin = std::min(umin, uj);
          umax = std::max(umax, uj);
          deg += wj;
        }
        double inc = std::pow(f[i] / deg, 1.0 / p);
        double a = umin + inc, b = umax + inc;
        for (int32_t bi = 0; bi < num_bisection_it; ++bi) {
          double t = 0.5 * (a + b), op = 0;
          for (auto& [uj, wj] : nb) {
            double v = std::max(t - uj, 0.0);
            op += wj * std::pow(v, p);
          }
          if (op > f[i]) b = t; else a = t;
        }
        newu = 0.5 * (a + b);
      }
      err = std::max(err, std::fabs(newu - u[i]));
      u[i] = newu;
    }
  }
}

}  // extern "C"

// Per-node p-eikonal local solver: find t with sum_j w_j (t - u_j)_+^p = fi
// over the given (u_j, w_j) list.  p==1: exact sorted-prefix formula;
// p!=1: bisection.  Shared by the Gauss-Seidel sweep and the FMM ordering.
static double peikonal_local(std::vector<std::pair<double, double>>& nb,
                             double fi, double p, int32_t num_bisection_it) {
  if (p == 1.0) {
    std::sort(nb.begin(), nb.end());
    double wsum = nb[0].second, wusum = nb[0].first * nb[0].second;
    double t = (fi + wusum) / wsum;
    size_t k = 0;
    while (k + 1 < nb.size() && t > nb[k + 1].first) {
      ++k;
      wusum += nb[k].first * nb[k].second;
      wsum += nb[k].second;
      t = (fi + wusum) / wsum;
    }
    return t;
  }
  double umin = nb[0].first, umax = nb[0].first, deg = 0;
  for (auto& [uj, wj] : nb) {
    umin = std::min(umin, uj);
    umax = std::max(umax, uj);
    deg += wj;
  }
  double inc = std::pow(fi / deg, 1.0 / p);
  double a = umin + inc, b = umax + inc;
  for (int32_t bi = 0; bi < num_bisection_it; ++bi) {
    double t = 0.5 * (a + b), op = 0;
    for (auto& [uj, wj] : nb) {
      double v = std::max(t - uj, 0.0);
      op += wj * std::pow(v, p);
    }
    if (op > fi) b = t; else a = t;
  }
  return 0.5 * (a + b);
}

extern "C" {

// Fast-marching p-eikonal (heap-ordered single-pass; reference intent
// c_code/hjsolvers.cpp:342-420, own design): accept nodes in increasing-u
// order, re-solving each accepted node's unaccepted neighbors from their
// ACCEPTED neighbors only.  u pre-filled with +inf by caller.
void peikonal_fmm_oracle(const int64_t* row_ptr, const int32_t* col_idx,
                         const double* weights, int32_t n,
                         const int32_t* bdy_idx, const double* bdy_val,
                         int32_t m, const double* f, double p,
                         int32_t num_bisection_it, double* u) {
  using QE = std::pair<double, int32_t>;
  std::priority_queue<QE, std::vector<QE>, std::greater<QE>> heap;
  std::vector<char> done(n, 0);
  for (int32_t i = 0; i < m; ++i) {
    int32_t v = bdy_idx[i];
    if (bdy_val[i] < u[v]) u[v] = bdy_val[i];
  }
  for (int32_t i = 0; i < m; ++i) heap.emplace(u[bdy_idx[i]], bdy_idx[i]);

  std::vector<std::pair<double, double>> nb;
  while (!heap.empty()) {
    auto [d, v] = heap.top();
    heap.pop();
    if (done[v] || d > u[v]) continue;
    done[v] = 1;
    for (int64_t e = row_ptr[v]; e < row_ptr[v + 1]; ++e) {
      int32_t j = col_idx[e];
      if (done[j] || j == v) continue;
      nb.clear();
      for (int64_t e2 = row_ptr[j]; e2 < row_ptr[j + 1]; ++e2) {
        int32_t r = col_idx[e2];
        if (done[r]) nb.emplace_back(u[r], weights[e2]);
      }
      if (nb.empty()) continue;
      double cand = peikonal_local(nb, f[j], p, num_bisection_it);
      if (cand < u[j]) {
        u[j] = cand;
        heap.emplace(cand, j);
      }
    }
  }
}

// Gauss-Seidel AMLE / game-theoretic p-Laplace oracle (reference intent
// c_code/lp_iterate.cpp:129-259, own design).  weighted==0:
//   u_i <- alpha * (sum_j w_ij u_j)/deg_i + beta * (min_j u_j + max_j u_j)/2
// weighted==1: per-node bisection on
//   min_j w_ij (t - u_j) + max_j w_ij (t - u_j) = 0.
// bdy nodes are fixed.  Sweeps until max update < tol.
void lip_iterate_oracle(const int64_t* row_ptr, const int32_t* col_idx,
                        const double* weights, int32_t n,
                        const int32_t* bdy_idx, const double* bdy_val,
                        int32_t m, double alpha, double beta,
                        int32_t weighted, int32_t max_num_it, double tol,
                        int32_t num_bisection_it, double* u) {
  std::vector<char> is_bdy(n, 0);
  for (int32_t i = 0; i < m; ++i) {
    is_bdy[bdy_idx[i]] = 1;
    u[bdy_idx[i]] = bdy_val[i];
  }
  double err = tol + 1;
  for (int32_t it = 0; it < max_num_it && err > tol; ++it) {
    err = 0;
    for (int32_t i = 0; i < n; ++i) {
      if (is_bdy[i]) continue;
      double newu;
      if (!weighted) {
        double wsum = 0, wusum = 0;
        double umin = std::numeric_limits<double>::infinity(), umax = -umin;
        for (int64_t e = row_ptr[i]; e < row_ptr[i + 1]; ++e) {
          double uj = u[col_idx[e]], wj = weights[e];
          wsum += wj;
          wusum += wj * uj;
          umin = std::min(umin, uj);
          umax = std::max(umax, uj);
        }
        if (wsum == 0) continue;
        newu = alpha * wusum / wsum + beta * 0.5 * (umin + umax);
      } else {
        double a = std::numeric_limits<double>::infinity(), b = -a;
        for (int64_t e = row_ptr[i]; e < row_ptr[i + 1]; ++e) {
          a = std::min(a, u[col_idx[e]]);
          b = std::max(b, u[col_idx[e]]);
        }
        for (int32_t bi = 0; bi < num_bisection_it; ++bi) {
          double t = 0.5 * (a + b);
          double minw = 0, maxw = 0;
          for (int64_t e = row_ptr[i]; e < row_ptr[i + 1]; ++e) {
            double v = weights[e] * (t - u[col_idx[e]]);
            minw = std::min(minw, v);
            maxw = std::max(maxw, v);
          }
          if (minw + maxw > 0) b = t; else a = t;
        }
        newu = 0.5 * (a + b);
      }
      err = std::max(err, std::fabs(newu - u[i]));
      u[i] = newu;
    }
  }
}

// Volume-constrained assignment via Bertsekas forward auction with
// eps-scaling and per-class capacities (oracle for the device's Jacobi
// auction in ssl._volume_assignment; reference intent
// c_code/mbo_convolution.cpp:248-316, own design).
//
// Maximize sum_i a[i, c_i] s.t. |{i : c_i = c}| == target[c]
// (sum(target) == n).  fixed[i] >= 0 pins node i to that class (its slot
// counts toward the target).  a is row-major (n, kcls).
// Output labels[n].  eps0/eps_min/scale control the eps schedule.
void auction_oracle(const double* a, int32_t n, int32_t kcls,
                    const int32_t* target, const int32_t* fixed,
                    double eps0, double eps_min, double scale,
                    int32_t* labels) {
  std::vector<int32_t> cap(kcls);
  for (int32_t c = 0; c < kcls; ++c) cap[c] = target[c];
  std::vector<int32_t> free_nodes;
  for (int32_t i = 0; i < n; ++i) {
    if (fixed[i] >= 0) {
      labels[i] = fixed[i];
      cap[fixed[i]]--;
    } else {
      labels[i] = -1;
    }
  }
  std::vector<double> price(kcls, 0.0);
  // per-class heap of (bid_value, node) for assigned nodes — lowest bidder
  // is evicted when a class is oversubscribed.
  using QE = std::pair<double, int32_t>;

  for (double eps = eps0; ; eps /= scale) {
    // reset assignment of non-fixed nodes for this eps round
    std::vector<int32_t> capr = cap;
    std::vector<std::priority_queue<QE, std::vector<QE>, std::greater<QE>>>
        holders(kcls);
    free_nodes.clear();
    for (int32_t i = 0; i < n; ++i)
      if (fixed[i] < 0) {
        labels[i] = -1;
        free_nodes.push_back(i);
      }
    while (!free_nodes.empty()) {
      int32_t i = free_nodes.back();
      free_nodes.pop_back();
      // best and second-best net value
      double best = -std::numeric_limits<double>::infinity(), second = best;
      int32_t bc = 0;
      for (int32_t c = 0; c < kcls; ++c) {
        if (cap[c] == 0) continue;  // no slots open to free nodes
        double v = a[(int64_t)i * kcls + c] - price[c];
        if (v > best) {
          second = best;
          best = v;
          bc = c;
        } else if (v > second) {
          second = v;
        }
      }
      double bid = price[bc] + best - second + eps;
      if (capr[bc] > 0) {
        capr[bc]--;
        labels[i] = bc;
        holders[bc].emplace(bid, i);
        if (capr[bc] == 0) price[bc] = holders[bc].top().first;
      } else {
        // evict the lowest holder
        auto [lowbid, j] = holders[bc].top();
        holders[bc].pop();
        labels[j] = -1;
        free_nodes.push_back(j);
        labels[i] = bc;
        holders[bc].emplace(bid, i);
        price[bc] = holders[bc].top().first;
      }
    }
    if (eps <= eps_min) break;
  }
}

}  // extern "C"

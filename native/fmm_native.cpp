// Native host-side runtime for fmm_bem_tpu.
//
// C++ implementations of the plan-build hot paths that run on the host
// CPU (the accelerator executes the compiled matvec; these feed it):
//   - Morton octree construction        (counterpart of include/tree/Octree.hpp)
//   - dual-tree MAC traversal           (counterpart of executor/EvalInteraction*.hpp)
//   - near-field COO index expansion    (counterpart of EvalP2P.hpp to_matrix indexing)
//
// Exposed as a C ABI for ctypes; the Python layer keeps numpy fallbacks
// with identical semantics (fmm_bem_tpu/tree/octree.py,
// fmm_bem_tpu/traversal/lists.py), so the .so is an accelerator, not a
// requirement.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>

namespace {

constexpr int kLevels = 10;
constexpr int64_t kCellsPerSide = 1 << kLevels;

inline int64_t spread_bits(int64_t x) {
  x = (x | (x << 16)) & 0x030000FF;
  x = (x | (x << 8)) & 0x0300F00F;
  x = (x | (x << 4)) & 0x030C30C3;
  x = (x | (x << 2)) & 0x09249249;
  return x;
}

inline int64_t interleave(int64_t ix, int64_t iy, int64_t iz) {
  return spread_bits(ix) | (spread_bits(iy) << 1) | (spread_bits(iz) << 2);
}

struct Tree {
  int64_t n = 0;
  std::vector<int64_t> perm;    // morton order -> original index
  std::vector<int64_t> codes;   // sorted codes
  std::vector<int64_t> prefix;  // per-box morton prefix
  std::vector<int32_t> level, parent, child_start, child_count;
  std::vector<int32_t> body_start, body_count, body_leaf;
  std::vector<uint8_t> is_leaf;
};

struct Lists {
  std::vector<int32_t> m2l;  // pairs (src, tgt)
  std::vector<int32_t> p2p;
};

}  // namespace

extern "C" {

void* fmm_tree_build(const double* pts, int64_t n, int ncrit, int max_level,
                     const double* pmin, double side) {
  Tree* t = new Tree();
  t->n = n;
  const double cell = side / double(kCellsPerSide);

  t->codes.resize(n);
  t->perm.resize(n);
  {
    std::vector<int64_t> raw(n);
    for (int64_t i = 0; i < n; ++i) {
      int64_t ix = (int64_t)std::floor((pts[3 * i + 0] - pmin[0]) / cell);
      int64_t iy = (int64_t)std::floor((pts[3 * i + 1] - pmin[1]) / cell);
      int64_t iz = (int64_t)std::floor((pts[3 * i + 2] - pmin[2]) / cell);
      ix = std::min(std::max(ix, int64_t(0)), kCellsPerSide - 1);
      iy = std::min(std::max(iy, int64_t(0)), kCellsPerSide - 1);
      iz = std::min(std::max(iz, int64_t(0)), kCellsPerSide - 1);
      raw[i] = interleave(ix, iy, iz);
      t->perm[i] = i;
    }
    std::stable_sort(t->perm.begin(), t->perm.end(),
                     [&](int64_t a, int64_t b) { return raw[a] < raw[b]; });
    for (int64_t i = 0; i < n; ++i) t->codes[i] = raw[t->perm[i]];
  }

  // BFS box construction: split boxes with > ncrit bodies on the next
  // 3 morton bits (same leaf criterion as the reference,
  // Octree.hpp:641-644)
  t->level.push_back(0);
  t->parent.push_back(-1);
  t->child_start.push_back(0);
  t->child_count.push_back(0);
  t->body_start.push_back(0);
  t->body_count.push_back((int32_t)n);
  t->is_leaf.push_back(0);
  t->prefix.push_back(0);

  for (size_t b = 0; b < t->level.size(); ++b) {
    int32_t start = t->body_start[b], count = t->body_count[b];
    int lvl = t->level[b];
    if (count <= ncrit || lvl >= max_level) {
      t->is_leaf[b] = 1;
      continue;
    }
    int shift = 3 * (kLevels - lvl - 1);
    int64_t pfx = t->prefix[b];
    int32_t first_child = (int32_t)t->level.size();
    int nchild = 0;
    const int64_t* cbeg = t->codes.data() + start;
    const int64_t* cend = cbeg + count;
    for (int d = 0; d < 8; ++d) {
      int64_t lo_code = pfx + ((int64_t)d << shift);
      int64_t hi_code = pfx + ((int64_t)(d + 1) << shift);
      const int64_t* lo = std::lower_bound(cbeg, cend, lo_code);
      const int64_t* hi = std::lower_bound(cbeg, cend, hi_code);
      if (hi == lo) continue;
      t->level.push_back(lvl + 1);
      t->parent.push_back((int32_t)b);
      t->child_start.push_back(0);
      t->child_count.push_back(0);
      t->body_start.push_back(start + (int32_t)(lo - cbeg));
      t->body_count.push_back((int32_t)(hi - lo));
      t->is_leaf.push_back(0);
      t->prefix.push_back(lo_code);
      ++nchild;
    }
    t->child_start[b] = first_child;
    t->child_count[b] = nchild;
  }

  // NOTE: BFS order is not sorted by level when siblings at mixed
  // depths interleave — but since children are appended strictly after
  // parents and we push whole levels in order, BFS order IS level
  // order (queue discipline).
  t->body_leaf.resize(n);
  for (size_t b = 0; b < t->level.size(); ++b) {
    if (!t->is_leaf[b]) continue;
    for (int32_t i = t->body_start[b]; i < t->body_start[b] + t->body_count[b]; ++i)
      t->body_leaf[i] = (int32_t)b;
  }
  return t;
}

int64_t fmm_tree_num_boxes(void* h) { return (int64_t)((Tree*)h)->level.size(); }

void fmm_tree_fill(void* h, int32_t* level, int32_t* parent,
                   int32_t* child_start, int32_t* child_count,
                   int32_t* body_start, int32_t* body_count, uint8_t* is_leaf,
                   int64_t* prefix, int64_t* perm, int64_t* codes,
                   int32_t* body_leaf) {
  Tree* t = (Tree*)h;
  size_t nb = t->level.size();
  std::memcpy(level, t->level.data(), nb * 4);
  std::memcpy(parent, t->parent.data(), nb * 4);
  std::memcpy(child_start, t->child_start.data(), nb * 4);
  std::memcpy(child_count, t->child_count.data(), nb * 4);
  std::memcpy(body_start, t->body_start.data(), nb * 4);
  std::memcpy(body_count, t->body_count.data(), nb * 4);
  std::memcpy(is_leaf, t->is_leaf.data(), nb);
  std::memcpy(prefix, t->prefix.data(), nb * 8);
  std::memcpy(perm, t->perm.data(), t->n * 8);
  std::memcpy(codes, t->codes.data(), t->n * 8);
  std::memcpy(body_leaf, t->body_leaf.data(), t->n * 4);
}

void fmm_tree_free(void* h) { delete (Tree*)h; }

// ---------------------------------------------------------------------------
// dual-tree MAC traversal (work-queue form, ref EvalInteraction.hpp:20-89)

void* fmm_traverse(int64_t ns_boxes, const int32_t* s_leaf,
                   const int32_t* s_child_start, const int32_t* s_child_count,
                   const double* s_center, const double* s_radius,
                   int64_t nt_boxes, const int32_t* t_leaf,
                   const int32_t* t_child_start, const int32_t* t_child_count,
                   const double* t_center, const double* t_radius,
                   double theta) {
  Lists* out = new Lists();
  const double inv_theta = 1.0 / theta;
  std::deque<std::pair<int32_t, int32_t>> q;
  q.emplace_back(0, 0);

  auto mac = [&](int32_t s, int32_t t) {
    double dx = s_center[3 * s] - t_center[3 * t];
    double dy = s_center[3 * s + 1] - t_center[3 * t + 1];
    double dz = s_center[3 * s + 2] - t_center[3 * t + 2];
    double rhs = (s_radius[s] + t_radius[t]) * inv_theta;
    // tie-consistent MAC (ties pass) — must match traversal/lists.py,
    // which documents why (family M2L combo masks need tie stability)
    return dx * dx + dy * dy + dz * dz > rhs * rhs * (1.0 - 1e-12);
  };
  auto interact = [&](int32_t s, int32_t t) {
    if (mac(s, t)) {
      out->m2l.push_back(s);
      out->m2l.push_back(t);
    } else {
      q.emplace_back(s, t);
    }
  };

  while (!q.empty()) {
    auto [s, t] = q.front();
    q.pop_front();
    bool sl = s_leaf[s], tl = t_leaf[t];
    if (sl && tl) {
      out->p2p.push_back(s);
      out->p2p.push_back(t);
      continue;
    }
    // split the larger side; ties split the target
    bool split_src = !sl && (tl || s_radius[s] > t_radius[t]);
    if (split_src) {
      for (int c = 0; c < s_child_count[s]; ++c)
        interact(s_child_start[s] + c, t);
    } else {
      for (int c = 0; c < t_child_count[t]; ++c)
        interact(s, t_child_start[t] + c);
    }
  }
  return out;
}

void fmm_lists_sizes(void* h, int64_t* n_m2l, int64_t* n_p2p) {
  Lists* l = (Lists*)h;
  *n_m2l = (int64_t)l->m2l.size() / 2;
  *n_p2p = (int64_t)l->p2p.size() / 2;
}

void fmm_lists_fill(void* h, int32_t* m2l, int32_t* p2p) {
  Lists* l = (Lists*)h;
  std::memcpy(m2l, l->m2l.data(), l->m2l.size() * 4);
  std::memcpy(p2p, l->p2p.data(), l->p2p.size() * 4);
}

void fmm_lists_free(void* h) { delete (Lists*)h; }

// ---------------------------------------------------------------------------
// near-field COO expansion: leaf pairs -> (row, col) body index arrays
// sorted by row (ref EvalP2P.hpp:47-98 CSR assembly indexing)

int64_t fmm_near_coo_size(int64_t npairs, const int32_t* pairs,
                          const int32_t* s_body_count,
                          const int32_t* t_body_count) {
  int64_t nnz = 0;
  for (int64_t i = 0; i < npairs; ++i)
    nnz += (int64_t)s_body_count[pairs[2 * i]] * t_body_count[pairs[2 * i + 1]];
  return nnz;
}

void fmm_near_coo_fill(int64_t npairs, const int32_t* pairs,
                       const int32_t* s_body_start, const int32_t* s_body_count,
                       const int32_t* t_body_start, const int32_t* t_body_count,
                       int32_t* rows, int32_t* cols) {
  // emit unsorted, then sort by row with index pairs (stable)
  int64_t nnz = 0;
  for (int64_t i = 0; i < npairs; ++i) {
    int32_t s = pairs[2 * i], t = pairs[2 * i + 1];
    for (int32_t bt = 0; bt < t_body_count[t]; ++bt) {
      int32_t row = t_body_start[t] + bt;
      for (int32_t bs = 0; bs < s_body_count[s]; ++bs) {
        rows[nnz] = row;
        cols[nnz] = s_body_start[s] + bs;
        ++nnz;
      }
    }
  }
  // counting sort by row (rows are dense small ints): O(nnz), stable —
  // a comparison sort here dominated the whole plan build at 1e8 nnz
  int32_t max_row = 0;
  for (int64_t i = 0; i < nnz; ++i) max_row = std::max(max_row, rows[i]);
  std::vector<int64_t> cnt((size_t)max_row + 2, 0);
  for (int64_t i = 0; i < nnz; ++i) ++cnt[rows[i] + 1];
  for (size_t r = 1; r < cnt.size(); ++r) cnt[r] += cnt[r - 1];
  std::vector<int32_t> r2(nnz), c2(nnz);
  for (int64_t i = 0; i < nnz; ++i) {
    int64_t pos = cnt[rows[i]]++;
    r2[pos] = rows[i];
    c2[pos] = cols[i];
  }
  std::memcpy(rows, r2.data(), nnz * 4);
  std::memcpy(cols, c2.data(), nnz * 4);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Laplace/Yukawa BEM near-field entry assembly (counterpart of
// fmm_bem_tpu/bem/integrals.py near_entries_laplace + semi_analytical;
// same selection rules as the reference's eval_G/eval_dGdn,
// LaplaceSphericalBEM.hpp:159-264).

namespace {

struct V3 {
  double x, y, z;
  V3 operator-(const V3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  V3 operator+(const V3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  V3 operator*(double s) const { return {x * s, y * s, z * s}; }
  double dot(const V3& o) const { return x * o.x + y * o.y + z * o.z; }
  V3 cross(const V3& o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  double norm() const { return std::sqrt(dot(*this)); }
};

// 5-point Gauss-Legendre on [-1, 1]
const double kGx[5] = {-0.9061798459386640, -0.5384693101056831, 0.0,
                       0.5384693101056831, 0.9061798459386640};
const double kGw[5] = {0.2369268850561891, 0.4786286704993665,
                       0.5688888888888889, 0.4786286704993665,
                       0.2369268850561891};

void line_int(double z, double x, double va, double vb, double kappa,
              double* G, double* dG) {
  double t1 = std::atan2(va, x), t2 = std::atan2(vb, x);
  double dt = t2 - t1, tm = 0.5 * (t2 + t1);
  double az = std::fabs(z);
  double sz = az < 1e-10 ? 0.0 : (z > 0 ? 1.0 : -1.0);
  double ekz = kappa ? std::exp(-kappa * az) : 1.0;
  for (int i = 0; i < 5; ++i) {
    double th = 0.5 * dt * kGx[i] + tm;
    double rt = x / std::cos(th);
    double R = std::sqrt(rt * rt + z * z);
    double Rs = std::max(R, 1e-300);
    if (kappa) {
      double ekr = std::exp(-kappa * R);
      *G += -kGw[i] * (ekr - ekz) / kappa * 0.5 * dt;
      *dG += kGw[i] * (z / Rs * ekr - ekz * sz) * 0.5 * dt;
    } else {
      *G += kGw[i] * (R - az) * 0.5 * dt;
      *dG += kGw[i] * (z / Rs - sz) * 0.5 * dt;
    }
  }
}

void int_side(double v1x, double v1y, double v2x, double v2y, double p,
              double kappa, double* G, double* dG) {
  double ex = v2x - v1x, ey = v2y - v1y;
  double el = std::sqrt(ex * ex + ey * ey);
  if (el < 1e-300) return;
  ex /= el;
  ey /= el;
  double x = ex * v1y - ey * v1x;  // signed perpendicular coordinate
  double y1 = v1x * ex + v1y * ey;
  double y2 = v2x * ex + v2y * ey;
  if (x < 0) {
    x = -x;
    y1 = -y1;
    y2 = -y2;
  }
  if (x < 1e-14) return;
  line_int(p, x, 0.0, y1, kappa, G, dG);
  line_int(p, x, y2, 0.0, kappa, G, dG);
}

void semi_analytical_one(const V3& y0, const V3& y1, const V3& y2,
                         const V3& xx, bool same, double kappa, double* G,
                         double* dG) {
  V3 X = y1 - y0;
  V3 Z = (y1 - y0).cross(y2 - y0);
  double xn = std::max(X.norm(), 1e-300), zn = std::max(Z.norm(), 1e-300);
  X = X * (1.0 / xn);
  Z = Z * (1.0 / zn);
  V3 Y = Z.cross(X);
  auto plane = [&](const V3& v, double* px, double* py, double* pz) {
    V3 rel = v - y0;
    *px = rel.dot(X);
    *py = rel.dot(Y);
    *pz = rel.dot(Z);
  };
  double xpx, xpy, xpz;
  plane(xx, &xpx, &xpy, &xpz);
  double p0x, p0y, p0z, p1x, p1y, p1z, p2x, p2y, p2z;
  plane(y0, &p0x, &p0y, &p0z);
  plane(y1, &p1x, &p1y, &p1z);
  plane(y2, &p2x, &p2y, &p2z);
  p0x -= xpx; p0y -= xpy;
  p1x -= xpx; p1y -= xpy;
  p2x -= xpx; p2y -= xpy;
  *G = 0.0;
  *dG = 0.0;
  int_side(p0x, p0y, p1x, p1y, xpz, kappa, G, dG);
  int_side(p1x, p1y, p2x, p2y, xpz, kappa, G, dG);
  int_side(p2x, p2y, p0x, p0y, xpz, kappa, G, dG);
  if (same) *dG = kappa ? -2.0 * M_PI : 2.0 * M_PI;
}

}  // namespace

extern "C" {

// fine_pts: [KF * 3] barycentric; fine_wts: [KF]
void fmm_near_laplace(int64_t nnz, const int32_t* rows, const int32_t* cols,
                      const double* t_centers, const double* s_centers,
                      const double* s_verts, const double* s_area,
                      const double* s_normal, const double* s_qp,
                      const double* s_qw, int K, const double* fine_pts,
                      const double* fine_wts, int KF, double kappa,
                      double* G_out, double* dG_out) {
#pragma omp parallel for schedule(static)
  for (int64_t e = 0; e < nnz; ++e) {
    int32_t r = rows[e], c = cols[e];
    V3 t{t_centers[3 * r], t_centers[3 * r + 1], t_centers[3 * r + 2]};
    V3 sc{s_centers[3 * c], s_centers[3 * c + 1], s_centers[3 * c + 2]};
    double area = s_area[c];
    V3 nrm{s_normal[3 * c], s_normal[3 * c + 1], s_normal[3 * c + 2]};
    double dist = (t - sc).norm();
    bool self_ = dist < 1e-8;
    bool near = std::sqrt(2.0 * area) / std::max(dist, 1e-300) >= 0.5;
    const double* v = s_verts + 9 * c;
    V3 v0{v[0], v[1], v[2]}, v1{v[3], v[4], v[5]}, v2{v[6], v[7], v[8]};

    // --- G (ref eval_G): SA when near, else K-point quadrature
    double G;
    if (near) {
      double dg_unused;
      semi_analytical_one(v0, v1, v2, t, self_, kappa, &G, &dg_unused);
    } else {
      G = 0.0;
      for (int k = 0; k < K; ++k) {
        V3 qp{s_qp[(3 * K) * c + 3 * k], s_qp[(3 * K) * c + 3 * k + 1],
              s_qp[(3 * K) * c + 3 * k + 2]};
        double rr = std::max((t - qp).norm(), 1e-100);
        double g = kappa ? std::exp(-kappa * rr) / rr : 1.0 / rr;
        G += s_qw[K * c + k] * g;
      }
      G *= area;
    }

    // --- dGdn (ref eval_dGdn): 2pi self; fine-K when near; else K-pt
    double dG;
    if (self_) {
      dG = kappa ? -2.0 * M_PI : 2.0 * M_PI;
    } else {
      dG = 0.0;
      if (near) {
        for (int k = 0; k < KF; ++k) {
          double l0 = fine_pts[3 * k], l1 = fine_pts[3 * k + 1],
                 l2 = fine_pts[3 * k + 2];
          V3 qp = v0 * l0 + v1 * l1 + v2 * l2;
          V3 d = qp - t;
          double r2 = std::max(d.dot(d), 1e-100);
          double rr = std::sqrt(r2);
          double dn = d.dot(nrm);
          double val = kappa ? dn * (kappa * rr + 1.0) *
                                   std::exp(-kappa * rr) / (r2 * rr)
                             : dn / (r2 * rr);
          dG += fine_wts[k] * val;
        }
      } else {
        for (int k = 0; k < K; ++k) {
          V3 qp{s_qp[(3 * K) * c + 3 * k], s_qp[(3 * K) * c + 3 * k + 1],
                s_qp[(3 * K) * c + 3 * k + 2]};
          V3 d = qp - t;
          double r2 = std::max(d.dot(d), 1e-100);
          double rr = std::sqrt(r2);
          double dn = d.dot(nrm);
          double val = kappa ? dn * (kappa * rr + 1.0) *
                                   std::exp(-kappa * rr) / (r2 * rr)
                             : dn / (r2 * rr);
          dG += s_qw[K * c + k] * val;
        }
      }
      dG *= area;
    }
    G_out[e] = G;
    dG_out[e] = dG;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Near-field leaf-panel block fill (counterpart of the hot section of
// fmm_bem_tpu/ops/near_panel.py build_near_panels): maps every COO
// entry to its (pair, in-block) position and scatters the value into
// the dense [npairs, KT*rdim, KS*cdim] block array.  The numpy
// fancy-index + searchsorted version of this was ~250s at 1e8 nnz.

extern "C" {

void fmm_panel_fill(int64_t nnz, const int32_t* rows, const int32_t* cols,
                    const float* vals,  // [nnz, rdim, cdim] row-major
                    const int32_t* t_slot, const int32_t* s_slot,
                    const int32_t* t_pos, const int32_t* s_pos,
                    const int64_t* pair_key_sorted, int64_t npairs,
                    int64_t mult, int rdim, int cdim, int KT, int KS,
                    float* blocks /* [npairs, KT*rdim, KS*cdim] */) {
  const int64_t KTr = (int64_t)KT * rdim;
  const int64_t KSc = (int64_t)KS * cdim;
  const int64_t bstride = KTr * KSc;
#pragma omp parallel for schedule(static)
  for (int64_t e = 0; e < nnz; ++e) {
    const int32_t r = rows[e], c = cols[e];
    const int64_t key = (int64_t)t_slot[r] * mult + s_slot[c];
    const int64_t* lo =
        std::lower_bound(pair_key_sorted, pair_key_sorted + npairs, key);
    const int64_t pidx = lo - pair_key_sorted;
    float* blk = blocks + pidx * bstride;
    const int64_t rr = (int64_t)t_pos[r] * rdim;
    const int64_t cc = (int64_t)s_pos[c] * cdim;
    const float* v = vals + e * (int64_t)rdim * cdim;
    for (int i = 0; i < rdim; ++i)
      for (int j = 0; j < cdim; ++j)
        blk[(rr + i) * KSc + cc + j] = v[i * cdim + j];
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Near-singular candidate filter: emit only the COO entries whose
// target-to-source distance triggers the semi-analytical / fine-
// quadrature branch (ref LaplaceSphericalBEM::eval_G near test,
// sqrt(2 A_s)/dist >= 0.5).  The regular-quadrature bulk is evaluated
// on the accelerator directly in block layout, so the host never
// expands the full 1e8-entry COO.

extern "C" {

int64_t fmm_near_candidates(
    int64_t npairs, const int32_t* pairs,  // (src_box, tgt_box)
    const int32_t* s_body_start, const int32_t* s_body_count,
    const int32_t* t_body_start, const int32_t* t_body_count,
    const double* t_xyz, const double* s_xyz, const double* s_area,
    int32_t* rows_out, int32_t* cols_out, int64_t cap) {
  int64_t n = 0;
  for (int64_t i = 0; i < npairs; ++i) {
    const int32_t s = pairs[2 * i], t = pairs[2 * i + 1];
    for (int32_t bt = 0; bt < t_body_count[t]; ++bt) {
      const int32_t r = t_body_start[t] + bt;
      const double tx = t_xyz[3 * r], ty = t_xyz[3 * r + 1],
                   tz = t_xyz[3 * r + 2];
      for (int32_t bs = 0; bs < s_body_count[s]; ++bs) {
        const int32_t c = s_body_start[s] + bs;
        const double dx = tx - s_xyz[3 * c], dy = ty - s_xyz[3 * c + 1],
                     dz = tz - s_xyz[3 * c + 2];
        const double d2 = dx * dx + dy * dy + dz * dz;
        if (2.0 * s_area[c] >= 0.25 * d2) {  // sqrt(2A)/d >= 0.5
          if (n < cap) {
            rows_out[n] = r;
            cols_out[n] = c;
          }
          ++n;
        }
      }
    }
  }
  return n;
}

}  // extern "C"

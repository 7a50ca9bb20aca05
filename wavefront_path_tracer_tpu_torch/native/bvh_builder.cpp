// Native binned-SAH BVH builder.
//
// Drop-in accelerated replacement for the numpy builder in
// scene/bvh.py (which itself re-expresses the reference's Rust builder,
// wavefront_common/src/bvh.rs).  The host-side BVH build is the one
// CPU-compute-heavy preprocessing step of the renderer (SURVEY.md §2);
// for 10k+ primitive scenes the Python builder's per-node overhead
// dominates scene load, so this is the framework's native component.
//
// Semantics and floating-point evaluation order deliberately mirror
// scene/bvh.py so both builders produce IDENTICAL flat arrays (tests
// assert exact equality):
//   * binned SAH (default 64 bins) over the three axes, plane =
//     node_lo + extent*(k+1)/bins evaluated in f32;
//   * per-bin bounds accumulated in f32, prefix/suffix sweeps, cost =
//     (double)count * (double)area_f32;
//   * leaf iff SAH declines AND count <= max_leaf; otherwise stable
//     median split on the widest axis;
//   * stable partition (lefts keep order, then rights), root at node 0,
//     dummy node at index 1, children adjacent.
//
// Exposed as a C ABI for ctypes; no Python headers needed.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();

struct Vec3 {
  float x, y, z;
  float operator[](int a) const { return a == 0 ? x : (a == 1 ? y : z); }
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

inline float area_f32(const Vec3& lo, const Vec3& hi) {
  float e0 = hi.x - lo.x, e1 = hi.y - lo.y, e2 = hi.z - lo.z;
  return e0 * e1 + e1 * e2 + e2 * e0;
}

struct Split {
  double cost;
  int axis;
  float plane;
  bool valid;
};

struct Builder {
  int bins;
  int max_leaf;
  std::vector<Vec3> centers, lo, hi;
  std::vector<float> radii;
  std::vector<int32_t> perm;

  std::vector<Vec3> node_lo, node_hi;
  std::vector<int32_t> left_first, prim_count;

  int push(const Vec3& l, const Vec3& h, int32_t lf, int32_t pc) {
    node_lo.push_back(l);
    node_hi.push_back(h);
    left_first.push_back(lf);
    prim_count.push_back(pc);
    return static_cast<int>(node_lo.size()) - 1;
  }

  Split best_split(int first, int count, const Vec3& nlo, const Vec3& nhi) {
    Split best{0.0, 0, 0.0f, false};
    Vec3 ext{nhi.x - nlo.x, nhi.y - nlo.y, nhi.z - nlo.z};
    std::vector<int64_t> cnt(bins);
    std::vector<Vec3> blo(bins), bhi(bins);
    std::vector<double> cost(bins - 1);
    for (int axis = 0; axis < 3; ++axis) {
      if (ext[axis] < 1e-5f) continue;
      float scale = static_cast<float>(bins) / ext[axis];
      for (int b = 0; b < bins; ++b) {
        cnt[b] = 0;
        blo[b] = {kInf, kInf, kInf};
        bhi[b] = {-kInf, -kInf, -kInf};
      }
      float axis_lo = nlo[axis];
      for (int i = 0; i < count; ++i) {
        const Vec3& c = centers[first + i];
        float rel = std::max(c[axis] - axis_lo, 0.0f) * scale;
        int64_t b = std::min<int64_t>(static_cast<int64_t>(rel), bins - 1);
        cnt[b]++;
        blo[b] = vmin(blo[b], lo[first + i]);
        bhi[b] = vmax(bhi[b], hi[first + i]);
      }
      // prefix (left) sweep
      {
        int64_t c_acc = 0;
        Vec3 l_acc{kInf, kInf, kInf}, h_acc{-kInf, -kInf, -kInf};
        for (int k = 0; k < bins - 1; ++k) {
          c_acc += cnt[k];
          l_acc = vmin(l_acc, blo[k]);
          h_acc = vmax(h_acc, bhi[k]);
          float a = c_acc > 0 ? area_f32(l_acc, h_acc) : 0.0f;
          cost[k] = static_cast<double>(c_acc) * static_cast<double>(a);
        }
      }
      // suffix (right) sweep
      {
        int64_t c_acc = 0;
        Vec3 l_acc{kInf, kInf, kInf}, h_acc{-kInf, -kInf, -kInf};
        for (int k = bins - 1; k >= 1; --k) {
          c_acc += cnt[k];
          l_acc = vmin(l_acc, blo[k]);
          h_acc = vmax(h_acc, bhi[k]);
          float a = c_acc > 0 ? area_f32(l_acc, h_acc) : 0.0f;
          cost[k - 1] += static_cast<double>(c_acc) * static_cast<double>(a);
        }
      }
      int k_best = 0;
      for (int k = 1; k < bins - 1; ++k)
        if (cost[k] < cost[k_best]) k_best = k;
      // plane in f32, matching numpy's node_lo + extent*(k+1)/bins
      float plane =
          axis_lo + ext[axis] * static_cast<float>(k_best + 1) / static_cast<float>(bins);
      if (!best.valid || cost[k_best] < best.cost) {
        best = {cost[k_best], axis, plane, true};
      }
    }
    return best;
  }

  void partition_stable(int first, int count, const std::vector<char>& mask) {
    // Lefts keep order, then rights (matches numpy concatenate of
    // flatnonzero(mask) and flatnonzero(~mask)).
    std::vector<Vec3> tc(count), tl(count), th(count);
    std::vector<float> tr(count);
    std::vector<int32_t> tp(count);
    int w = 0;
    for (int pass = 0; pass < 2; ++pass) {
      for (int i = 0; i < count; ++i) {
        if ((mask[i] != 0) == (pass == 0)) {
          tc[w] = centers[first + i];
          tl[w] = lo[first + i];
          th[w] = hi[first + i];
          tr[w] = radii[first + i];
          tp[w] = perm[first + i];
          ++w;
        }
      }
    }
    std::copy(tc.begin(), tc.end(), centers.begin() + first);
    std::copy(tl.begin(), tl.end(), lo.begin() + first);
    std::copy(th.begin(), th.end(), hi.begin() + first);
    std::copy(tr.begin(), tr.end(), radii.begin() + first);
    std::copy(tp.begin(), tp.end(), perm.begin() + first);
  }

  void build() {
    int n = static_cast<int>(centers.size());
    Vec3 rlo{kInf, kInf, kInf}, rhi{-kInf, -kInf, -kInf};
    for (int i = 0; i < n; ++i) {
      rlo = vmin(rlo, lo[i]);
      rhi = vmax(rhi, hi[i]);
    }
    push(rlo, rhi, 0, n);
    push({0, 0, 0}, {0, 0, 0}, 0, 0);  // dummy (bvh.rs:161 parity)

    std::vector<int> stack{0};
    std::vector<char> mask;
    std::vector<int32_t> order;
    while (!stack.empty()) {
      int node = stack.back();
      stack.pop_back();
      int first = left_first[node];
      int count = prim_count[node];
      if (count <= 1) continue;
      const Vec3 nlo = node_lo[node], nhi = node_hi[node];

      Split split = best_split(first, count, nlo, nhi);
      double leaf_cost =
          static_cast<double>(count) * static_cast<double>(area_f32(nlo, nhi));
      bool use_sah = split.valid && split.cost < leaf_cost;
      if (!use_sah && count <= max_leaf) continue;

      mask.assign(count, 0);
      int n_left = 0;
      if (use_sah) {
        for (int i = 0; i < count; ++i) {
          mask[i] = centers[first + i][split.axis] < split.plane;
          n_left += mask[i];
        }
        if (n_left == 0 || n_left == count) use_sah = false;
      }
      if (!use_sah) {
        // stable median split on the widest axis
        int axis = 0;
        float e0 = nhi.x - nlo.x, e1 = nhi.y - nlo.y, e2 = nhi.z - nlo.z;
        if (e1 > e0) axis = 1;
        if (e2 > (axis == 0 ? e0 : e1)) axis = 2;
        order.resize(count);
        for (int i = 0; i < count; ++i) order[i] = i;
        std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
          return centers[first + a][axis] < centers[first + b][axis];
        });
        mask.assign(count, 0);
        n_left = count / 2;
        for (int i = 0; i < n_left; ++i) mask[order[i]] = 1;
      }

      partition_stable(first, count, mask);

      Vec3 llo{kInf, kInf, kInf}, lhi{-kInf, -kInf, -kInf};
      for (int i = 0; i < n_left; ++i) {
        llo = vmin(llo, lo[first + i]);
        lhi = vmax(lhi, hi[first + i]);
      }
      Vec3 rlo2{kInf, kInf, kInf}, rhi2{-kInf, -kInf, -kInf};
      for (int i = n_left; i < count; ++i) {
        rlo2 = vmin(rlo2, lo[first + i]);
        rhi2 = vmax(rhi2, hi[first + i]);
      }
      int left = push(llo, lhi, first, n_left);
      push(rlo2, rhi2, first + n_left, count - n_left);
      left_first[node] = left;
      prim_count[node] = 0;
      stack.push_back(left);
      stack.push_back(left + 1);
    }
  }
};

}  // namespace

extern "C" {

// Returns the number of nodes written, or -1 if capacity was too small.
// Output arrays must have capacity for 2*n + 2 nodes.
int wpt_build_bvh(const float* centers, const float* radii, int n, int bins,
                  int max_leaf, float* out_aabb_min, float* out_aabb_max,
                  int32_t* out_left_first, int32_t* out_prim_count,
                  int32_t* out_perm) {
  if (n <= 0) return -1;
  Builder b;
  b.bins = bins;
  b.max_leaf = max_leaf;
  b.centers.resize(n);
  b.lo.resize(n);
  b.hi.resize(n);
  b.radii.assign(radii, radii + n);
  b.perm.resize(n);
  for (int i = 0; i < n; ++i) {
    Vec3 c{centers[3 * i], centers[3 * i + 1], centers[3 * i + 2]};
    float r = radii[i];
    b.centers[i] = c;
    b.lo[i] = {c.x - r, c.y - r, c.z - r};
    b.hi[i] = {c.x + r, c.y + r, c.z + r};
    b.perm[i] = i;
  }
  b.build();

  int num_nodes = static_cast<int>(b.node_lo.size());
  if (num_nodes > 2 * n + 2) return -1;
  for (int i = 0; i < num_nodes; ++i) {
    out_aabb_min[3 * i] = b.node_lo[i].x;
    out_aabb_min[3 * i + 1] = b.node_lo[i].y;
    out_aabb_min[3 * i + 2] = b.node_lo[i].z;
    out_aabb_max[3 * i] = b.node_hi[i].x;
    out_aabb_max[3 * i + 1] = b.node_hi[i].y;
    out_aabb_max[3 * i + 2] = b.node_hi[i].z;
    out_left_first[i] = b.left_first[i];
    out_prim_count[i] = b.prim_count[i];
  }
  std::memcpy(out_perm, b.perm.data(), n * sizeof(int32_t));
  return num_nodes;
}

}  // extern "C"

// Native binned-SAH BVH builder for vimg_tpu_torch (the port's own copy of
// vimg_tpu/runtime/bvh_builder.cpp; the code below is unchanged, so both
// packages build the same tree from the same bounds when compiled with the
// same flags).
//
// Re-implementation of the build algorithm surveyed from the reference
// (src/bvh/bin_bvh.cpp: 16 centroid bins over 3 axes, prefix/suffix cost
// sweeps, SAH vs leaf-cost termination, median fallback), emitting the
// layout used by vimg_tpu_torch/geometry/bvh.py: DFS preorder nodes
// (left child = parent+1) with skip links for threaded traversal.
//
// Parallel like the reference (bin_bvh.cpp:165-184): left subtrees above a
// size threshold build on their own std::thread with an atomic node-pair
// allocator; a final O(N) sequential DFS renumbers the slot-ordered tree to
// the preorder layout (so the output is byte-identical to the sequential
// build — splits and the order permutation don't depend on scheduling).
//
// Exposed via a C ABI for ctypes; no Python headers needed.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr int kBins = 16;
constexpr int kLeafSize = 8;
constexpr float kCostIntersect = 1.0f;
constexpr float kCostTraverse = 0.5f;
constexpr int kThreadThreshold = 1024;  // reference bin_bvh.cpp:170

struct V3 {
  float x, y, z;
};

inline V3 vmin(const V3& a, const V3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(const V3& a, const V3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline float half_sa(const V3& lo, const V3& hi) {
  float dx = std::max(hi.x - lo.x, 0.f);
  float dy = std::max(hi.y - lo.y, 0.f);
  float dz = std::max(hi.z - lo.z, 0.f);
  return dx * dy + dx * dz + dy * dz;
}

struct Builder {
  const V3* bmin;
  const V3* bmax;
  const V3* cen;
  int32_t* order;
  bool sweep = false;   // exact per-axis sweep SAH instead of binning

  // slot-ordered storage (atomically allocated pairs, renumbered later)
  std::vector<V3> node_min, node_max;
  std::vector<int32_t> node_start, node_count, node_left, node_right;
  std::atomic<int32_t> n_nodes{0};
  std::atomic<int32_t> live_threads{0};
  int max_threads = 0;

  int alloc_pair() { return n_nodes.fetch_add(2); }

  // Builds the subtree over order[s, e) into slot ``idx``.
  void build_range(int s, int e, int idx) {
    int n = e - s;
    V3 lo = bmin[order[s]], hi = bmax[order[s]];
    V3 clo = cen[order[s]], chi = clo;
    for (int i = s + 1; i < e; i++) {
      lo = vmin(lo, bmin[order[i]]);
      hi = vmax(hi, bmax[order[i]]);
      clo = vmin(clo, cen[order[i]]);
      chi = vmax(chi, cen[order[i]]);
    }
    node_min[idx] = lo;
    node_max[idx] = hi;

    bool do_leaf = n <= 1;
    int best_axis = -1, best_bin = -1;
    float best_cost = std::numeric_limits<float>::infinity();
    float best_c0 = 0, best_scale = 0;
    int sweep_mid = -1;

    if (!do_leaf && sweep) {
      // exact sweep SAH (reference src/bvh/sweep_bvh.cpp): sort the range
      // per axis, suffix-sweep right costs, prefix-sweep left costs
      static thread_local std::vector<int32_t> scratch;
      static thread_local std::vector<float> rcost;
      scratch.resize(n);
      rcost.resize(n);
      float sweep_best = std::numeric_limits<float>::infinity();
      int sweep_axis = -1;
      for (int axis = 0; axis < 3; axis++) {
        std::copy(order + s, order + e, scratch.begin());
        std::sort(scratch.begin(), scratch.end(), [&](int a, int b) {
          return (&cen[a].x)[axis] < (&cen[b].x)[axis];
        });
        V3 rlo = bmin[scratch[n - 1]], rhi = bmax[scratch[n - 1]];
        rcost[n - 1] = half_sa(rlo, rhi);
        for (int i = n - 2; i >= 1; i--) {
          rlo = vmin(rlo, bmin[scratch[i]]);
          rhi = vmax(rhi, bmax[scratch[i]]);
          rcost[i] = half_sa(rlo, rhi) * (n - i);
        }
        V3 llo = bmin[scratch[0]], lhi = bmax[scratch[0]];
        for (int i = 1; i < n; i++) {
          llo = vmin(llo, bmin[scratch[i - 1]]);
          lhi = vmax(lhi, bmax[scratch[i - 1]]);
          float c = half_sa(llo, lhi) * i + rcost[i];
          if (c < sweep_best) {
            sweep_best = c;
            sweep_axis = axis;
            sweep_mid = i;
          }
        }
      }
      if (sweep_axis >= 0) {
        float sa_node = std::max(half_sa(lo, hi), 1e-12f);
        float split_cost =
            kCostTraverse + kCostIntersect * sweep_best / sa_node;
        if (split_cost >= kCostIntersect * n && n <= kLeafSize) {
          do_leaf = true;
        } else {
          // re-sort the actual range on the winning axis
          std::sort(order + s, order + e, [&](int a, int b) {
            return (&cen[a].x)[sweep_axis] < (&cen[b].x)[sweep_axis];
          });
          best_axis = sweep_axis;  // marks "split found"
        }
      } else {
        do_leaf = n <= kLeafSize;
      }
      if (!do_leaf && best_axis < 0) sweep_mid = -1;  // median fallback
    } else if (!do_leaf) {
      float cext[3] = {chi.x - clo.x, chi.y - clo.y, chi.z - clo.z};
      const float* clo_p = &clo.x;
      for (int axis = 0; axis < 3; axis++) {
        if (cext[axis] <= 0.f) continue;
        float scale = kBins * (1.0f - 1e-6f) / cext[axis];
        int counts[kBins] = {0};
        V3 blo[kBins], bhi[kBins];
        for (int b = 0; b < kBins; b++) {
          blo[b] = {std::numeric_limits<float>::max(),
                    std::numeric_limits<float>::max(),
                    std::numeric_limits<float>::max()};
          bhi[b] = {-std::numeric_limits<float>::max(),
                    -std::numeric_limits<float>::max(),
                    -std::numeric_limits<float>::max()};
        }
        for (int i = s; i < e; i++) {
          int p = order[i];
          float c = (&cen[p].x)[axis];
          int b = std::min((int)((c - clo_p[axis]) * scale), kBins - 1);
          counts[b]++;
          blo[b] = vmin(blo[b], bmin[p]);
          bhi[b] = vmax(bhi[b], bmax[p]);
        }
        // suffix sweep
        float rcost[kBins];
        V3 rlo = blo[kBins - 1], rhi = bhi[kBins - 1];
        int rcount = 0;
        for (int b = kBins - 1; b >= 1; b--) {
          rlo = vmin(rlo, blo[b]);
          rhi = vmax(rhi, bhi[b]);
          rcount += counts[b];
          rcost[b] = rcount > 0 ? half_sa(rlo, rhi) * rcount
                                : std::numeric_limits<float>::infinity();
        }
        // prefix sweep + combine
        V3 llo = blo[0], lhi = bhi[0];
        int lcount = 0;
        for (int b = 0; b < kBins - 1; b++) {
          llo = vmin(llo, blo[b]);
          lhi = vmax(lhi, bhi[b]);
          lcount += counts[b];
          if (lcount == 0 || lcount == n) continue;
          float c = half_sa(llo, lhi) * lcount + rcost[b + 1];
          if (c < best_cost) {
            best_cost = c;
            best_axis = axis;
            best_bin = b;
            best_c0 = clo_p[axis];
            best_scale = scale;
          }
        }
      }

      float sa_node = std::max(half_sa(lo, hi), 1e-12f);
      if (best_axis >= 0) {
        float split_cost = kCostTraverse + kCostIntersect * best_cost / sa_node;
        if (split_cost >= kCostIntersect * n && n <= kLeafSize) do_leaf = true;
      } else {
        if (n <= kLeafSize)
          do_leaf = true;
        // else: median fallback below
      }
    }

    if (do_leaf) {
      node_start[idx] = s;
      node_count[idx] = n;
      return;
    }

    int mid;
    if (sweep && sweep_mid >= 0) {
      mid = sweep_mid;   // order already sorted on the winning axis
    } else if (best_axis < 0 || sweep) {
      // median split on the largest extent axis (no-split / degenerate)
      V3 ext = {hi.x - lo.x, hi.y - lo.y, hi.z - lo.z};
      int axis = 0;
      if (ext.y > (&ext.x)[axis]) axis = 1;
      if (ext.z > (&ext.x)[axis]) axis = 2;
      std::nth_element(order + s, order + s + n / 2, order + e,
                       [&](int a, int b) {
                         return (&cen[a].x)[axis] < (&cen[b].x)[axis];
                       });
      mid = n / 2;
    } else {
      int32_t* first = order + s;
      int32_t* last = order + e;
      int32_t* pivot = std::partition(first, last, [&](int p) {
        int b = std::min(
            (int)(((&cen[p].x)[best_axis] - best_c0) * best_scale),
            kBins - 1);
        return b <= best_bin;
      });
      mid = static_cast<int>(pivot - first);
      if (mid == 0 || mid == n) {
        std::nth_element(order + s, order + s + n / 2, order + e,
                         [&](int a, int b) {
                           return (&cen[a].x)[best_axis] <
                                  (&cen[b].x)[best_axis];
                         });
        mid = n / 2;
      }
    }

    int pair = alloc_pair();
    node_left[idx] = pair;
    node_right[idx] = pair + 1;

    // reference-style task parallelism (bin_bvh.cpp:165-184): left subtree
    // on its own thread above the threshold, bounded by a live-thread cap
    if (n > kThreadThreshold &&
        live_threads.load(std::memory_order_relaxed) < max_threads) {
      live_threads.fetch_add(1, std::memory_order_relaxed);
      std::thread t([this, s, mid, pair]() {
        build_range(s, s + mid, pair);
        live_threads.fetch_sub(1, std::memory_order_relaxed);
      });
      build_range(s + mid, e, pair + 1);
      t.join();
    } else {
      build_range(s, s + mid, pair);
      build_range(s + mid, e, pair + 1);
    }
  }
};

}  // namespace

extern "C" {

// Builds the BVH. Caller allocates outputs for up to 2*n-1 nodes.
// Returns the number of nodes, or -1 on error. mode: 0 = binned SAH,
// 1 = exact sweep SAH (reference -b 0/1, src/bvh/{bin,sweep}_bvh.cpp).
int32_t vimg_build_bvh_mode(int32_t n_prims, int32_t mode,
                            const float* bmin_in, const float* bmax_in,
                            const float* centers_in, float* out_node_min,
                            float* out_node_max, int32_t* out_start,
                            int32_t* out_count, int32_t* out_skip,
                            int32_t* out_order);

int32_t vimg_build_bvh(int32_t n_prims, const float* bmin_in,
                       const float* bmax_in, const float* centers_in,
                       float* out_node_min, float* out_node_max,
                       int32_t* out_start, int32_t* out_count,
                       int32_t* out_skip, int32_t* out_order) {
  return vimg_build_bvh_mode(n_prims, 0, bmin_in, bmax_in, centers_in,
                             out_node_min, out_node_max, out_start,
                             out_count, out_skip, out_order);
}

int32_t vimg_build_bvh_mode(int32_t n_prims, int32_t mode,
                            const float* bmin_in, const float* bmax_in,
                            const float* centers_in, float* out_node_min,
                            float* out_node_max, int32_t* out_start,
                            int32_t* out_count, int32_t* out_skip,
                            int32_t* out_order) {
  if (n_prims <= 0) return -1;
  Builder b;
  b.sweep = (mode == 1);
  b.bmin = reinterpret_cast<const V3*>(bmin_in);
  b.bmax = reinterpret_cast<const V3*>(bmax_in);
  b.cen = reinterpret_cast<const V3*>(centers_in);
  for (int i = 0; i < n_prims; i++) out_order[i] = i;
  b.order = out_order;
  unsigned hw = std::thread::hardware_concurrency();
  b.max_threads = hw > 1 ? static_cast<int>(hw) - 1 : 0;

  size_t cap = 2 * static_cast<size_t>(n_prims);
  b.node_min.resize(cap);
  b.node_max.resize(cap);
  b.node_start.assign(cap, 0);
  b.node_count.assign(cap, 0);
  b.node_left.assign(cap, -1);
  b.node_right.assign(cap, -1);

  b.n_nodes.store(1);
  b.build_range(0, n_prims, 0);
  int32_t total = b.n_nodes.load();

  // sequential O(N) renumbering: slot order -> DFS preorder (left child =
  // parent+1), then arrays + skip links from the preorder map. The tree
  // shape and the order permutation don't depend on thread scheduling, so
  // the final output is byte-identical to a sequential preorder build.
  std::vector<int32_t> pre_of_slot(total, -1);
  std::vector<int32_t> dfs;
  dfs.reserve(total);
  {
    std::vector<int32_t> st2;
    st2.push_back(0);
    int32_t k = 0;
    while (!st2.empty()) {
      int32_t slot = st2.back();
      st2.pop_back();
      pre_of_slot[slot] = k++;
      dfs.push_back(slot);
      if (b.node_count[slot] == 0) {
        st2.push_back(b.node_right[slot]);
        st2.push_back(b.node_left[slot]);
      }
    }
  }
  for (int32_t i = 0; i < total; i++) {
    int32_t slot = dfs[i];
    out_node_min[3 * i + 0] = b.node_min[slot].x;
    out_node_min[3 * i + 1] = b.node_min[slot].y;
    out_node_min[3 * i + 2] = b.node_min[slot].z;
    out_node_max[3 * i + 0] = b.node_max[slot].x;
    out_node_max[3 * i + 1] = b.node_max[slot].y;
    out_node_max[3 * i + 2] = b.node_max[slot].z;
    out_start[i] = b.node_start[slot];
    out_count[i] = b.node_count[slot];
  }
  // skip(root)=total; skip(left)=pre(right sibling); skip(right)=skip(parent)
  {
    std::vector<std::pair<int32_t, int32_t>> st3;  // (slot, skip)
    st3.push_back({0, total});
    while (!st3.empty()) {
      auto [slot, skip] = st3.back();
      st3.pop_back();
      out_skip[pre_of_slot[slot]] = skip;
      if (b.node_count[slot] == 0) {
        st3.push_back({b.node_right[slot], skip});
        st3.push_back({b.node_left[slot], pre_of_slot[b.node_right[slot]]});
      }
    }
  }
  return total;
}
}

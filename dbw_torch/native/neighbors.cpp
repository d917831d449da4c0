// Native spatial-index runtime for the DTU evaluation protocol.
//
// The reference leans on sklearn's C++ KD-tree (reference:
// src/utils/dtu_eval.py:87-136) for (a) greedy 0.2mm-radius downsampling of
// ~1-5M surface samples and (b) bidirectional 1-NN Chamfer queries. This
// library provides both natively:
//   - an exact median-split KD-tree with OpenMP-parallel 1-NN batch queries,
//   - a uniform grid-hash greedy radius filter (exact, insertion-ordered —
//     identical semantics to the reference's mask loop).
//
// Built as a plain shared object; Python binds via ctypes (no pybind11).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct KDNode {
  float split;
  int axis;        // -1 for leaf
  int left, right; // children or [begin,end) for leaves
};

struct KDTree {
  std::vector<float> pts; // (n, 3) flattened, reordered
  std::vector<int> idx;   // original indices, reordered
  std::vector<KDNode> nodes;
  int leaf_size = 16;

  int build(int begin, int end, float* mins, float* maxs) {
    KDNode node;
    if (end - begin <= leaf_size) {
      node.axis = -1;
      node.left = begin;
      node.right = end;
      nodes.push_back(node);
      return (int)nodes.size() - 1;
    }
    // split on the widest axis at the median
    int axis = 0;
    float widest = maxs[0] - mins[0];
    for (int a = 1; a < 3; ++a) {
      float w = maxs[a] - mins[a];
      if (w > widest) { widest = w; axis = a; }
    }
    int mid = (begin + end) / 2;
    // nth_element over point rows
    std::vector<int> order(end - begin);
    for (int i = 0; i < end - begin; ++i) order[i] = begin + i;
    std::nth_element(order.begin(), order.begin() + (mid - begin), order.end(),
                     [&](int a, int b) { return pts[3 * a + axis] < pts[3 * b + axis]; });
    // apply permutation to pts/idx within [begin, end)
    std::vector<float> tmp(3 * (end - begin));
    std::vector<int> tmpi(end - begin);
    for (int i = 0; i < end - begin; ++i) {
      std::memcpy(&tmp[3 * i], &pts[3 * order[i]], 3 * sizeof(float));
      tmpi[i] = idx[order[i]];
    }
    std::memcpy(&pts[3 * begin], tmp.data(), tmp.size() * sizeof(float));
    std::memcpy(&idx[begin], tmpi.data(), tmpi.size() * sizeof(int));

    node.axis = axis;
    node.split = pts[3 * mid + axis];
    int me = (int)nodes.size();
    nodes.push_back(node);
    float saved_max = maxs[axis], saved_min = mins[axis];
    maxs[axis] = node.split;
    int l = build(begin, mid, mins, maxs);
    maxs[axis] = saved_max;
    mins[axis] = node.split;
    int r = build(mid, end, mins, maxs);
    mins[axis] = saved_min;
    nodes[me].left = l;
    nodes[me].right = r;
    return me;
  }

  void query1(const float* q, float& best_d2, int& best_i, int ni) const {
    const KDNode& n = nodes[ni];
    if (n.axis < 0) {
      for (int i = n.left; i < n.right; ++i) {
        float dx = pts[3 * i] - q[0];
        float dy = pts[3 * i + 1] - q[1];
        float dz = pts[3 * i + 2] - q[2];
        float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < best_d2) { best_d2 = d2; best_i = idx[i]; }
      }
      return;
    }
    float diff = q[n.axis] - n.split;
    int first = diff < 0 ? n.left : n.right;
    int second = diff < 0 ? n.right : n.left;
    query1(q, best_d2, best_i, first);
    if (diff * diff < best_d2) query1(q, best_d2, best_i, second);
  }
};

} // namespace

extern "C" {

// Build a KD-tree over (n, 3) float32 points; returns an opaque handle.
void* kdtree_build(const float* pts, int64_t n) {
  KDTree* t = new KDTree();
  t->pts.assign(pts, pts + 3 * n);
  t->idx.resize(n);
  for (int64_t i = 0; i < n; ++i) t->idx[i] = (int)i;
  float mins[3], maxs[3];
  for (int a = 0; a < 3; ++a) { mins[a] = 1e30f; maxs[a] = -1e30f; }
  for (int64_t i = 0; i < n; ++i)
    for (int a = 0; a < 3; ++a) {
      mins[a] = std::min(mins[a], pts[3 * i + a]);
      maxs[a] = std::max(maxs[a], pts[3 * i + a]);
    }
  t->nodes.reserve(2 * n / t->leaf_size + 4);
  t->build(0, (int)n, mins, maxs);
  return t;
}

void kdtree_free(void* handle) { delete (KDTree*)handle; }

// Batch 1-NN: for each of m queries write nearest distance + index.
void kdtree_query1(void* handle, const float* queries, int64_t m,
                   float* out_dist, int32_t* out_idx) {
  KDTree* t = (KDTree*)handle;
#pragma omp parallel for schedule(dynamic, 1024)
  for (int64_t i = 0; i < m; ++i) {
    float best_d2 = 1e30f;
    int best_i = -1;
    t->query1(&queries[3 * i], best_d2, best_i, 0);
    out_dist[i] = std::sqrt(best_d2);
    out_idx[i] = best_i;
  }
}

// Greedy radius downsample: keep point i iff no previously KEPT point lies
// within `radius`. Identical mask semantics to the reference's loop
// (dtu_eval.py:90-94: a kept point suppresses all its neighbors).
void greedy_radius_mask(const float* pts, int64_t n, float radius,
                        uint8_t* keep) {
  const float r2 = radius * radius;
  const float cell = radius;
  auto key = [&](float x, float y, float z) -> uint64_t {
    int64_t ix = (int64_t)std::floor(x / cell);
    int64_t iy = (int64_t)std::floor(y / cell);
    int64_t iz = (int64_t)std::floor(z / cell);
    return ((uint64_t)(ix & 0x1FFFFF) << 42) | ((uint64_t)(iy & 0x1FFFFF) << 21)
           | (uint64_t)(iz & 0x1FFFFF);
  };
  std::unordered_map<uint64_t, std::vector<int64_t>> grid;
  grid.reserve(n / 2);
  for (int64_t i = 0; i < n; ++i) {
    const float* p = &pts[3 * i];
    bool suppressed = false;
    for (int dx = -1; dx <= 1 && !suppressed; ++dx)
      for (int dy = -1; dy <= 1 && !suppressed; ++dy)
        for (int dz = -1; dz <= 1 && !suppressed; ++dz) {
          auto it = grid.find(key(p[0] + dx * cell, p[1] + dy * cell,
                                  p[2] + dz * cell));
          if (it == grid.end()) continue;
          for (int64_t j : it->second) {
            float ax = pts[3 * j] - p[0];
            float ay = pts[3 * j + 1] - p[1];
            float az = pts[3 * j + 2] - p[2];
            if (ax * ax + ay * ay + az * az < r2) { suppressed = true; break; }
          }
        }
    keep[i] = suppressed ? 0 : 1;
    if (!suppressed) grid[key(p[0], p[1], p[2])].push_back(i);
  }
}

} // extern "C"

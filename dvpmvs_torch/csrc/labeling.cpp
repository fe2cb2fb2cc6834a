// Native connected-component labeling (union-find) for the host-side
// image-processing path.
//
// Replaces the reference's OpenCV-based `Connect`/`Label_Update`
// (APD.cpp:233-346, 138-230): 4-connected labeling of ZERO pixels with
// per-label pixel counts.  This is the genuinely serial host work of the
// pipeline (edge segmentation and per-pass visibility-mask cleanup run it
// once per view per round), kept native for throughput; a scipy fallback
// exists when the shared library is not built.
//
// Build:  make -C native   (produces liblabeling.so, loaded via ctypes)

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int32_t> parent;

  explicit UnionFind(size_t n) : parent(n) {
    for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
  }

  int32_t find(int32_t x) {
    int32_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
      int32_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  }

  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (a < b) {
      parent[b] = a;
    } else {
      parent[a] = b;
    }
  }
};

}  // namespace

extern "C" {

// mask [h*w] uint8: nonzero pixels are background (label 0); zero pixels are
// labeled into 4-connected components 1..n.  Writes labels [h*w] int32 and
// counts [h*w+1] int64 (counts[0] = 0).  Returns the number of components.
int32_t label_zero_components(const uint8_t* mask, int32_t h, int32_t w,
                              int32_t* labels, int64_t* counts) {
  const size_t n = static_cast<size_t>(h) * static_cast<size_t>(w);
  UnionFind uf(n);

  // union pass (left + up neighbors)
  for (int32_t y = 0; y < h; ++y) {
    const size_t row = static_cast<size_t>(y) * w;
    for (int32_t x = 0; x < w; ++x) {
      const size_t i = row + x;
      if (mask[i]) continue;
      if (x > 0 && !mask[i - 1]) uf.unite(static_cast<int32_t>(i),
                                          static_cast<int32_t>(i - 1));
      if (y > 0 && !mask[i - w]) uf.unite(static_cast<int32_t>(i),
                                          static_cast<int32_t>(i - w));
    }
  }

  // relabel roots to consecutive ids
  std::vector<int32_t> root_label(n, 0);
  int32_t next_label = 0;
  for (size_t i = 0; i < n; ++i) {
    if (mask[i]) {
      labels[i] = 0;
      continue;
    }
    int32_t r = uf.find(static_cast<int32_t>(i));
    if (root_label[r] == 0) root_label[r] = ++next_label;
    labels[i] = root_label[r];
  }

  std::memset(counts, 0, sizeof(int64_t) * (n + 1));
  for (size_t i = 0; i < n; ++i) {
    if (!mask[i]) ++counts[labels[i]];
  }
  return next_label;
}

}  // extern "C"

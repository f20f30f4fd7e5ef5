// Native graph preprocessing for gwen_tpu_torch (a copy of gwen_tpu/native/graphcore.cpp).
//
// The device compute path is PyTorch/CUDA; host-side graph preprocessing (RCM
// bandwidth-reducing ordering over multi-million-node weather meshes) is the
// runtime's native component — the pure-Python BFS loop takes minutes at
// ICON-mesh scale, this takes well under a second. Exposed via ctypes
// (gwen_tpu_torch/native/__init__.py); the Python implementation remains as a
// fallback (gwen_tpu_torch/graph/reorder.py).
//
// Reference had no native code at all (SURVEY §2.2); its C++ came from
// torch/PyG dependencies (NeighborLoader sampling, DataLoader workers).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Reverse Cuthill-McKee. senders/receivers: e directed edges over n nodes.
// out_perm: n entries, new index i holds old node out_perm[i].
// Returns 0 on success.
int gwen_rcm_order(int64_t n, int64_t e, const int64_t* senders,
                   const int64_t* receivers, int64_t* out_perm) {
  if (n <= 0) return 0;
  // Build undirected CSR.
  std::vector<int64_t> degree(n, 0);
  for (int64_t i = 0; i < e; ++i) {
    if (senders[i] < 0 || senders[i] >= n || receivers[i] < 0 ||
        receivers[i] >= n)
      return 1;
    ++degree[senders[i]];
    ++degree[receivers[i]];
  }
  std::vector<int64_t> indptr(n + 1, 0);
  for (int64_t v = 0; v < n; ++v) indptr[v + 1] = indptr[v] + degree[v];
  std::vector<int64_t> indices(indptr[n]);
  std::vector<int64_t> fill(indptr.begin(), indptr.end() - 1);
  for (int64_t i = 0; i < e; ++i) {
    indices[fill[senders[i]]++] = receivers[i];
    indices[fill[receivers[i]]++] = senders[i];
  }
  // True degree after dedup isn't needed; duplicates only cost a visited
  // check. Order seeds by (degree, id) ascending for determinism.
  std::vector<int64_t> seeds(n);
  for (int64_t v = 0; v < n; ++v) seeds[v] = v;
  std::stable_sort(seeds.begin(), seeds.end(),
                   [&](int64_t a, int64_t b) { return degree[a] < degree[b]; });

  std::vector<char> visited(n, 0);
  std::vector<int64_t> order;
  order.reserve(n);
  std::vector<int64_t> nbrs;
  for (int64_t seed : seeds) {
    if (visited[seed]) continue;
    visited[seed] = 1;
    order.push_back(seed);
    size_t head = order.size() - 1;
    while (head < order.size()) {
      int64_t u = order[head++];
      nbrs.clear();
      for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
        int64_t v = indices[k];
        if (!visited[v]) {
          visited[v] = 1;
          nbrs.push_back(v);
        }
      }
      std::stable_sort(nbrs.begin(), nbrs.end(), [&](int64_t a, int64_t b) {
        return degree[a] < degree[b];
      });
      for (int64_t v : nbrs) order.push_back(v);
    }
  }
  // Reverse (the "R" in RCM).
  for (int64_t i = 0; i < n; ++i) out_perm[i] = order[n - 1 - i];
  return 0;
}

// Graph bandwidth max|s-r|.
int64_t gwen_bandwidth(int64_t e, const int64_t* senders,
                       const int64_t* receivers) {
  int64_t bw = 0;
  for (int64_t i = 0; i < e; ++i) {
    int64_t d = senders[i] - receivers[i];
    if (d < 0) d = -d;
    if (d > bw) bw = d;
  }
  return bw;
}

}  // extern "C"

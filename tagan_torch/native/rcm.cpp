// Reverse Cuthill-McKee order of a node-ID graph, for the port's
// host-side packing (tagan_torch/core/graph.py `locality_order`, which
// `build_sequence(reorder="rcm")` calls). Exposed through a C ABI
// consumed via ctypes (tagan_torch/native/__init__.py); the Python BFS
// `_rcm_order_python` in core/graph.py is the plain version
// (tests/test_torch_reorder.py holds the two to each other).
//
// Build: g++ -O3 -fPIC -std=c++17 -shared, at first use, into
// tagan_torch/_build/ (tagan_torch/native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Reverse Cuthill–McKee order over an undirected graph given as COO
// pairs in [0, n) index space (the union graph of a snapshot sequence).
// Deterministic: BFS components start at the unvisited node with the
// smallest (degree, index); neighbors are visited in ascending
// (degree, index); the visit order is reversed. Degree counts
// deduplicated neighbors, matching the Python set-based adjacency.
// Writes a permutation of 0..n-1 into out_order. Returns 0, or -4 on
// an out-of-range endpoint.
int32_t tagan_rcm_order(const int64_t* src, const int64_t* dst,
                        int64_t n_edges, int64_t n, int64_t* out_order) {
    // symmetric CSR (with duplicates), then per-row sort+unique
    std::vector<int64_t> cnt(n + 1, 0);
    for (int64_t e = 0; e < n_edges; ++e) {
        int64_t a = src[e], b = dst[e];
        if (a < 0 || a >= n || b < 0 || b >= n) return -4;
        if (a == b) continue;
        cnt[a + 1]++;
        cnt[b + 1]++;
    }
    for (int64_t i = 0; i < n; ++i) cnt[i + 1] += cnt[i];
    std::vector<int64_t> adj(cnt[n]);
    std::vector<int64_t> cur(cnt.begin(), cnt.end() - 1);
    for (int64_t e = 0; e < n_edges; ++e) {
        int64_t a = src[e], b = dst[e];
        if (a == b) continue;
        adj[cur[a]++] = b;
        adj[cur[b]++] = a;
    }
    std::vector<int64_t> row_end(n);
    for (int64_t i = 0; i < n; ++i) {
        int64_t lo = cnt[i], hi = cnt[i + 1];
        std::sort(adj.begin() + lo, adj.begin() + hi);
        row_end[i] = std::unique(adj.begin() + lo, adj.begin() + hi)
                     - adj.begin();
    }
    std::vector<int64_t> deg(n);
    for (int64_t i = 0; i < n; ++i) deg[i] = row_end[i] - cnt[i];
    // neighbor lists sorted by (degree, index)
    for (int64_t i = 0; i < n; ++i)
        std::sort(adj.begin() + cnt[i], adj.begin() + row_end[i],
                  [&](int64_t a, int64_t b) {
                      return deg[a] != deg[b] ? deg[a] < deg[b] : a < b;
                  });
    // start nodes in ascending (degree, index)
    std::vector<int64_t> starts(n);
    for (int64_t i = 0; i < n; ++i) starts[i] = i;
    std::sort(starts.begin(), starts.end(),
              [&](int64_t a, int64_t b) {
                  return deg[a] != deg[b] ? deg[a] < deg[b] : a < b;
              });
    std::vector<uint8_t> visited(n, 0);
    std::vector<int64_t> queue;
    queue.reserve(n);
    int64_t emitted = 0;
    for (int64_t s : starts) {
        if (visited[s]) continue;
        visited[s] = 1;
        int64_t head = queue.size();
        queue.push_back(s);
        while (head < (int64_t)queue.size()) {
            int64_t u = queue[head++];
            out_order[emitted++] = u;
            for (int64_t p = cnt[u]; p < row_end[u]; ++p) {
                int64_t w = adj[p];
                if (!visited[w]) {
                    visited[w] = 1;
                    queue.push_back(w);
                }
            }
        }
    }
    std::reverse(out_order, out_order + emitted);
    return 0;
}

}  // extern "C"

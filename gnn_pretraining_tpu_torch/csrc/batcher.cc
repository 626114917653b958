// Host builder of padded graph batches (gnn_pretraining_tpu_torch/data/batch.py).
//
// One pass over the selected graphs of a store's ragged arrays, writing the
// thirteen arrays of a GraphBatch into buffers the caller allocated: node
// features copied, local edge ids relabelled to the batch's global ones,
// masks, graph ids, per-graph starts and counts, labels and (optionally) the
// graph properties; every padding entry is written as 0. The same arrays as
// build_batch_numpy in data/batch.py, the plain version. A plain C
// interface (no Python.h, no numpy C-API), bound with ctypes; built with
//   g++ -O2 -shared -fPIC batcher.cc -o libgnn_batcher.so

#include <cstdint>
#include <cstring>

namespace {

// Return codes; data/batch.py raises the matching Python errors.
constexpr int kOk = 0;
constexpr int kTooManyGraphs = 1;
constexpr int kIndexOutOfRange = 2;
constexpr int kExceedsPadding = 3;

// The (nodes, edges) of the graphs `indices` selects, into `totals`.
int batch_totals(const int64_t* node_offsets, const int64_t* edge_offsets,
                 int64_t num_graphs, const int64_t* indices, int64_t g,
                 int64_t g_pad, int64_t* totals) {
  totals[0] = totals[1] = 0;
  if (g > g_pad) return kTooManyGraphs;
  for (int64_t slot = 0; slot < g; ++slot) {
    const int64_t gi = indices[slot];
    if (gi < 0 || gi >= num_graphs) return kIndexOutOfRange;
    totals[0] += node_offsets[gi + 1] - node_offsets[gi];
    totals[1] += edge_offsets[gi + 1] - edge_offsets[gi];
  }
  return kOk;
}

}  // namespace

// Returns 0, or 1 (more graphs than g_pad), 2 (an index out of range) or 3
// (the batch exceeds n_pad or e_pad), writing nothing then.
// node_features [sum_n, d] f32, edge_index [2, sum_e] i64 (graph-local ids),
// node_offsets / edge_offsets [num_graphs + 1] i64, y [y_len] i64 (a label
// per graph when y_len == num_graphs, else none), props [num_graphs, p] f32
// or null, indices [g] i64. Outputs: x [n_pad, d] f32; senders, receivers,
// edge_graph [e_pad] i32; edge_mask [e_pad] f32; node_mask [n_pad] f32;
// node_graph [n_pad] i32; graph_mask [g_pad] f32; node_start, n_node,
// n_edge, y_out [g_pad] i32; props_out [g_pad, p] f32.
extern "C" int gnn_build_batch(
    const float* node_features, int64_t d, const int64_t* edge_index,
    int64_t sum_e, const int64_t* node_offsets, const int64_t* edge_offsets,
    int64_t num_graphs, const int64_t* y, int64_t y_len, const float* props,
    int64_t p, const int64_t* indices, int64_t g, int64_t n_pad, int64_t e_pad,
    int64_t g_pad, int with_properties, float* x, int32_t* senders,
    int32_t* receivers, float* edge_mask, int32_t* edge_graph, float* node_mask,
    int32_t* node_graph, float* graph_mask, int32_t* node_start, int32_t* n_node,
    int32_t* n_edge, int32_t* y_out, float* props_out) {
  int64_t totals[2];
  const int code = batch_totals(node_offsets, edge_offsets, num_graphs, indices, g,
                                g_pad, totals);
  if (code != kOk) return code;
  if (totals[0] > n_pad || totals[1] > e_pad) return kExceedsPadding;

  std::memset(x, 0, sizeof(float) * n_pad * d);
  std::memset(senders, 0, sizeof(int32_t) * e_pad);
  std::memset(receivers, 0, sizeof(int32_t) * e_pad);
  std::memset(edge_mask, 0, sizeof(float) * e_pad);
  std::memset(edge_graph, 0, sizeof(int32_t) * e_pad);
  std::memset(node_mask, 0, sizeof(float) * n_pad);
  std::memset(node_graph, 0, sizeof(int32_t) * n_pad);
  std::memset(graph_mask, 0, sizeof(float) * g_pad);
  std::memset(node_start, 0, sizeof(int32_t) * g_pad);
  std::memset(n_node, 0, sizeof(int32_t) * g_pad);
  std::memset(n_edge, 0, sizeof(int32_t) * g_pad);
  std::memset(y_out, 0, sizeof(int32_t) * g_pad);
  std::memset(props_out, 0, sizeof(float) * g_pad * p);

  const bool labels = y_len == num_graphs;
  const bool copy_props = with_properties && props != nullptr;
  int64_t node_cursor = 0, edge_cursor = 0;
  for (int64_t slot = 0; slot < g; ++slot) {
    const int64_t gi = indices[slot];
    const int64_t n0 = node_offsets[gi], nn = node_offsets[gi + 1] - n0;
    const int64_t e0 = edge_offsets[gi], ne = edge_offsets[gi + 1] - e0;
    std::memcpy(x + node_cursor * d, node_features + n0 * d, sizeof(float) * nn * d);
    for (int64_t e = 0; e < ne; ++e) {
      senders[edge_cursor + e] = static_cast<int32_t>(edge_index[e0 + e] + node_cursor);
      receivers[edge_cursor + e] =
          static_cast<int32_t>(edge_index[sum_e + e0 + e] + node_cursor);
      edge_mask[edge_cursor + e] = 1.0f;
      edge_graph[edge_cursor + e] = static_cast<int32_t>(slot);
    }
    for (int64_t v = 0; v < nn; ++v) {
      node_mask[node_cursor + v] = 1.0f;
      node_graph[node_cursor + v] = static_cast<int32_t>(slot);
    }
    graph_mask[slot] = 1.0f;
    node_start[slot] = static_cast<int32_t>(node_cursor);
    n_node[slot] = static_cast<int32_t>(nn);
    n_edge[slot] = static_cast<int32_t>(ne);
    if (labels) y_out[slot] = static_cast<int32_t>(y[gi]);
    if (copy_props) std::memcpy(props_out + slot * p, props + gi * p, sizeof(float) * p);
    node_cursor += nn;
    edge_cursor += ne;
  }
  return kOk;
}

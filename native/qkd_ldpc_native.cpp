// Native data-loader / graph-builder for qkd_ldpc_tpu.
//
// The reference implements its entire ingest layer in C++ — the alist
// parser (`read_sparse_alist_matrix`, src/array_and_matrix_operations.cpp:
// 109-292) and the adjacency builders (`get_bit_nodes`/`get_check_nodes`,
// :4-47).  This is the framework's native equivalent: it parses alist
// files and builds the padded index tensors + permutation routing maps the
// decoder consumes (LDPCCode: chk_adj/chk_mask/var_adj/var_mask/
// var_slot/chk_slot/var_deg/chk_deg — see qkd_ldpc_tpu/codes/ldpc_code.py)
// in a single O(E) pass, exposed through a plain C ABI for ctypes.
//
// The Python loader uses this when the shared library is present and falls
// back to the pure-NumPy builder otherwise; both produce bit-identical
// tensors (tests/test_native.py).
//
// Build: make -C native  (or qkd_ldpc_tpu.codes._native builds it lazily).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Graph {
  int32_t n_vars = 0;
  int32_t n_checks = 0;
  int32_t dv_max = 0;
  int32_t dc_max = 0;
  int64_t n_edges = 0;
  int32_t is_regular = 0;
  // Flat edge list in check-major order.
  std::vector<int32_t> e_var;   // [E] variable index of edge
  std::vector<int32_t> chk_deg; // [M]
  std::vector<int32_t> var_deg; // [N]
  std::string error;
};

void set_error(Graph* g, const std::string& msg) { g->error = msg; }

// Build degrees + validate; returns false with g->error set on failure.
bool finalize_graph(Graph* g) {
  const int32_t N = g->n_vars, M = g->n_checks;
  if (N <= 0 || M <= 0) {
    set_error(g, "Empty parity-check matrix");
    return false;
  }
  if (static_cast<int64_t>(g->chk_deg.size()) != M) {
    set_error(g, "Check-degree array size does not match the check count");
    return false;
  }
  {
    // e_var is indexed by the running sum of chk_deg below; an
    // inconsistent (chk_deg, e_var) pair from a caller must not read out
    // of bounds.
    int64_t total = 0;
    for (int32_t c = 0; c < M; ++c) total += g->chk_deg[c];
    if (total != static_cast<int64_t>(g->e_var.size())) {
      set_error(g, "Edge list size does not match the sum of row weights");
      return false;
    }
  }
  g->var_deg.assign(N, 0);
  int64_t e = 0;
  for (int32_t c = 0; c < M; ++c) {
    const int32_t d = g->chk_deg[c];
    if (d <= 0) {
      set_error(g, "Row '" + std::to_string(c + 1) +
                       "' weight cannot be equal to or less than zero.");
      return false;
    }
    for (int32_t j = 0; j < d; ++j, ++e) {
      const int32_t v = g->e_var[e];
      if (v < 0 || v >= N) {
        set_error(g, "Variable index out of range in adjacency list");
        return false;
      }
      g->var_deg[v]++;
    }
  }
  g->dc_max = 0;
  for (int32_t c = 0; c < M; ++c)
    if (g->chk_deg[c] > g->dc_max) g->dc_max = g->chk_deg[c];
  g->dv_max = 0;
  for (int32_t v = 0; v < N; ++v) {
    if (g->var_deg[v] == 0) {
      set_error(g, "Column '" + std::to_string(v + 1) +
                       "' weight cannot be equal to or less than zero.");
      return false;
    }
    if (g->var_deg[v] > g->dv_max) g->dv_max = g->var_deg[v];
  }
  // Duplicate-edge detection via a per-variable last-seen-check stamp
  // (O(E), no hashing): edges are visited in ascending check order.
  {
    std::vector<int32_t> last_chk(N, -1);
    int64_t e2 = 0;
    for (int32_t c = 0; c < M; ++c) {
      for (int32_t j = 0; j < g->chk_deg[c]; ++j, ++e2) {
        const int32_t v = g->e_var[e2];
        if (last_chk[v] == c) {
          set_error(g, "Duplicate edge in parity-check matrix");
          return false;
        }
        last_chk[v] = c;
      }
    }
  }
  // Regularity: all column weights equal AND all row weights equal
  // (reference array_and_matrix_operations.cpp:188-206,395-410).
  bool reg = true;
  for (int32_t c = 1; c < M && reg; ++c) reg = g->chk_deg[c] == g->chk_deg[0];
  for (int32_t v = 1; v < N && reg; ++v) reg = g->var_deg[v] == g->var_deg[0];
  g->is_regular = reg ? 1 : 0;
  return true;
}

// ---------------------------------------------------------------------
// alist parsing.
//
// Format (as the reference parses it, array_and_matrix_operations.cpp:
// 109-292): line 1 "N M"; line 2 "dv_max dc_max"; line 3 per-column
// weights; line 4 per-row weights; then N column-adjacency LINES and M
// row-adjacency LINES of 1-based indices.  Adjacency lines may be
// zero-padded to the max weight or unpadded — parsing is line-based,
// exactly like the Python parser and the reference's getline loop.  The
// row-adjacency block is authoritative for edge order (check-major).

struct LineReader {
  FILE* f;
  std::string buf;
  explicit LineReader(FILE* f) : f(f) {}
  // Read the next line's integers into out; false on EOF.
  bool next_line(std::vector<long>* out) {
    out->clear();
    buf.clear();
    int ch;
    bool any = false;
    while ((ch = std::fgetc(f)) != EOF) {
      any = true;
      if (ch == '\n') break;
      buf.push_back(static_cast<char>(ch));
    }
    if (!any) return false;
    const char* p = buf.c_str();
    char* end;
    for (;;) {
      while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
      if (!*p) break;
      const long v = std::strtol(p, &end, 10);
      if (end == p) return false;  // non-integer token
      // Require whitespace (or end of line) after every number: one
      // integer per token, same strictness as the Python parser.  The
      // reference's stream extraction would parse glued signs
      // ("52+74" -> 52, 74); both of our parsers reject such junk so a
      // corrupted file can never silently misparse into a wrong graph.
      if (*end && *end != ' ' && *end != '\t' && *end != '\r')
        return false;
      out->push_back(v);
      p = end;
    }
    return true;
  }
};

Graph* parse_alist(const char* path) {
  auto* g = new Graph();
  FILE* f = std::fopen(path, "r");
  if (!f) {
    set_error(g, std::string("Failed to open file: ") + path);
    return g;
  }
  LineReader rd(f);
  std::vector<long> ln;

  auto fail = [&](const std::string& msg) {
    set_error(g, msg);
    std::fclose(f);
    return g;
  };

  if (!rd.next_line(&ln) || ln.size() != 2 || ln[0] <= 0 || ln[1] <= 0)
    return fail("File format does not match the alist format");
  const long n = ln[0], m = ln[1];
  if (!rd.next_line(&ln) || ln.size() != 2 || ln[0] <= 0 || ln[1] <= 0)
    return fail("File format does not match the alist format");
  const long dvm = ln[0], dcm = ln[1];
  g->n_vars = static_cast<int32_t>(n);
  g->n_checks = static_cast<int32_t>(m);

  std::vector<int32_t> col_w, row_w;
  if (!rd.next_line(&ln) || static_cast<long>(ln.size()) != n)
    return fail("Number of columns does not match the length of the third line");
  for (long w : ln) {
    if (w <= 0 || w > dvm) return fail("Invalid column weight in alist header");
    col_w.push_back(static_cast<int32_t>(w));
  }
  if (!rd.next_line(&ln) || static_cast<long>(ln.size()) != m)
    return fail("Number of rows does not match the length of the fourth line");
  for (long w : ln) {
    if (w <= 0 || w > dcm) return fail("Invalid row weight in alist header");
    row_w.push_back(static_cast<int32_t>(w));
  }

  // Column adjacency block: validated against the declared weights; its
  // edge set is kept (as sorted (v, c) keys) for cross-validation against
  // the row block below, mirroring the Python parser's check.
  std::vector<int64_t> col_keys;
  col_keys.reserve(static_cast<size_t>(n) * dvm);
  for (long v = 0; v < n; ++v) {
    if (!rd.next_line(&ln)) return fail("Insufficient data in the file");
    int32_t nz = 0;
    for (long c : ln) {
      if (c < 0 || c > m)
        return fail("Check index out of range in alist column block");
      if (c != 0) {
        col_keys.push_back(v * (m + 1) + c);
        ++nz;
      }
    }
    if (nz != col_w[v])
      return fail("Number of non-zero elements in a column line does not "
                  "match the weight in the third line");
  }

  // Row adjacency block: 1-based variable indices.
  g->chk_deg = row_w;
  g->e_var.reserve(static_cast<size_t>(m) * dcm);
  for (long c = 0; c < m; ++c) {
    if (!rd.next_line(&ln)) return fail("Insufficient data in the file");
    int32_t nz = 0;
    for (long v : ln) {
      if (v < 0 || v > n)
        return fail("Variable index out of range in alist row block");
      if (v != 0) {
        g->e_var.push_back(static_cast<int32_t>(v - 1));  // 1-based -> 0-based
        ++nz;
      }
    }
    if (nz != row_w[c])
      return fail("Number of non-zero elements in a row line does not "
                  "match the weight in the fourth line");
  }
  std::fclose(f);
  g->n_edges = static_cast<int64_t>(g->e_var.size());

  // Cross-validate: the column block's edge set must equal the row
  // block's (the Python parser rejects the same inconsistency).
  {
    std::vector<int64_t> row_keys;
    row_keys.reserve(g->e_var.size());
    int64_t e = 0;
    for (long c = 0; c < m; ++c)
      for (int32_t j = 0; j < g->chk_deg[c]; ++j, ++e)
        row_keys.push_back(static_cast<int64_t>(g->e_var[e]) * (m + 1) +
                           (c + 1));
    std::sort(col_keys.begin(), col_keys.end());
    std::sort(row_keys.begin(), row_keys.end());
    if (col_keys != row_keys) {
      // (file already closed above — do not use fail() here)
      set_error(g, "Column adjacency disagrees with row adjacency");
      return g;
    }
  }

  if (!finalize_graph(g)) return g;
  if (g->dv_max > dvm || g->dc_max > dcm) {
    set_error(g, "Max weight mismatch between alist header and body");
    return g;
  }
  // Tensor padding uses the *derived* maxima (same as the NumPy builder),
  // so both loaders produce identical shapes even when a file over-declares
  // its header maxima.
  return g;
}

}  // namespace

extern "C" {

// Parse an alist file.  Returns an opaque handle; check ql_error() before
// using it.  hdr_out = [n_vars, n_checks, dv_max, dc_max, is_regular],
// edges_out = n_edges.
void* ql_alist_open(const char* path, int32_t hdr_out[5], int64_t* edges_out) {
  Graph* g = parse_alist(path);
  hdr_out[0] = g->n_vars;
  hdr_out[1] = g->n_checks;
  hdr_out[2] = g->dv_max;
  hdr_out[3] = g->dc_max;
  hdr_out[4] = g->is_regular;
  *edges_out = g->n_edges;
  return g;
}

// Build a graph from a raw check-major edge list (the dense reader's path:
// Python parses the 0/1 text, this builds the tensors).
void* ql_graph_open(int32_t n_vars, int32_t n_checks,
                    const int32_t* chk_deg, const int32_t* e_var,
                    int64_t n_edges, int32_t hdr_out[5]) {
  auto* g = new Graph();
  g->n_vars = n_vars;
  g->n_checks = n_checks;
  g->chk_deg.assign(chk_deg, chk_deg + n_checks);
  g->e_var.assign(e_var, e_var + n_edges);
  g->n_edges = n_edges;
  finalize_graph(g);
  hdr_out[0] = g->n_vars;
  hdr_out[1] = g->n_checks;
  hdr_out[2] = g->dv_max;
  hdr_out[3] = g->dc_max;
  hdr_out[4] = g->is_regular;
  return g;
}

const char* ql_error(void* handle) {
  auto* g = static_cast<Graph*>(handle);
  return g->error.empty() ? nullptr : g->error.c_str();
}

// Fill caller-allocated int32 buffers with the padded tensors.
// Shapes: chk_adj/chk_mask/chk_slot [M, dc_max]; var_adj/var_mask/var_slot
// [N, dv_max]; var_deg [N]; chk_deg [M].  Masks are 0/1 int32.
// Sentinels: var_slot pad = M*dc_max, chk_slot pad = N*dv_max (matching
// qkd_ldpc_tpu/codes/ldpc_code.py).  Returns 0 on success.
int32_t ql_graph_fill(void* handle, int32_t* chk_adj, int32_t* chk_mask,
                      int32_t* var_adj, int32_t* var_mask, int32_t* var_slot,
                      int32_t* chk_slot, int32_t* var_deg_out,
                      int32_t* chk_deg_out) {
  auto* g = static_cast<Graph*>(handle);
  if (!g->error.empty()) return 1;
  const int32_t N = g->n_vars, M = g->n_checks;
  const int32_t dv = g->dv_max, dc = g->dc_max;

  std::memset(chk_adj, 0, sizeof(int32_t) * M * dc);
  std::memset(chk_mask, 0, sizeof(int32_t) * M * dc);
  std::memset(var_adj, 0, sizeof(int32_t) * N * dv);
  std::memset(var_mask, 0, sizeof(int32_t) * N * dv);
  for (int64_t i = 0; i < static_cast<int64_t>(N) * dv; ++i)
    var_slot[i] = M * dc;  // sentinel
  for (int64_t i = 0; i < static_cast<int64_t>(M) * dc; ++i)
    chk_slot[i] = N * dv;  // sentinel

  std::memcpy(chk_deg_out, g->chk_deg.data(), sizeof(int32_t) * M);
  std::memcpy(var_deg_out, g->var_deg.data(), sizeof(int32_t) * N);

  // Check-major tensors + per-variable bucketing in one pass.  Edges are
  // visited in ascending (check, slot) order, so each variable's edges
  // arrive in ascending check order — the same ordering the NumPy builder
  // gets from its (var, check) lexsort and the reference gets from a
  // column scan of H (array_and_matrix_operations.cpp:4-24).
  std::vector<int32_t> var_fill(N, 0);
  int64_t e = 0;
  for (int32_t c = 0; c < M; ++c) {
    for (int32_t j = 0; j < g->chk_deg[c]; ++j, ++e) {
      const int32_t v = g->e_var[e];
      const int64_t cs = static_cast<int64_t>(c) * dc + j;
      chk_adj[cs] = v;
      chk_mask[cs] = 1;
      const int32_t k = var_fill[v]++;
      const int64_t vs = static_cast<int64_t>(v) * dv + k;
      var_adj[vs] = c;
      var_mask[vs] = 1;
      var_slot[vs] = static_cast<int32_t>(cs);
      chk_slot[cs] = static_cast<int32_t>(vs);
    }
  }
  return 0;
}

void ql_close(void* handle) { delete static_cast<Graph*>(handle); }

}  // extern "C"

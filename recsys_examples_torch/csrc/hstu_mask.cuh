// The jagged HSTU attention's mask and tile plan, shared by the training
// kernels (hstu_attention.cu: K1, K4, K5; hstu_attention_bwd.cu: K2, K3).
// The tile plan is a line-by-line copy of the plain statements in
// recsys_examples_torch/ops/hstu_attention_ref.py (`tile_fully_valid`,
// `causal_edge`, `causal_edge_valid`, `kv_tile_end`, `dkv_query_tiles`),
// which tests/test_torch_hstu_tiles.py holds against the dense mask and the
// JAX kernel's own predicates.
#pragma once

struct Params {
  const int* seq_offsets;       // [B + 1]
  const int* num_contextuals;   // [B] or null
  const int* num_targets;       // [B] or null
  int H;
  float alpha, inv_scaling;
  int causal, group, max_attn_len, min_full;
};

// One sequence: its first packed row, length, contextual and target counts.
struct Seq {
  int off, n, c, t;
  bool has_ctx, has_tgt;
  __device__ Seq(const Params& p, int b) {
    off = p.seq_offsets[b];
    n = p.seq_offsets[b + 1] - off;
    has_ctx = p.num_contextuals != nullptr;
    has_tgt = p.num_targets != nullptr;
    c = has_ctx ? p.num_contextuals[b] : 0;
    t = has_tgt ? p.num_targets[b] : 0;
  }
  // `_compute_mask` for query row `row` and key column `col` (positions in
  // the sequence)
  __device__ bool valid(const Params& p, int row, int col) const {
    if (row >= n || col >= n) return false;
    const int row_ids = max(row - c + 1, 0), col_ids = max(col - c + 1, 0);
    int dist = row_ids - col_ids;
    if (!p.causal) dist = abs(dist);
    bool ok = row == col || dist > 0;
    const int max_id = n - c + 1;
    int hist_max = max_id;
    if (has_tgt) {
      // floor division of values >= -1
      const int xr = max(row_ids - max_id + t, -1), xc = max(col_ids - max_id + t, -1);
      const int gr = xr < 0 ? -1 : xr / p.group, gc = xc < 0 ? -1 : xc / p.group;
      ok = ok && (gr == gc || gr < 0 || gc < 0);
      hist_max = max_id - t;
    }
    if (p.max_attn_len > 0) {
      bool win = dist <= p.max_attn_len;
      if (p.min_full > 0) win = win || row_ids >= hist_max - p.min_full;
      ok = ok && win;
    }
    if (has_ctx) ok = ok || (row_ids == 0 && col_ids < hist_max);
    return ok;
  }
  // `causal_edge`: whether `valid` reduces to `causal_edge_valid` (causal,
  // no targets, no window, 0 <= c <= n)
  __device__ bool causal_edge(const Params& p) const {
    return p.causal && !has_tgt && p.max_attn_len == 0 && 0 <= c && c <= n;
  }
  // `causal_edge_valid`: `valid` under `causal_edge`
  __device__ bool causal_edge_valid(int row, int col) const {
    return row < n && col < n && (row >= col || row < c);
  }
  // `kv_tile_end` (JAX `_kv_extent`): how far into the keys the query tile
  // [q0, q0 + rows) looks
  __device__ int kv_end(const Params& p, int q0, int rows) const {
    if (!p.causal || (has_ctx && q0 < c)) return n;
    return min(n, q0 + rows);
  }
  // `tile_fully_valid` (JAX `_tile_fully_valid`): every pair of query rows
  // [q0, q0 + rows) and key columns [k0, k0 + rows) is valid, so the tile
  // needs no mask
  __device__ bool tile_fully_valid(const Params& p, int q0, int k0, int rows) const {
    if (!p.causal || p.max_attn_len > 0) return false;
    const int n_cols = n - t;
    return q0 >= k0 + rows - 1 && q0 + rows <= n && k0 + rows <= n_cols && c <= n_cols;
  }
};

// `dkv_query_tiles`: the query tiles that reach key tile [k0, k0 + rows).
// When causal: the tiles of the contextual rows [0, c), then the tiles from
// the key tile on; else all. Tile i starts at row `row0(i)`.
struct QueryTiles {
  int n_ctx, first, count, rows;
  __device__ QueryTiles(const Params& p, const Seq& s, int k0, int rows_) : rows(rows_) {
    const int n_q = (s.n + rows - 1) / rows;
    n_ctx = 0;
    first = 0;
    if (p.causal) {
      n_ctx = s.has_ctx ? (min(max(s.c, 0), s.n) + rows - 1) / rows : 0;
      first = max(k0 / rows, n_ctx);
    }
    count = n_ctx + n_q - first;
  }
  __device__ int row0(int i) const { return (i < n_ctx ? i : first + i - n_ctx) * rows; }
};

// The jagged HSTU attention's mask, tile plan and relative bias, shared by
// the forward kernels (hstu_attention_fwd.cu: K1, K4's forward and the int8
// forward K5) and the backward ones (hstu_attention_bwd.cu: K2, K3, K4's dq
// and dk/dv). The tile plan
// is a line-by-line copy of the plain statements in
// recsys_examples_torch/ops/hstu_attention_ref.py (`tile_fully_valid`,
// `causal_edge`, `causal_edge_valid`, `kv_tile_end`, `fwd_cta_tiles`,
// `fwd_tiles`, `dkv_query_tiles`), which tests/test_torch_hstu_tiles.py
// holds against the dense mask and the JAX kernel's own predicates.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

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
  // `fwd_cta_tiles`: the 64-row key tiles that K1's CTA of query rows
  // [m0, m0 + 128) walks
  __device__ int fwd_cta_tiles(const Params& p, int m0) const {
    return (kv_end(p, m0, 128) + 63) / 64;
  }
  // `fwd_tiles`: the 64-row key tiles that K1's consumer of query rows
  // [q0, q0 + 64) computes; none when its rows lie past the sequence
  __device__ int fwd_tiles(const Params& p, int q0) const {
    if (q0 >= n) return 0;
    return (kv_end(p, q0, 64) + 63) / 64;
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

// How a tile applies the mask: not at all (`tile_fully_valid`), in its
// causal form (`causal_edge`), or in full.
enum Mask { NONE, CAUSAL, FULL };

template <Mask MASK>
__device__ __forceinline__ bool mask_ok(const Params& p, const Seq& s, int row, int col) {
  return MASK == NONE     ? true
         : MASK == CAUSAL ? s.causal_edge_valid(row, col)
                          : s.valid(p, row, col);
}

// The relative attention bias of K4. `ptr` null: no bias.
struct Rab {
  const void* ptr;      // [rb, rh, nq, nk], fp32 or bf16
  float* grad;          // fp32, same shape, zero-filled (dq kernel only), or null
  long long sb, sh;     // elements between batches / heads; 0 when broadcast
  int nk;               // elements between rows
  int is_bf16;
  int atomic;           // grad cells are shared between CTAs
  // element offset of this (sequence, head)'s [nq, nk] plane
  __device__ size_t plane(int b, int h) const { return (size_t)(b * sb + h * sh); }
  __device__ float at(size_t plane, int row, int col) const {
    const size_t i = plane + (size_t)row * nk + col;
    return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(ptr)[i])
                   : static_cast<const float*>(ptr)[i];
  }
  __device__ void add_grad(float* dst, float g) const {
    if (atomic) atomicAdd(dst, g); else *dst = g;
  }
  // The gradient of cells dst[0] and dst[1], each where its `ok`: one 8-byte
  // access where both are taken and dst is 8-byte aligned, else one access a
  // cell.
  __device__ void add_grad2(float* dst, float g0, float g1, bool ok0, bool ok1) const {
    if (ok0 && ok1 && (reinterpret_cast<uintptr_t>(dst) & 7) == 0) {
      const float2 g = make_float2(g0, g1);
      if (atomic) atomicAdd(reinterpret_cast<float2*>(dst), g);
      else *reinterpret_cast<float2*>(dst) = g;
      return;
    }
    if (ok0) add_grad(dst, g0);
    if (ok1) add_grad(dst + 1, g1);
  }
};

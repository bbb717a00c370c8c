// Paged SiLU delta attention for KV-cached HSTU inference, for Hopper (sm_90a):
// K6 (bf16 pages) and K6-int8 (int8 pages), two instances of one wgmma
// template, and the fp32-page scalar kernel.
//
// Replaces the TPU kernel recsys_examples_tpu/ops/pallas/paged_hstu_attention.py
// `_kernel` (:91, launched by `paged_hstu_delta_attention` :270, pallas_call
// :362) and its `quantized` branches. The new-token queries of each user
// attend over [the user's cached pages ++ the new tokens' own K/V]:
//   out[b, i] = sum_col silu(alpha * q[b, i] . k[col]) / scaling * mask * v[col]
// with the delta-q mask: valid(row, col) = (col == row) or
// (min(row, hist_end) - min(col, hist_end) > 0), col < kv_len, i < new_len,
// where row = cached + i, kv_len = cached + new_len and
// hist_end = kv_len - num_targets (num_targets = 0 when absent). Padded query
// rows (i >= new_len) come out as exact zeros. Cached positions [0, cached)
// are read from the pages named by page_table (a -1 page id is never read);
// positions cached + t come from new_k/new_v[t], for every t < new_len, also
// past maxp * page_size. P rounds to bf16 before P.V, sums are fp32.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s dense bf16): bytes at
// the serving shape. With B = 8 users of 2048 cached tokens, S = 128
// candidates and H = 4 heads of 256 in bf16, one layer call must read 67.1 MB
// of cached K/V (75.5 MB with q, the new K/V and the output: 22.5 us) for
// 8.6 GFLOP of valid (row, col) pairs (8.7 us). A 512-token prefill chunk
// after 1536 cached tokens is compute-bound: 30.1 GFLOP (30.4 us) against
// 83.9 MB (25.0 us). (chip_smoke.py computes both from the shapes.)
//
// Design (bf16 and int8 pages). The plan is the plain statements of
// recsys_examples_torch/ops/paged_hstu_attention.py, copied line by line:
// `paged_split_plan` (on the host, from shapes only: no device value is
// read), `paged_chunk_counts`, `paged_cta_chunks`, `paged_chunk_fully_valid`
// and `paged_chunk_valid` (tests/test_torch_paged_plan.py holds them).
//  - Split over keys, summed in a cluster. One CTA per (key split, head, user
//    x query block of 64 or 128 rows); grid (splits, H, B * blocks), clusters
//    of `splits` CTAs along x. `splits` is the largest count up to 16 whose
//    clusters the card holds all at once (`paged_cluster_capacity`: an H100
//    holds 39 clusters of 3 and 30 of 4, so the serving shape's 32 (user,
//    head) pairs split 3 ways; a second wave costs more than the split
//    saves). A
//    block's key positions form 64-key chunks: page chunks over
//    [0, min(cached, maxp * pg)), then the new tokens the block's rows can
//    see; a chunk never mixes the two. CTA r takes an even share of them, in
//    order. SiLU attention has no softmax normaliser, so the splits' partial
//    outputs simply add: each CTA puts its fp32 O in its own shared memory
//    (where the tiles were), and after a cluster barrier CTA r's consumers
//    sum rows [r R / splits, (r + 1) R / splits) over the cluster's ranks in
//    rank order, through distributed shared memory, round to bf16 and store
//    them (zeros for rows i >= new_len); a second cluster barrier keeps every
//    CTA's shared memory alive until all have read it. Deterministic, no
//    workspace in device memory, no atomics.
//  - Warp specialisation, as K1 (hstu_attention_fwd.cu). A producer warp
//    loads the CTA's Q once by TMA and streams the chunks' K and V tiles
//    through a full/empty mbarrier ring; one consumer warpgroup (S <= 64:
//    decode) or two of 64 query rows each run S = Q K^T (one m64n64k16
//    chain, K-major), the mask and SiLU in registers, and O += P V with P
//    repacked as register A fragments (`acc_to_a`), V read MN-major. Every
//    instance launches at most 384 threads (168 registers a thread at
//    entry); setmaxnreg gives the consumers 216 (two), 232 (one) or 240
//    (one, int8).
//  - Paged TMA. One 2-D map over the layer's pool viewed as [P pg, H dh]
//    (row stride 2 H dh bytes), one over new_k / new_v as [B S, H dh], both
//    read in boxes of min(pg, 64) rows x one 64-column panel (128-byte
//    swizzle; 32 columns, 64-byte swizzle, at dh 32). Any page size
//    (`paged_page_chunking`): pg >= 64, a chunk is one 64-row box within one
//    page (a remainder chunk's box reads past its page, and its columns past
//    the page are masked); pg < 64 and a multiple of 8, whole pages, one box
//    each, as many as fit in 64 rows (8, 16, 32: 64 keys; 24, 48: 48), every
//    box on whole 8-row swizzle atoms, so each lands where wgmma expects it;
//    any other pg, one page a chunk. The bf16 instance zeroes the tile rows
//    that a chunk of fewer than 64 keys leaves unloaded once, at the start,
//    and masks their columns. An unset
//    page (id -1, or past maxp) is loaded from row P pg, past the pool,
//    which TMA fills with zeros: no stale shared memory reaches P V.
//  - No mask work on certified chunks. A page chunk [c0, c0 + 64) with
//    c0 + 64 <= min(cached, hist_end) and every page set is valid for every
//    live row (col < hist_end, and row >= cached > col): it skips the mask.
//    Other page chunks test their columns (below min(cached, hist_end),
//    page set), new-token chunks the delta mask. Rows are never masked: the
//    padded rows' sums are dropped at the store. Positions of a partial page
//    chunk past `cached` are read from the pool and masked; like the plain
//    version, which gathers whole pages, that assumes finite pool contents
//    (the cache allocates its pool zeroed).
//  - Int8 pages (the `quantized` branches; bf16 q and new tokens): pages
//    [P, pg, H, dh] int8 with fp32 scales [P, pg, H] per (token, head). The
//    producer warp fills a second ring with the int8 rows (half the page
//    bytes, a map over the int8 pool without swizzle) and, in the
//    two-consumer instance, the chunk's K and V scales (a TMA box of
//    [rows, H] fp32 when 4 H is a multiple of 16); otherwise the wideners
//    copy the scales by 4-byte cp.async. Widening warps (the producer
//    warpgroup's three idle ones and, with one consumer, a second warpgroup
//    of four: the widening is latency-bound) turn each arrived chunk into
//    the swizzled bf16 tiles wgmma reads (two integer ops and one bf16x2
//    subtraction a pair of values, exact) and arrive on the consumers' full
//    barrier; they also feed the new-token chunks into the bf16 ring by TMA,
//    so that ring keeps one producer. Scores take sc = (q . k8) alpha ks and
//    probabilities p = silu(sc) / scaling * mask * vs, rounded to bf16
//    before p . v8 (the TPU kernel runs that product in fp32).
//  - Page ids are read from device memory where needed (cached), not kept
//    in shared memory, so no page-table length is refused.
// Shared memory (dh 256; 232,448 bytes a block at most; + 1 KB of alignment
// slack and the barriers):
//   bf16, two consumers: Q 64 KB + 2 stages of K + V (128 KB) = 192 KB;
//   bf16, one consumer:  Q 32 KB + 3 stages (192 KB) = 224 KB;
//   int8, two consumers: Q 64 KB + 1 bf16 stage (64 KB) + 2 int8 stages
//     (64 KB) = 192 KB, + 2 KB of scales a stage at H 4;
//   int8, one consumer:  Q 32 KB + 2 bf16 stages (128 KB) + 2 int8 stages
//     (64 KB) = 224 KB, + 1 KB of scales: no room for TMA-fed scale stages.
// The fp32 O of the cluster sum (R rows of dh + 4 words: 133 KB for 128
// rows) reuses the tiles. Two bf16 stages let widening overlap the
// products; the two-consumer int8 instance has room for one (PERF.md, section 6).
//
// fp32 pages (off the serving path, which runs bf16): `scalar::kernel`, 256
// threads of scalar fp32 FMA per (user, head, 64-row query tile), walking
// key positions in chunks of 32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90_wgmma.cuh"

namespace {

using sm90::bf16;

struct Args {
  const int* page_table;    // [B, maxp]
  const int* cached_len;    // [B]
  const int* new_lens;      // [B]
  const int* num_targets;   // [B] or null
  const float* k_scales;    // int8 pages: [P, pg, H]
  const float* v_scales;
  int S, H, pg, maxp;
  int P;                    // pages in the pool
  int qblocks;              // query blocks per user
  float inv_pg;             // 1 / pg: a chunk column's page offset, (j + 0.5) / pg rounded down
  int scale_tma;            // int8 pages: the scales ride TMA (Smem::TMA_SCALES, 4 H % 16 == 0)
  float alpha, inv_scaling;
  // paged_page_chunking: positions per unit of whole pages, chunks per unit,
  // boxes per chunk and rows per box
  int unit, cpu, nb, br;
};

// ------------------------------------------------ bf16 and int8 pages: wgmma
namespace wg {

using sm90::Tile;

constexpr int CH = 64;                  // key positions per chunk
constexpr int QR = sm90::TILE_ROWS;     // query rows per consumer warpgroup
constexpr int OPAD = 4;                 // fp32 words of padding per row of O
constexpr int CONSUMERS_DONE = 1;       // named barriers
constexpr int WIDENED = 2;

// The CTA's warpgroups: NC consumers, then the producer's (warp 0: TMA;
// int8: warps 1-3 widen) and, for the one-consumer int8 instance, a second
// warpgroup of wideners (widening is latency-bound: PERF.md, section 6).
// setmaxnreg splits the 168 registers a thread holds at entry between the
// consumers (O's DH / 2 sums, the score's 32, P's 16) and the others.
template <int NC, bool I8>
struct Roles {
  static constexpr int EXTRA = I8 && NC == 1;                 // the second wideners' warpgroup
  static constexpr int THREADS = 128 * (NC + 1 + EXTRA);
  static constexpr int WIDEN = I8 ? 96 + 128 * EXTRA : 0;     // widening threads
  static constexpr int CONSUMER = NC == 2 ? 216 : EXTRA ? 240 : 232;
  static constexpr int PRODUCER = NC == 2 ? 72 : EXTRA ? 128 : 104;
  static_assert(NC * 128 * CONSUMER + (THREADS - NC * 128) * PRODUCER <= 168 * THREADS, "");
};

// Shared memory after the barriers, from a 1024-byte boundary: Q's NC tiles,
// ST bf16 stages of (K tile, V tile), (int8) RS stages of int8 K and V rows,
// the bf16 stages' scales, then (TMA_SCALES) the int8 stages' scales. The
// one-consumer int8 instance (decode) keeps two bf16 stages, so widening a
// chunk overlaps the products of the one before, and its wideners copy the
// scales straight into the bf16 stage: TMA-fed scale stages would not fit
// beside them.
template <int DH, int NC, bool I8>
struct Smem {
  using L = Tile<DH>;
  static constexpr int ST = I8 ? (NC == 1 ? 2 : 1) : (NC == 1 ? 3 : 2);   // bf16 stages
  static constexpr int RS = I8 ? 2 : 0;                                   // int8 stages
  static constexpr bool TMA_SCALES = I8 && NC == 2;
  static constexpr int RAW = CH * DH;                     // bytes of an int8 [64][DH] tile
  static constexpr int KV = NC * L::BYTES;                // offsets
  static constexpr int RW = KV + ST * 2 * L::BYTES;
  static constexpr int CSC = RW + RS * 2 * RAW;
  static constexpr int RSC = CSC + (I8 ? ST * 2 * CH * 4 : 0);
  static constexpr int OBUF = NC * QR * (DH + OPAD) * 4;  // the cluster sum's fp32 O
  static_assert(OBUF <= CSC, "O fits where the tiles were");
  struct Bars {
    sm90::Ring<ST> kv;
    sm90::Ring<I8 ? RS : 1> raw;
    uint64_t q_full;
  };
  static size_t bytes(int H) {
    return sizeof(Bars) + 1024 + RSC + (TMA_SCALES ? (size_t)RS * 2 * CH * H * 4 : 0);
  }
};

// The CTA's (user, head, query block) and its chunks: paged_chunk_counts and
// paged_cta_chunks.
struct Cta {
  int b, h, m0, cached, live, hist_end, lim, n_page, c_begin, c_end;
  __device__ Cta(const Args& a, int rows, uint32_t rank, int splits) {
    b = blockIdx.z / a.qblocks;
    m0 = (blockIdx.z % a.qblocks) * rows;
    h = blockIdx.y;
    cached = a.cached_len[b];
    const int new_len = a.new_lens[b];
    live = min(new_len, a.S);
    hist_end = cached + new_len - (a.num_targets ? a.num_targets[b] : 0);
    lim = min(cached, hist_end);
    n_page = 0;
    int n_tail = 0;
    if (live > m0) {
      n_page = page_chunks(a, min(cached, a.maxp * a.pg));
      n_tail = (min(live, m0 + rows) + CH - 1) / CH;
    }
    const int n = n_page + n_tail;
    c_begin = (int)rank * n / splits;
    c_end = ((int)rank + 1) * n / splits;
  }
  // paged_page_chunks: page chunks over the cached positions [0, reach)
  __device__ static int page_chunks(const Args& a, int reach) {
    return reach / a.unit * a.cpu + (reach % a.unit + CH - 1) / CH;
  }
  // paged_chunk_span: page chunk c's first position and keys
  __device__ static void span(const Args& a, int c, int& c0, int& len) {
    const int k = c % a.cpu;
    c0 = c / a.cpu * a.unit + k * CH;
    len = min(CH, a.unit - k * CH);
  }
  __device__ static int page_id(const Args& a, const int* pt, int j) {
    return j < a.maxp ? pt[j] : -1;
  }
  // paged_chunk_fully_valid
  __device__ bool fully_valid(const Args& a, const int* pt, int c) const {
    int c0, len;
    span(a, c, c0, len);
    if (len < CH || c0 + CH > lim) return false;
    for (int j = c0 / a.pg; j <= (c0 + CH - 1) / a.pg; ++j)
      if (page_id(a, pt, j) < 0) return false;
    return true;
  }
  // the pool row of position `pos`, or P pg (past the pool: TMA reads zeros)
  __device__ int pool_row(const Args& a, const int* pt, int pos) const {
    const int pid = page_id(a, pt, pos / a.pg);
    return pid >= 0 ? pid * a.pg + pos % a.pg : a.P * a.pg;
  }
};

using sm90::tile_off;
using sm90::widen16;

enum Form { NONE, PAGE, TAIL };

// P = silu(alpha S (SCALED: x the keys' scales)) / scaling (x the values'
// scales) where chunk c's mask holds (paged_chunk_valid), for query rows
// row0 + acc_row and chunk columns acc_col; 0 elsewhere. Accumulator
// elements 4 g .. 4 g + 3 share the columns 8 g + 2 (t % 4) and + 1, whose
// scales are read together; a compiler barrier after each group keeps them
// from all being loaded at once beside O (the two-consumer int8 instance
// would spill at dh 256).
template <Form FORM, bool SCALED>
__device__ __forceinline__ void silu_part(float (&sc)[32], const Args& a, const Cta& T,
                                          const int* pt, int c, int row0, int t, const float* ks,
                                          const float* vs) {
  const int t0 = (c - T.n_page) * CH;   // TAIL: the chunk's first new token
  int c0 = 0, len = CH, p0 = 0;          // PAGE: the chunk's positions and first page
  if constexpr (FORM == PAGE) {
    Cta::span(a, c, c0, len);
    p0 = c0 / a.pg;
  }
  // PAGE: a chunk lies in one page when pages hold 64 rows or more
  const bool page_set = FORM == PAGE && a.pg >= CH && Cta::page_id(a, pt, p0) >= 0;
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    float2 kg = make_float2(1.f, 1.f), vg = kg;
    if constexpr (SCALED) {
      kg = *reinterpret_cast<const float2*>(ks + sm90::acc_col(t, 4 * g));
      vg = *reinterpret_cast<const float2*>(vs + sm90::acc_col(t, 4 * g));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * g + e, j = sm90::acc_col(t, i);
      float x = sc[i] * a.alpha;
      if constexpr (SCALED) x *= e & 1 ? kg.y : kg.x;
      float p = x * sm90::sigmoid(x) * a.inv_scaling;
      if constexpr (SCALED) p *= e & 1 ? vg.y : vg.x;
      bool ok = true;
      if constexpr (FORM == PAGE) {
        // pg < 64: c0 starts a page, so column j lies in page p0 + j / pg
        const int col = c0 + j;
        ok = j < len && col < T.lim &&
             (a.pg >= CH ? page_set
                         : Cta::page_id(a, pt, p0 + (int)((j + 0.5f) * a.inv_pg)) >= 0);
      } else if constexpr (FORM == TAIL) {
        const int tt = t0 + j, col = T.cached + tt;
        const int row = T.cached + row0 + sm90::acc_row(t, i);
        ok = tt < T.live &&
             (col == row || min(row, T.hist_end) - min(col, T.hist_end) > 0);
      }
      sc[i] = ok ? p : 0.f;
    }
    if constexpr (SCALED) asm volatile("" ::: "memory");
  }
}

// ONE (the one-consumer instances, S <= 64): a warp whose 16 rows all lie
// past new_len skips the pass (its sums are never stored); at decode that
// is 3 warps of 4 (with two consumers the branch costs more than it saves).
template <bool I8, bool ONE>
__device__ __forceinline__ void silu_chunk(float (&sc)[32], const Args& a, const Cta& T,
                                           const int* pt, int c, int row0, int t, const float* ks,
                                           const float* vs) {
  if constexpr (ONE) {
    if (row0 + 16 * (t / 32) >= T.live) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      return;
    }
  }
  if (c >= T.n_page)
    silu_part<TAIL, false>(sc, a, T, pt, c, row0, t, ks, vs);
  else if (T.fully_valid(a, pt, c))
    silu_part<NONE, I8>(sc, a, T, pt, c, row0, t, ks, vs);
  else
    silu_part<PAGE, I8>(sc, a, T, pt, c, row0, t, ks, vs);
}

// The maps a CTA reads: q, new_k, new_v as [B S, H dh] bf16; the pools as
// [P pg, H dh] (bf16 panels, or int8 rows); int8: the scales as [P pg, H].
struct Maps {
  CUtensorMap q, nk, nv, kp, vp, ks, vs;
};

// The producer thread: Q once, then each chunk's K and V (int8: the page
// chunks' int8 rows and scales, into the int8 ring).
template <int DH, int NC, bool I8>
__device__ __forceinline__ void produce(const Maps& m, const Args& a, const Cta& T,
                                        const int* pt, unsigned char* tiles,
                                        typename Smem<DH, NC, I8>::Bars* bars) {
  using S = Smem<DH, NC, I8>;
  using L = Tile<DH>;
  const int n = T.c_end - T.c_begin;
  if (n == 0) return;
  const int col = T.h * DH;
  const int br = a.br, nb = a.nb;   // boxes of a page chunk (nb br rows: 64, or fewer)
  sm90::mbar_expect_tx(&bars->q_full, NC * L::BYTES);
  for (int w = 0; w < NC; ++w)
    sm90::load_tile<DH>(tiles + w * L::BYTES, &m.q, col, T.b * a.S + T.m0 + w * QR,
                        &bars->q_full);
  for (int u = 0; u < n; ++u) {
    const int c = T.c_begin + u;
    if constexpr (I8) {
      // int8 rows and scales into the int8 ring; the wideners feed the
      // bf16 ring, new-token chunks too
      if (c >= T.n_page) break;
      const int rs = u % S::RS;
      unsigned char* rk = tiles + S::RW + rs * 2 * S::RAW;
      unsigned char* rks = tiles + S::RSC + rs * 2 * CH * a.H * 4;
      uint64_t* full = &bars->raw.full[rs];
      int c0, len;
      Cta::span(a, c, c0, len);
      bars->raw.producer_acquire(u, nb * br * (2 * DH + (a.scale_tma ? 2 * a.H * 4 : 0)));
      for (int s = 0; s < nb; ++s) {
        const int row = T.pool_row(a, pt, c0 + s * br);
        sm90::tma_load_2d(rk + s * br * DH, &m.kp, col, row, full);
        sm90::tma_load_2d(rk + S::RAW + s * br * DH, &m.vp, col, row, full);
        if (a.scale_tma) {
          sm90::tma_load_2d(rks + s * br * a.H * 4, &m.ks, 0, row, full);
          sm90::tma_load_2d(rks + (CH + s * br) * a.H * 4, &m.vs, 0, row, full);
        }
      }
    } else {
      const int st = u % S::ST;
      unsigned char* kt = tiles + S::KV + st * 2 * L::BYTES;
      uint64_t* full = &bars->kv.full[st];
      if (c < T.n_page) {
        int c0, len;
        Cta::span(a, c, c0, len);
        bars->kv.producer_acquire(u, 2 * L::BYTES / CH * nb * br);
        for (int s = 0; s < nb; ++s) {
          const int row = T.pool_row(a, pt, c0 + s * br);
          for (int i = 0; i < L::NP; ++i) {
            const int off = i * L::PANEL + s * br * L::PB;
            sm90::tma_load_2d(kt + off, &m.kp, col + i * L::PW, row, full);
            sm90::tma_load_2d(kt + L::BYTES + off, &m.vp, col + i * L::PW, row, full);
          }
        }
      } else {
        bars->kv.producer_acquire(u, 2 * L::BYTES);
        const int row = T.b * a.S + (c - T.n_page) * CH;
        sm90::load_tile<DH>(kt, &m.nk, col, row, full);
        sm90::load_tile<DH>(kt + L::BYTES, &m.nv, col, row, full);
      }
    }
  }
}

// The widening warps (int8) feed the bf16 ring, use by use (a ring takes
// one producer: its parity waits cannot tell a round from the one before
// the last): each page chunk's int8 rows from the int8 ring, widened into
// the bf16 stage with their scales, after which they free the int8 stage
// and arrive on the consumers' full barrier; each new-token chunk by TMA,
// from thread 0. `w` is the thread's index among them.
template <int DH, int NC>
__device__ __forceinline__ void widen(const Maps& m, const Args& a, const Cta& T, const int* pt,
                                      unsigned char* tiles,
                                      typename Smem<DH, NC, true>::Bars* bars, int w) {
  using S = Smem<DH, NC, true>;
  using L = Tile<DH>;
  constexpr int VPR = DH / 16;   // 16-byte int8 vectors per row
  constexpr int WIDEN = Roles<NC, true>::WIDEN;
  const int n = T.c_end - T.c_begin;
  for (int u = 0; u < n; ++u) {
    const int c = T.c_begin + u, st = u % S::ST, rs = u % S::RS;
    unsigned char* kt = tiles + S::KV + st * 2 * L::BYTES;
    if (c >= T.n_page) {   // new tokens: bf16, straight into the stage
      if (w == 0) {
        const int row = T.b * a.S + (c - T.n_page) * CH;
        bars->kv.producer_acquire(u, 2 * L::BYTES);
        sm90::load_tile<DH>(kt, &m.nk, T.h * DH, row, &bars->kv.full[st]);
        sm90::load_tile<DH>(kt + L::BYTES, &m.nv, T.h * DH, row, &bars->kv.full[st]);
      }
      continue;
    }
    float* ks = reinterpret_cast<float*>(tiles + S::CSC) + st * 2 * CH;
    const unsigned char* rk = tiles + S::RW + rs * 2 * S::RAW;
    const float* rks = reinterpret_cast<const float*>(tiles + S::RSC) + rs * 2 * CH * a.H;
    sm90::mbar_wait(&bars->kv.empty[st], ((u / S::ST) & 1) ^ 1);   // the bf16 stage is free
    if (!a.scale_tma) {
      int c0, len;
      Cta::span(a, c, c0, len);
      for (int x = w; x < 2 * CH; x += WIDEN) {
        const int pos = c0 + x % CH;
        const int pid = x % CH < len ? Cta::page_id(a, pt, pos / a.pg) : -1;
        const size_t at = ((size_t)pid * a.pg + pos % a.pg) * a.H + T.h;
        const float* src = x < CH ? a.k_scales : a.v_scales;
        sm90::cp_async4(ks + x, pid >= 0 ? src + at : src, pid >= 0);
      }
      sm90::cp_async_commit();
    }
    bars->raw.consumer_wait(u);
    const uint32_t src = sm90::smem_u32(rk), dst = sm90::smem_u32(kt);
#pragma unroll (NC == 1 ? 2 : 1)
    for (uint32_t v = w; v < 2 * CH * VPR; v += WIDEN) {
      const uint32_t kv = v / (CH * VPR), r = (v / VPR) % CH, c16 = (v % VPR) * 16;
      uint32_t o[8];
      widen16(o, sm90::ld_shared4(src + kv * S::RAW + r * DH + c16));
      const uint32_t d = dst + kv * L::BYTES;
      sm90::st_shared4(d + tile_off<DH>(r, c16), make_uint4(o[0], o[1], o[2], o[3]));
      sm90::st_shared4(d + tile_off<DH>(r, c16 + 8), make_uint4(o[4], o[5], o[6], o[7]));
    }
    if (a.scale_tma) {
      for (int x = w; x < 2 * CH; x += WIDEN) ks[x] = rks[x * a.H + T.h];
    } else {
      sm90::cp_async_wait<0>();
    }
    bars->raw.consumer_release(u);   // the int8 stage is read
    sm90::fence_async_smem();         // the widened tiles, for wgmma
    sm90::named_sync<WIDEN>(WIDENED);
    if (w == 0) sm90::mbar_arrive(&bars->kv.full[st]);
  }
}

// Sum the cluster's partial outputs over this CTA's share of the rows, in
// rank order, and store them as bf16 (rows i >= new_len: zeros). The
// consumer threads call it, between two cluster barriers.
template <int DH, int NC>
__device__ __forceinline__ void cluster_sum(const Args& a, const Cta& T, const float* ob,
                                            bf16* __restrict__ out, uint32_t rank, int splits) {
  constexpr int V4 = DH / 4, LD = DH + OPAD;
  const int r0 = (int)rank * NC * QR / splits, rr = ((int)rank + 1) * NC * QR / splits - r0;
  const uint32_t base = sm90::smem_u32(ob);
  for (int e = threadIdx.x; e < rr * V4; e += NC * 128) {
    const int row = r0 + e / V4, c4 = e % V4;
    const uint32_t addr = base + (row * LD + 4 * c4) * 4;
    float4 s = sm90::ld_cluster4(sm90::map_rank(addr, 0));
    for (int q = 1; q < splits; ++q) {
      const float4 v = sm90::ld_cluster4(sm90::map_rank(addr, q));
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int i = T.m0 + row;
    if (i >= a.S) continue;
    if (i >= T.live) s = make_float4(0.f, 0.f, 0.f, 0.f);   // padded query rows
    const __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y), hi = __floats2bfloat162_rn(s.z, s.w);
    uint2 pk;
    pk.x = *reinterpret_cast<const uint32_t*>(&lo);
    pk.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + (((size_t)T.b * a.S + i) * a.H + T.h) * DH + 4 * c4) = pk;
  }
}

// One CTA: NC consumer warpgroups of 64 query rows, the producer's warpgroup
// and (one-consumer int8) a second wideners' one (`Roles`). 384 threads at
// most: 168 registers a thread at entry; setmaxnreg moves them to the
// consumers.
template <int DH, int NC, bool I8>
__global__ void __launch_bounds__(384, 1)
paged_wgmma_kernel(const __grid_constant__ Maps m, bf16* __restrict__ out, Args a) {
  using R = Roles<NC, I8>;
  using S = Smem<DH, NC, I8>;
  using L = Tile<DH>;
  using O = sm90::Out<DH>;
  extern __shared__ unsigned char smem_raw[];
  auto* bars = reinterpret_cast<typename S::Bars*>(smem_raw);
  unsigned char* tiles = sm90::align1024(smem_raw + sizeof(typename S::Bars));
  float* ob = reinterpret_cast<float*>(tiles);   // after the chunks: the fp32 O

  const uint32_t rank = sm90::cluster_rank();
  const int splits = gridDim.x;
  const Cta T(a, NC * QR, rank, splits);
  const int* pt = a.page_table + (size_t)T.b * a.maxp;   // the user's page ids (cached reads)
  if (threadIdx.x == 0) {
    bars->kv.init(NC * 128);
    if (I8) bars->raw.init(R::WIDEN);
    sm90::mbar_init(&bars->q_full, 1);
    sm90::mbar_init_fence();
  }
  if constexpr (!I8) {
    // page chunks of fewer than 64 keys leave rows [nb br, 64) of the bf16
    // tiles unloaded: zero them once, so their masked columns add p 0 times
    // a finite V (the int8 instance widens every row from int8)
    const int from = a.nb * a.br;
    if (from < CH) {
      constexpr int W4 = L::PB / 16;   // 16-byte words of a panel row
      const int per_tile = L::NP * (CH - from) * W4;
      for (int e = threadIdx.x; e < S::ST * 2 * per_tile; e += blockDim.x) {
        const int tile = e / per_tile, i = e % per_tile / ((CH - from) * W4);
        const int r = from + e % ((CH - from) * W4) / W4, w = e % W4;
        *reinterpret_cast<uint4*>(tiles + S::KV + tile * L::BYTES + i * L::PANEL + r * L::PB +
                                  16 * w) = make_uint4(0, 0, 0, 0);
      }
      sm90::fence_async_smem();   // the zeros, for wgmma and TMA
    }
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg >= NC) {   // the producer's warpgroup (and the second wideners')
    sm90::setmaxnreg_dec<R::PRODUCER>();
    const int pt_idx = threadIdx.x - NC * 128;
    if (pt_idx == 0) produce<DH, NC, I8>(m, a, T, pt, tiles, bars);
    if constexpr (I8) {
      if (pt_idx >= 32) widen<DH, NC>(m, a, T, pt, tiles, bars, pt_idx - 32);
    }
    sm90::cluster_sync();   // every CTA's O is in its shared memory
    sm90::cluster_sync();   // and stays there until the cluster has read it
  } else {          // consumers
    sm90::setmaxnreg_inc<R::CONSUMER>();
    const int t = threadIdx.x % 128;
    const int row0 = T.m0 + wg * QR;   // the consumer's first query row
    const int n = T.c_end - T.c_begin;
    const unsigned char* q_s = tiles + wg * L::BYTES;
    float o[O::NCH][O::CH / 2];
#pragma unroll
    for (int j = 0; j < O::NCH; ++j)
#pragma unroll
      for (int i = 0; i < O::CH / 2; ++i) o[j][i] = 0.f;
    uint32_t pa[16];   // P, as A fragments
    float sc[32];
    if (n > 0) sm90::mbar_wait(&bars->q_full, 0);
    for (int u = 0; u < n; ++u) {
      const int c = T.c_begin + u, st = u % S::ST;
      const unsigned char* kt = tiles + S::KV + st * 2 * L::BYTES;
      const float* ks = reinterpret_cast<const float*>(tiles + S::CSC) + st * 2 * CH;
      bars->kv.consumer_wait(u);
      sm90::wgmma_fence();
      sm90::score_chain<DH>(sc, q_s, kt);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      silu_chunk<I8, NC == 1>(sc, a, T, pt, c, row0, t, ks, ks + CH);
      sm90::acc_to_a(pa, sc);
      sm90::fence_out<DH>(o);
      sm90::wgmma_fence();
      sm90::pv_chain<DH>(o, pa, kt + L::BYTES);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_out<DH>(o);
      bars->kv.consumer_release(u);
    }
    // every consumer is done with Q and the stages: O goes where they were
    sm90::named_sync<NC * 128>(CONSUMERS_DONE);
#pragma unroll
    for (int j = 0; j < O::NCH; ++j)
#pragma unroll
      for (int i = 0; i < O::CH / 2; i += 2)
        *reinterpret_cast<float2*>(ob + (wg * QR + sm90::acc_row(t, i)) * (DH + OPAD) +
                                   j * O::CH + sm90::acc_col(t, i)) =
            make_float2(o[j][i], o[j][i + 1]);
    sm90::cluster_sync();
    cluster_sum<DH, NC>(a, T, ob, out, rank, splits);
    sm90::cluster_sync();
  }
}

}  // namespace wg

// ------------------------------------------------ fp32 pages: scalar FMA
namespace scalar {

// Per-CTA view of one (user, head, query tile).
struct Tile {
  int b, h, m0, cached, new_len, kv_len, hist_end, rows_live, n_pos;
  __device__ Tile(const Args& a, int BM) {
    b = blockIdx.z;
    h = blockIdx.y;
    m0 = blockIdx.x * BM;
    cached = a.cached_len[b];
    new_len = a.new_lens[b];
    kv_len = cached + new_len;
    hist_end = kv_len - (a.num_targets ? a.num_targets[b] : 0);
    rows_live = min(BM, new_len - m0);           // rows i < new_len
    // key positions: [0, cached) from pages, then cached + t for the tail
    // columns t < min(new_len, S, m0 + BM) that the tile's rows can reach
    n_pos = cached + min(min(new_len, a.S), m0 + BM);
  }
  // element offset of key/value position `pos` (< n_pos) in its source, or
  // -1 where there is none (an unset page); *from_pages says which source.
  // `pages` is this user's page-table row.
  template <int DH>
  __device__ long long kv_offset(const Args& a, const int* pages, int pos,
                                 bool* from_pages) const {
    if (pos < cached) {
      *from_pages = true;
      const int j = pos / a.pg;
      const int pid = j < a.maxp ? pages[j] : -1;
      if (pid < 0) return -1;
      return (((long long)pid * a.pg + pos % a.pg) * a.H + h) * DH;
    }
    *from_pages = false;
    return (((long long)b * a.S + (pos - cached)) * a.H + h) * DH;
  }
  __device__ bool valid(int r, int col) const {
    const int row = cached + m0 + r;
    return r < rows_live && col < kv_len &&
           (col == row || min(row, hist_end) - min(col, hist_end) > 0);
  }
  __device__ float prob(float s, const Args& a) const {
    const float x = s * a.alpha;
    return __fdividef(x, 1.f + __expf(-x)) * a.inv_scaling;
  }
};

constexpr int BM = 64;    // query rows per CTA
constexpr int BN = 32;    // key positions per chunk
constexpr int NT = 256;

template <int DH>
struct Smem {
  static constexpr int KS = DH + 4;   // fp32 row stride (+16 B)
  static constexpr int PS = BN + 1;
  static constexpr size_t bytes =
      sizeof(float) * (BM * KS + BM * PS + 2 * BN * KS) + sizeof(int) * BN;
};

template <int DH>
__global__ void __launch_bounds__(NT)
kernel(const float* __restrict__ q, const float* __restrict__ k_pages,
       const float* __restrict__ v_pages, const float* __restrict__ new_k,
       const float* __restrict__ new_v, float* __restrict__ out, Args a) {
  constexpr int KS = Smem<DH>::KS, PS = Smem<DH>::PS;
  constexpr int VPR = DH / 4;              // 16-byte vectors per row
  constexpr int CPT = DH / 16;             // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sP = sQ + BM * KS;
  float* sK = sP + BM * PS;
  float* sV = sK + BN * KS;
  int* sOk = reinterpret_cast<int*>(sV + BN * KS);

  const Tile T(a, BM);
  const int tid = threadIdx.x;
  const int rg = tid / 16;                 // rows rg*4 .. rg*4+3 of the tile
  const int cg = tid % 16;                 // columns cg + 16*j
  const size_t tok_stride = (size_t)a.H * DH;
  const float* qb = q + ((size_t)T.b * a.S * a.H + T.h) * DH;
  float* ob = out + ((size_t)T.b * a.S * a.H + T.h) * DH;

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  if (T.rows_live > 0) {
    for (int e = tid; e < BM * DH; e += NT) {
      const int r = e / DH, d = e % DH;
      const int i = T.m0 + r;
      sQ[r * KS + d] = (r < T.rows_live && i < a.S) ? qb[(size_t)i * tok_stride + d] : 0.f;
    }
    for (int c0 = 0; c0 < T.n_pos; c0 += BN) {
      __syncthreads();   // previous chunk fully consumed
      for (int e = tid; e < BN * VPR; e += NT) {
        const int c = e / VPR, vv = e % VPR;
        const int pos = c0 + c;
        bool paged = false;
        const long long off =
            pos < T.n_pos ? T.kv_offset<DH>(a, a.page_table + (size_t)T.b * a.maxp, pos, &paged) : -1;
        float4 kz = make_float4(0.f, 0.f, 0.f, 0.f), vz = kz;
        if (off >= 0) {
          kz = reinterpret_cast<const float4*>((paged ? k_pages : new_k) + off)[vv];
          vz = reinterpret_cast<const float4*>((paged ? v_pages : new_v) + off)[vv];
        }
        reinterpret_cast<float4*>(sK + c * KS)[vv] = kz;
        reinterpret_cast<float4*>(sV + c * KS)[vv] = vz;
        if (vv == 0) sOk[c] = off >= 0;
      }
      __syncthreads();

      // scores for rows rg*4+i and chunk columns cg + 16*jj, 4 dims a step
      float s[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
      for (int d = 0; d < DH; d += 4) {
        const float4 k0 = *reinterpret_cast<const float4*>(sK + cg * KS + d);
        const float4 k1 = *reinterpret_cast<const float4*>(sK + (cg + 16) * KS + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(sQ + (rg * 4 + i) * KS + d);
          s[i][0] = fmaf(qv.x, k0.x, fmaf(qv.y, k0.y, fmaf(qv.z, k0.z, fmaf(qv.w, k0.w, s[i][0]))));
          s[i][1] = fmaf(qv.x, k1.x, fmaf(qv.y, k1.y, fmaf(qv.z, k1.z, fmaf(qv.w, k1.w, s[i][1]))));
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg * 4 + i;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int c = cg + 16 * jj;
          sP[r * PS + c] = sOk[c] && T.valid(r, c0 + c) ? T.prob(s[i][jj], a) : 0.f;
        }
      }
      __syncthreads();

      // acc[rows][cols] += P[rows, chunk] . V[chunk, cols]
      for (int c = 0; c < BN; ++c) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = sP[(rg * 4 + i) * PS + c];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const float v = sV[c * KS + cg + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], v, acc[i][j]);
        }
      }
    }
  }

  // rows past new_len keep acc = 0: padded query rows come out as zero
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = T.m0 + rg * 4 + i;
    if (r >= a.S) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) ob[(size_t)r * tok_stride + cg + 16 * j] = acc[i][j];
  }
}

}  // namespace scalar


// ------------------------------------------------ host
template <int DH, int NC, bool I8>
int launch_wg(const void* q, const void* kp, const void* vp, const void* nk, const void* nv,
              void* out, Args a, int B, int splits, cudaStream_t st) {
  using S = wg::Smem<DH, NC, I8>;
  const size_t smem = S::bytes(a.H);
  if (smem > 232448) return -4;   // the int8 scale stages of many heads
  a.scale_tma = S::TMA_SCALES && (4 * a.H) % 16 == 0;
  wg::Maps m{};
  const uint32_t br = a.br, pw = sm90::Tile<DH>::PW;
  const uint64_t rows = (uint64_t)a.P * a.pg, cols = (uint64_t)a.H * DH, T = (uint64_t)B * a.S;
  int err = sm90::make_tile_map(&m.q, q, T, cols, cols, wg::QR, pw);
  if (!err) err = sm90::make_tile_map(&m.nk, nk, T, cols, cols, wg::CH, pw);
  if (!err) err = sm90::make_tile_map(&m.nv, nv, T, cols, cols, wg::CH, pw);
  if (I8) {
    const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8, f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    const auto none = CU_TENSOR_MAP_SWIZZLE_NONE;
    if (!err) err = sm90::make_map(&m.kp, u8, 1, kp, rows, cols, cols, br, DH, none);
    if (!err) err = sm90::make_map(&m.vp, u8, 1, vp, rows, cols, cols, br, DH, none);
    if (!err && a.scale_tma) err = sm90::make_map(&m.ks, f32, 4, a.k_scales, rows, a.H, a.H, br, a.H, none);
    if (!err && a.scale_tma) err = sm90::make_map(&m.vs, f32, 4, a.v_scales, rows, a.H, a.H, br, a.H, none);
  } else {
    if (!err) err = sm90::make_tile_map(&m.kp, kp, rows, cols, cols, br, pw);
    if (!err) err = sm90::make_tile_map(&m.vp, vp, rows, cols, cols, br, pw);
  }
  if (err) return err;
  const dim3 grid(splits, a.H, B * a.qblocks);
  return sm90::launch_cluster(wg::paged_wgmma_kernel<DH, NC, I8>, smem, grid,
                              wg::Roles<NC, I8>::THREADS, splits, st, m, static_cast<bf16*>(out),
                              a);
}

// The bf16 (I8 false) or int8 instance at head dim dh with nc consumers.
template <bool I8>
int dispatch_wg(int dh, int nc, const void* q, const void* kp, const void* vp, const void* nk,
                const void* nv, void* out, Args a, int B, int splits, cudaStream_t st) {
  if (nc != 1 && nc != 2) return -1;
  if (splits < 1 || splits > 16) return -1;
  if (a.pg < 1) return -1;
  a.qblocks = (a.S + nc * wg::QR - 1) / (nc * wg::QR);
  a.inv_pg = 1.f / a.pg;
  // paged_page_chunking
  if (a.pg >= wg::CH) {
    a.unit = a.pg;
    a.cpu = (a.pg + wg::CH - 1) / wg::CH;
    a.nb = 1;
    a.br = wg::CH;
  } else {
    a.nb = a.pg % 8 == 0 ? wg::CH / a.pg : 1;
    a.unit = a.nb * a.pg;
    a.cpu = 1;
    a.br = a.pg;
  }
#define PAGED_NC(D)                                                                   \
  return nc == 1 ? launch_wg<D, 1, I8>(q, kp, vp, nk, nv, out, a, B, splits, st)      \
                 : launch_wg<D, 2, I8>(q, kp, vp, nk, nv, out, a, B, splits, st)
  switch (dh) {
    case 32: PAGED_NC(32);
    case 64: PAGED_NC(64);
    case 128: PAGED_NC(128);
    case 256: PAGED_NC(256);
    default: return -1;
  }
#undef PAGED_NC
}

// Clusters of `splits` CTAs of one instance that the card holds at once.
template <int DH, int NC, bool I8>
int cluster_capacity(int H, int splits) {
  const size_t smem = wg::Smem<DH, NC, I8>::bytes(H);
  if (smem > 232448) return -4;
  return sm90::cluster_capacity(wg::paged_wgmma_kernel<DH, NC, I8>, smem,
                                wg::Roles<NC, I8>::THREADS, splits);
}

template <int DH>
int launch_scalar(const void* q, const void* kp, const void* vp, const void* nk, const void* nv,
                  void* out, const Args& a, int B, cudaStream_t st) {
  using F = const float*;
  const dim3 grid((a.S + scalar::BM - 1) / scalar::BM, a.H, B);
  return sm90::launch(scalar::kernel<DH>, scalar::Smem<DH>::bytes, grid, scalar::NT, st,
                      static_cast<F>(q), static_cast<F>(kp), static_cast<F>(vp), static_cast<F>(nk),
                      static_cast<F>(nv), static_cast<float*>(out), a);
}

}  // namespace

// dtype: 0 = bf16 (the wgmma kernel), 1 = fp32 (the scalar kernel); q, pages,
// new K/V and out share it. P: pages in the pool. splits and consumers: the
// plan of `paged_split_plan` (bf16 only: 1 to 16, and 1 or 2; any page size).
// num_targets may be null. Returns the CUDA error code of the launch (0 on
// success), -1 for an unsupported dtype, head dim, page size or plan, -2 / -3
// when a tensor map cannot be made, -4 when the int8 scale stages of H heads
// do not fit in shared memory.
extern "C" int paged_hstu_delta_attention_launch(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const int* page_table, const int* cached_len, const void* new_k,
    const void* new_v, const int* new_lens, const int* num_targets, void* out,
    int B, int S, int H, int dh, int pg, int maxp, int P, int splits, int consumers,
    float alpha, float inv_scaling, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  const Args a{page_table, cached_len, new_lens, num_targets, nullptr, nullptr, S, H, pg, maxp,
               P, 0, 0.f, 0, alpha, inv_scaling};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_wg<false>(dh, consumers, q, k_pages, v_pages, new_k, new_v, out, a, B,
                              splits, st);
  if (dtype != 1) return -1;
  switch (dh) {
    case 32: return launch_scalar<32>(q, k_pages, v_pages, new_k, new_v, out, a, B, st);
    case 64: return launch_scalar<64>(q, k_pages, v_pages, new_k, new_v, out, a, B, st);
    case 128: return launch_scalar<128>(q, k_pages, v_pages, new_k, new_v, out, a, B, st);
    case 256: return launch_scalar<256>(q, k_pages, v_pages, new_k, new_v, out, a, B, st);
    default: return -1;
  }
}

// The int8 page mode: q, new K/V and out bf16; k_pages / v_pages int8
// [P, pg, H, dh] with fp32 scales [P, pg, H] per (token, head). Same
// arguments and return codes.
extern "C" int paged_hstu_delta_attention_int8_launch(
    const void* q, const void* k_pages, const void* v_pages, const float* k_scales,
    const float* v_scales, const int* page_table, const int* cached_len, const void* new_k,
    const void* new_v, const int* new_lens, const int* num_targets, void* out, int B, int S,
    int H, int dh, int pg, int maxp, int P, int splits, int consumers, float alpha,
    float inv_scaling, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  const Args a{page_table, cached_len, new_lens, num_targets, k_scales, v_scales, S, H, pg, maxp,
               P, 0, 0.f, 0, alpha, inv_scaling};
  return dispatch_wg<true>(dh, consumers, q, k_pages, v_pages, new_k, new_v, out, a, B, splits,
                           static_cast<cudaStream_t>(stream));
}

// How many clusters of `splits` CTAs (1 to 16) of the bf16
// (int8 = 0) or int8 instance at head dim dh with `consumers` consumer
// warpgroups the card holds at once; negative on an error (-1 for an
// unsupported instance, -4 when its shared memory does not fit).
extern "C" int paged_cluster_capacity(int int8, int dh, int consumers, int H, int splits) {
  if ((consumers != 1 && consumers != 2) || splits < 1 || splits > 16) return -1;
#define PAGED_CAP(D)                                                                    \
  return int8 ? (consumers == 1 ? cluster_capacity<D, 1, true>(H, splits)         \
                                : cluster_capacity<D, 2, true>(H, splits))        \
              : (consumers == 1 ? cluster_capacity<D, 1, false>(H, splits)        \
                                : cluster_capacity<D, 2, false>(H, splits))
  switch (dh) {
    case 32: PAGED_CAP(32);
    case 64: PAGED_CAP(64);
    case 128: PAGED_CAP(128);
    case 256: PAGED_CAP(256);
    default: return -1;
  }
#undef PAGED_CAP
}

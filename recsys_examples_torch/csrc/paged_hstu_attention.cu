// Paged SiLU delta attention for KV-cached HSTU inference, for Hopper (sm_90a).
//
// Replaces the TPU kernel recsys_examples_tpu/ops/pallas/paged_hstu_attention.py
// `_kernel` (launched by `paged_hstu_delta_attention`). The new-token queries
// of each user attend over [the user's cached pages ++ the new tokens' own
// K/V]:
//   out[b, i] = sum_col silu(alpha * q[b, i] . k[col]) / scaling * mask * v[col]
// with the delta-q mask: valid(row, col) = (col == row) or
// (min(row, hist_end) - min(col, hist_end) > 0), col < kv_len, i < new_len,
// where row = cached + i, kv_len = cached + new_len and
// hist_end = kv_len - num_targets (num_targets = 0 when absent). Padded query
// rows (i >= new_len) come out as zero. Cached positions [0, cached) are read
// from the pages named by page_table (a -1 page id is never read); positions
// cached + t come from new_k/new_v[t], for every t < new_len, also past
// maxp * page_size.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s dense bf16): bytes at
// the serving shape. With B = 8 users of 2048 cached tokens, S = 128
// candidates and H = 4 heads of 256 in bf16, one layer call must read 67.1 MB
// of cached K/V (75.5 MB with q, the new K/V and the output: 22.5 us) for
// 8.6 GFLOP of valid (row, col) pairs (8.7 us). A 512-token prefill chunk
// after 1536 cached tokens is compute-bound: 30.1 GFLOP (30.4 us) against
// 83.9 MB (25.0 us). (chip_smoke.py computes both from the shapes.)
//
// Design. One CTA per (user, head, 64-row tile of new-token queries). The
// CTA walks key positions [0, cached + tail) in chunks, each chunk's K/V rows
// coming from the page pool (the page id read from page_table) or from the
// new tokens, so every needed page byte is read once per query tile; only
// ceil(cached / page_size) pages are visited, and only the tail columns the
// tile's rows can see. P is rounded to the V dtype before P.V, as the TPU
// kernel does, and sums are fp32.
//   bf16 pages (the serving path): 8 warps on mma.sync m16n8k16 tensor-core
//   tiles. Q stays in shared memory; K/V chunks of 32 positions stream
//   through a two-stage cp.async ring, so the next chunk's loads overlap this
//   chunk's math. Each warp computes a 16 x 16 block of S = Q K^T, applies
//   the mask and silu in registers and writes P (bf16) to shared memory;
//   then each warp accumulates 16 rows x DH/2 columns of O += P V. With one
//   CTA per SM at small batch, latency is what limits: eight warps and two
//   independent mma chains in Q K^T hide more of it than four warps did.
//   fp32 pages: 256 threads of scalar fp32 FMA on the same chunk walk.
//   int8 pages (the `quantized` branches of the TPU kernel; bf16 q and new
//   tokens): pages [P, pg, H, dh] int8 with fp32 scales [P, pg, H] per
//   (token, head). The ring carries the int8 rows (half the page bytes) and
//   the chunk's two scale rows; each arrived chunk is widened to bf16 (exact)
//   into one compute tile, and the tensor-core math of the bf16 kernel runs
//   on it with sc = (q . k8) alpha ks and p = silu(sc) / scaling * mask * vs.
//   The TPU kernel runs these two products in fp32; here p vs is rounded to
//   bf16 before p . v8 (v8 itself is exact). Chunks never mix sources: the
//   page positions [0, cached) are walked first, then the new tokens' tail
//   (bf16, copied straight into the compute tile).
// Not done yet: wgmma/TMA, and a split over pages to fill all 132 SMs when
// users x heads x tiles is small (64 CTAs at the serving shape).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct Args {
  const int* page_table;    // [B, maxp]
  const int* cached_len;    // [B]
  const int* new_lens;      // [B]
  const int* num_targets;   // [B] or null
  int S, H, pg, maxp;
  float alpha, inv_scaling;
};

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

// ------------------------------------------------ bf16 pages: tensor cores
namespace tc {

constexpr int BM = 64;    // query rows per CTA: 4 row blocks of 16
constexpr int BN = 32;    // key positions per ring stage
constexpr int NT = 256;   // 8 warps: row block warp % 4, half warp / 4

template <int DH>
struct Smem {
  static constexpr int KS = DH + 8;   // Q/K/V row stride: +16 B, conflict-free
  static constexpr int PS = BN + 8;   // P row stride
  // + the user's page-table row (maxp ints) after these
  static constexpr size_t bytes =
      sizeof(bf16) * (BM * KS + 4 * BN * KS + BM * PS) + sizeof(int) * 2 * BN;
};

using sm90::cp_async16;
using sm90::cp_async4;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::ld32;
using sm90::ldmatrix_x4;
using sm90::ldmatrix_x4_trans;
using sm90::mma;
using sm90::pack_bf16;
using sm90::widen16;

// One chunk of BN key positions starting at `pos0`: the warp's 16 x 16 block
// of S = Q K^T, mask and silu in registers, P (bf16) through shared memory,
// then the warp's 16 rows x DH/2 columns of O += P V. Every thread of the
// CTA calls it; the last sync frees the K/V tiles and P. With SCALED (int8
// pages) the scores take the keys' scales and P the values'.
template <int DH, bool SCALED>
__device__ __forceinline__ void chunk_math(
    float (&o)[DH / 16][4], const bf16* q_s, const bf16* k_s, const bf16* v_s,
    const int* ok_s, const float* ks_s, const float* vs_s, bf16* sP, const Tile& T,
    const Args& a, int pos0, int rb, int hf, int lane) {
  constexpr int KS = Smem<DH>::KS, PS = Smem<DH>::PS;
  constexpr int OC = DH / 2;               // output columns per warp
  constexpr int CW = BN / 2;               // score columns per warp
  const int g = lane / 4, t = lane % 4;
  const int mi = lane / 8, rr = lane % 8;  // ldmatrix: matrix and row of lane

  // S = Q K^T on 16 rows x BN/2 columns; even and odd k-steps
  // accumulate apart, so more mma chains are in flight
  float s[2][CW / 8][4];
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int j = 0; j < CW / 8; ++j) s[x][j][0] = s[x][j][1] = s[x][j][2] = s[x][j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const bf16* qr = q_s + g * KS + kk * 16 + 2 * t;
    const uint32_t qa[4] = {ld32(qr), ld32(qr + 8 * KS), ld32(qr + 8),
                            ld32(qr + 8 * KS + 8)};
#pragma unroll
    for (int j = 0; j < CW / 8; ++j) {
      const bf16* kr = k_s + (hf * CW + j * 8 + g) * KS + kk * 16 + 2 * t;
      mma(s[kk & 1][j], qa, ld32(kr), ld32(kr + 8));
    }
  }
  // mask, silu and scale; P rounds to bf16 into shared memory
#pragma unroll
  for (int j = 0; j < CW / 8; ++j) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rb * 16 + g + (e >> 1) * 8;
      const int cl = hf * CW + j * 8 + 2 * t + (e & 1);
      float sc = s[0][j][e] + s[1][j][e];
      if constexpr (SCALED) sc *= ks_s[cl];
      v[e] = ok_s[cl] && T.valid(r, pos0 + cl) ? T.prob(sc, a) : 0.f;
      if constexpr (SCALED) v[e] *= vs_s[cl];
    }
    bf16* pr = sP + (rb * 16 + g) * PS + hf * CW + j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(pr) = pack_bf16(v[0], v[1]);
    *reinterpret_cast<uint32_t*>(pr + 8 * PS) = pack_bf16(v[2], v[3]);
  }
  __syncthreads();

  // O += P V on 16 rows x DH/2 columns: P through ldmatrix, V through
  // ldmatrix.trans, two n-tiles at a time
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    uint32_t pa[4];
    ldmatrix_x4(pa, sP + (rb * 16 + rr + (mi & 1) * 8) * PS + kk * 16 + (mi >> 1) * 8);
#pragma unroll
    for (int np = 0; np < OC / 16; ++np) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, v_s + (kk * 16 + rr + (mi & 1) * 8) * KS +
                                hf * OC + np * 16 + (mi >> 1) * 8);
      mma(o[2 * np], pa, bv[0], bv[1]);
      mma(o[2 * np + 1], pa, bv[2], bv[3]);
    }
  }
  __syncthreads();   // the K/V tiles and P are free again
}

// The warp's accumulator rows to `ob` (row 0 of this user and head); rows
// past new_len kept o = 0, so padded query rows come out as zero.
template <int DH>
__device__ __forceinline__ void store_out(bf16* ob, size_t tok_stride,
                                          const float (&o)[DH / 16][4], const Tile& T,
                                          int S, int rb, int hf, int lane) {
  constexpr int OC = DH / 2;
  const int g = lane / 4, t = lane % 4;
  const int r0 = T.m0 + rb * 16 + g;
#pragma unroll
  for (int j = 0; j < OC / 8; ++j) {
    const int col = hf * OC + j * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r0 * tok_stride + col) =
          __floats2bfloat162_rn(o[j][0], o[j][1]);
    if (r0 + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)(r0 + 8) * tok_stride + col) =
          __floats2bfloat162_rn(o[j][2], o[j][3]);
  }
}

// Warp w owns query rows 16 * (w % 4) .. +15. For S = Q K^T it takes chunk
// columns (BN / 2) * (w / 4) .. +BN/2 and for O += P V head-dim columns
// (DH / 2) * (w / 4) .. +DH/2, so the eight warps share the work of a chunk
// without recomputing any of it; P passes between them through shared memory.
template <int DH>
__global__ void __launch_bounds__(NT, 2)
kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
       const bf16* __restrict__ v_pages, const bf16* __restrict__ new_k,
       const bf16* __restrict__ new_v, bf16* __restrict__ out, Args a) {
  constexpr int KS = Smem<DH>::KS, PS = Smem<DH>::PS;
  constexpr int VPR = DH / 8;              // 16-byte vectors per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BM][KS]
  bf16* sK = sQ + BM * KS;                       // [2][BN][KS]
  bf16* sV = sK + 2 * BN * KS;                   // [2][BN][KS]
  bf16* sP = sV + 2 * BN * KS;                   // [BM][PS]
  int* sOk = reinterpret_cast<int*>(sP + BM * PS);  // [2][BN]
  int* sPT = sOk + 2 * BN;                          // [maxp]

  const Tile T(a, BM);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rb = warp % 4, hf = warp / 4;
  const size_t tok_stride = (size_t)a.H * DH;
  const bf16* qb = q + ((size_t)T.b * a.S * a.H + T.h) * DH;
  bf16* ob = out + ((size_t)T.b * a.S * a.H + T.h) * DH;

  float o[DH / 16][4];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  if (T.rows_live > 0) {
    // the user's page ids, read once; the Q tile joins the first chunk's
    // copy group
    for (int j = tid; j < a.maxp; j += NT) sPT[j] = a.page_table[(size_t)T.b * a.maxp + j];
    for (int e = tid; e < BM * VPR; e += NT) {
      const int r = e / VPR, vv = e % VPR;
      const int i = T.m0 + r;
      const bool ok = r < T.rows_live && i < a.S;
      cp_async16(sQ + r * KS + vv * 8, ok ? qb + (size_t)i * tok_stride + vv * 8 : q, ok);
    }
    __syncthreads();
    auto load_chunk = [&](int ci, int buf) {
      constexpr int PER_THREAD = (BN * VPR + NT - 1) / NT;
      long long off[PER_THREAD];
      bool paged[PER_THREAD];
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        const int pos = ci * BN + (tid + k * NT) / VPR;
        off[k] = pos < T.n_pos ? T.kv_offset<DH>(a, sPT, pos, &paged[k]) : -1;
      }
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        const int e = tid + k * NT;
        if (e >= BN * VPR) break;
        const int c = e / VPR, vv = e % VPR;
        const bool ok = off[k] >= 0;
        const bf16* ks = ok ? (paged[k] ? k_pages : new_k) + off[k] + vv * 8 : k_pages;
        const bf16* vs = ok ? (paged[k] ? v_pages : new_v) + off[k] + vv * 8 : v_pages;
        cp_async16(sK + (buf * BN + c) * KS + vv * 8, ks, ok);
        cp_async16(sV + (buf * BN + c) * KS + vv * 8, vs, ok);
        if (vv == 0) sOk[buf * BN + c] = ok;
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };

    const int n_chunks = (T.n_pos + BN - 1) / BN;
    const bf16* q_s = sQ + rb * 16 * KS;
    load_chunk(0, 0);
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int buf = ci & 1;
      if (ci + 1 < n_chunks) {
        load_chunk(ci + 1, buf ^ 1);   // that stage was freed by the last sync
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncthreads();
      const bf16* k_s = sK + buf * BN * KS;
      const bf16* v_s = sV + buf * BN * KS;
      const int* ok_s = sOk + buf * BN;

      chunk_math<DH, false>(o, q_s, k_s, v_s, ok_s, nullptr, nullptr, sP, T, a, ci * BN,
                            rb, hf, lane);
    }
  }

  store_out<DH>(ob, tok_stride, o, T, a.S, rb, hf, lane);
}

// ---- int8 pages
template <int DH>
struct SmemI8 {
  static constexpr int KS = Smem<DH>::KS, PS = Smem<DH>::PS;
  static constexpr int RS = DH + 16;  // int8 ring row stride in bytes: +16 B
  // Q, one K and one V compute tile, P; the int8 ring; scales and validity
  // per stage; + the user's page-table row (maxp ints) after these
  static constexpr size_t bytes = sizeof(bf16) * (BM * KS + 2 * BN * KS + BM * PS) +
                                  4 * BN * RS + sizeof(float) * 4 * BN +
                                  sizeof(int) * 2 * BN;
};

template <int DH>
__global__ void __launch_bounds__(NT, 2)
kernel_i8(const bf16* __restrict__ q, const int8_t* __restrict__ k_pages,
          const int8_t* __restrict__ v_pages, const float* __restrict__ k_scales,
          const float* __restrict__ v_scales, const bf16* __restrict__ new_k,
          const bf16* __restrict__ new_v, bf16* __restrict__ out, Args a) {
  constexpr int KS = SmemI8<DH>::KS, PS = SmemI8<DH>::PS, RS = SmemI8<DH>::RS;
  constexpr int VPR = DH / 8;              // 16-byte vectors per bf16 row
  constexpr int VPR8 = DH / 16;            // 16-byte vectors per int8 row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);      // [BM][KS]
  bf16* cK = sQ + BM * KS;                           // [BN][KS] compute tile
  bf16* cV = cK + BN * KS;                           // [BN][KS]
  bf16* sP = cV + BN * KS;                           // [BM][PS]
  int8_t* rK = reinterpret_cast<int8_t*>(sP + BM * PS);   // [2][BN][RS] ring
  int8_t* rV = rK + 2 * BN * RS;                          // [2][BN][RS]
  float* sKs = reinterpret_cast<float*>(rV + 2 * BN * RS);   // [2][BN]
  float* sVs = sKs + 2 * BN;                                  // [2][BN]
  int* sOk = reinterpret_cast<int*>(sVs + 2 * BN);            // [2][BN]
  int* sPT = sOk + 2 * BN;                                    // [maxp]

  const Tile T(a, BM);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rb = warp % 4, hf = warp / 4;
  const size_t tok_stride = (size_t)a.H * DH;
  const bf16* qb = q + ((size_t)T.b * a.S * a.H + T.h) * DH;
  bf16* ob = out + ((size_t)T.b * a.S * a.H + T.h) * DH;

  float o[DH / 16][4];
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  if (T.rows_live > 0) {
    for (int j = tid; j < a.maxp; j += NT) sPT[j] = a.page_table[(size_t)T.b * a.maxp + j];
    for (int e = tid; e < BM * VPR; e += NT) {   // joins the first copy group
      const int r = e / VPR, vv = e % VPR;
      const int i = T.m0 + r;
      const bool ok = r < T.rows_live && i < a.S;
      cp_async16(sQ + r * KS + vv * 8, ok ? qb + (size_t)i * tok_stride + vv * 8 : q, ok);
    }
    __syncthreads();
    // page positions [ci * BN, +BN) below `cached`: int8 rows and their scales
    auto load_pages = [&](int ci, int buf) {
      for (int e = tid; e < BN * VPR8; e += NT) {
        const int c = e / VPR8, vv = e % VPR8;
        const int pos = ci * BN + c;
        bool paged;
        const long long off = pos < T.cached ? T.kv_offset<DH>(a, sPT, pos, &paged) : -1;
        const bool ok = off >= 0;
        cp_async16(rK + (buf * BN + c) * RS + vv * 16, ok ? k_pages + off + vv * 16 : k_pages, ok);
        cp_async16(rV + (buf * BN + c) * RS + vv * 16, ok ? v_pages + off + vv * 16 : v_pages, ok);
        if (vv == 0) {
          const long long soff = ok ? off / DH : 0;   // (page, slot, head)
          cp_async4(sKs + buf * BN + c, k_scales + soff, ok);
          cp_async4(sVs + buf * BN + c, v_scales + soff, ok);
          sOk[buf * BN + c] = ok;
        }
      }
      cp_async_commit();
    };

    const bf16* q_s = sQ + rb * 16 * KS;
    const int n_page_chunks = (T.cached + BN - 1) / BN;
    if (n_page_chunks > 0) load_pages(0, 0);
    for (int ci = 0; ci < n_page_chunks; ++ci) {
      const int buf = ci & 1;
      if (ci + 1 < n_page_chunks) {
        load_pages(ci + 1, buf ^ 1);   // that stage was freed by the last sync
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      // widen the arrived int8 rows into the compute tiles
      for (int e = tid; e < BN * VPR8; e += NT) {
        const int c = e / VPR8, vv = e % VPR8;
        widen16(cK + c * KS + vv * 16,
                *reinterpret_cast<const int4*>(rK + (buf * BN + c) * RS + vv * 16));
        widen16(cV + c * KS + vv * 16,
                *reinterpret_cast<const int4*>(rV + (buf * BN + c) * RS + vv * 16));
      }
      __syncthreads();
      chunk_math<DH, true>(o, q_s, cK, cV, sOk + buf * BN, sKs + buf * BN, sVs + buf * BN,
                           sP, T, a, ci * BN, rb, hf, lane);
    }
    // the new tokens' tail, bf16, straight into the compute tiles
    for (int pos0 = T.cached; pos0 < T.n_pos; pos0 += BN) {
      for (int e = tid; e < BN * VPR; e += NT) {
        const int c = e / VPR, vv = e % VPR;
        const bool ok = pos0 + c < T.n_pos;
        const size_t off =
            (((size_t)T.b * a.S + (pos0 + c - T.cached)) * a.H + T.h) * DH + vv * 8;
        cp_async16(cK + c * KS + vv * 8, ok ? new_k + off : new_k, ok);
        cp_async16(cV + c * KS + vv * 8, ok ? new_v + off : new_v, ok);
        if (vv == 0) sOk[c] = ok;
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      chunk_math<DH, false>(o, q_s, cK, cV, sOk, nullptr, nullptr, sP, T, a, pos0, rb, hf,
                            lane);
    }
  }
  store_out<DH>(ob, tok_stride, o, T, a.S, rb, hf, lane);
}

}  // namespace tc

// ------------------------------------------------ fp32 pages: scalar FMA
namespace scalar {

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

template <typename E, typename Kern>
int launch_kernel(Kern kern, size_t smem, int bm, int nt, const void* q,
                  const void* kp, const void* vp, const void* nk, const void* nv,
                  void* out, const Args& a, int B, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + bm - 1) / bm, a.H, B);
  kern<<<grid, nt, smem, st>>>(
      static_cast<const E*>(q), static_cast<const E*>(kp),
      static_cast<const E*>(vp), static_cast<const E*>(nk),
      static_cast<const E*>(nv), static_cast<E*>(out), a);
  return (int)cudaGetLastError();
}

template <typename E, int DH>
int launch(const void* q, const void* kp, const void* vp, const void* nk,
           const void* nv, void* out, const Args& a, int B, cudaStream_t st) {
  if constexpr (sizeof(E) == 2)
    return launch_kernel<E>(tc::kernel<DH>, tc::Smem<DH>::bytes + sizeof(int) * a.maxp,
                            tc::BM, tc::NT,
                            q, kp, vp, nk, nv, out, a, B, st);
  else
    return launch_kernel<E>(scalar::kernel<DH>, scalar::Smem<DH>::bytes,
                            scalar::BM, scalar::NT, q, kp, vp, nk, nv, out, a,
                            B, st);
}

template <typename E>
int dispatch_dh(int dh, const void* q, const void* kp, const void* vp,
                const void* nk, const void* nv, void* out, const Args& a, int B,
                cudaStream_t st) {
  switch (dh) {
    case 32: return launch<E, 32>(q, kp, vp, nk, nv, out, a, B, st);
    case 64: return launch<E, 64>(q, kp, vp, nk, nv, out, a, B, st);
    case 128: return launch<E, 128>(q, kp, vp, nk, nv, out, a, B, st);
    case 256: return launch<E, 256>(q, kp, vp, nk, nv, out, a, B, st);
    default: return -1;
  }
}

template <int DH>
int launch_i8(const void* q, const void* kp, const void* vp, const float* ks, const float* vs,
              const void* nk, const void* nv, void* out, const Args& a, int B,
              cudaStream_t st) {
  const size_t smem = tc::SmemI8<DH>::bytes + sizeof(int) * a.maxp;
  cudaError_t err = cudaFuncSetAttribute(
      tc::kernel_i8<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + tc::BM - 1) / tc::BM, a.H, B);
  tc::kernel_i8<DH><<<grid, tc::NT, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const int8_t*>(kp),
      static_cast<const int8_t*>(vp), ks, vs, static_cast<const bf16*>(nk),
      static_cast<const bf16*>(nv), static_cast<bf16*>(out), a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32 (q, pages, new K/V and out share it).
// num_targets may be null. Returns the CUDA error code of the launch (0 on
// success) or -1 for an unsupported dtype or head dim.
extern "C" int paged_hstu_delta_attention_launch(
    int dtype, const void* q, const void* k_pages, const void* v_pages,
    const int* page_table, const int* cached_len, const void* new_k,
    const void* new_v, const int* new_lens, const int* num_targets, void* out,
    int B, int S, int H, int dh, int pg, int maxp, float alpha,
    float inv_scaling, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  const Args a{page_table, cached_len, new_lens, num_targets, S, H, pg, maxp,
               alpha, inv_scaling};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<bf16>(dh, q, k_pages, v_pages, new_k, new_v, out, a, B, st);
  if (dtype == 1)
    return dispatch_dh<float>(dh, q, k_pages, v_pages, new_k, new_v, out, a, B, st);
  return -1;
}

// The int8 page mode: q, new K/V and out bf16; k_pages / v_pages int8
// [P, pg, H, dh] with fp32 scales [P, pg, H] per (token, head). Same return
// codes.
extern "C" int paged_hstu_delta_attention_int8_launch(
    const void* q, const void* k_pages, const void* v_pages, const float* k_scales,
    const float* v_scales, const int* page_table, const int* cached_len, const void* new_k,
    const void* new_v, const int* new_lens, const int* num_targets, void* out, int B, int S,
    int H, int dh, int pg, int maxp, float alpha, float inv_scaling, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  const Args a{page_table, cached_len, new_lens, num_targets, S, H, pg, maxp,
               alpha, inv_scaling};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch_i8<32>(q, k_pages, v_pages, k_scales, v_scales, new_k, new_v, out, a, B, st);
    case 64: return launch_i8<64>(q, k_pages, v_pages, k_scales, v_scales, new_k, new_v, out, a, B, st);
    case 128: return launch_i8<128>(q, k_pages, v_pages, k_scales, v_scales, new_k, new_v, out, a, B, st);
    case 256: return launch_i8<256>(q, k_pages, v_pages, k_scales, v_scales, new_k, new_v, out, a, B, st);
    default: return -1;
  }
}

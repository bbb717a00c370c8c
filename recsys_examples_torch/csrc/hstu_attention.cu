// Jagged SiLU (HSTU) attention on mma.sync for Hopper (sm_90a): the forward
// and dk/dv with a dense relative attention bias added to the scores (K4's
// forward and dk/dv), and the int8 forward (K5). The bias-free forward (K1)
// is hstu_attention_fwd.cu's, the bias-free dq and dk/dv (K2, K3) and K4's
// dq + drab are hstu_attention_bwd.cu's, all on wgmma with TMA-fed tiles.
//
// K4 replaces `hstu_attn_varlen_rab` (:1482) of
// recsys_examples_tpu/ops/pallas/hstu_attention.py (the `has_rab` branches
// of `_fwd_kernel` and `_bwd_dkv_kernel`). For each sequence b of the packed
// [T, H, D] tensors (rows seq_offsets[b] .. seq_offsets[b + 1]) and each
// head, with rab [B|1, H|1, Nq, Nk] (fp32 or bf16, positions local to the
// sequence):
//   S = alpha q k^T + rab (fp32),  P = silu(S) / scaling * mask
//   out = P(bf16) v                                   (forward)
//   dP = dO v^T,  dS = alpha dP * dsilu(S) * mask / scaling
//   dv = P(bf16)^T dO,  dk = dS(bf16)^T q             (dk/dv)
// with fp32 accumulation and the mask of `_compute_mask` (hstu_mask.cuh):
// causal or not, contextual rows collapsed to position 0 and attending the
// history, the target-group purge, the max_attn_len window with its
// min-full tail, and the in-sequence guards. Rows that no sequence owns are
// never written: the caller zero-fills the outputs. Each thread reads the
// bias of the score elements it holds before the tile's products, so the
// loads fly behind the tensor-core work. What bounds K4 depends on the
// batch's longest sequence: the cells of the fp32 [1, 4, 8195, 8195] bias
// that a valid pair reaches are read once, up to 1.07 GB or 0.32 ms; for
// chip_smoke.py's batch (longest sequence about 4.6k rows) that is 167 MB,
// and operations bound both kernels: 0.124 ms (forward, two products a valid
// pair) and 0.248 ms (dk/dv, four) at the full-width training batch (22,458
// tokens, 4 heads of 256; 989 TFLOP/s dense bf16, 3.35 TB/s).
//
// K5 replaces `hstu_attn_varlen_quantized_calibrated` of the same file (the
// `quantized` branch of `_fwd_kernel`): the forward on int8 q, k [T, H, D]
// and v [T, H, V] with three per-tensor fp32 scales, no bias. As on the TPU
// the int8 values are widened to bf16 (exact) and the products run in bf16
// with fp32 sums:
//   S = (alpha q_scale k_scale) q8 k8^T,  P = silu(S) / scaling * mask,
//   out = bf16(v_scale . P(bf16) v8)
// The caller folds the two scales into alpha. `fwd_i8_kernel` moves half of
// the bf16 forward's bytes: int8 tiles stream through the cp.async ring
// (rows of D bytes, 16-byte vectors, row stride D + 16) and each arrived tile
// is widened into one bf16 compute tile of the forward's layout, so its
// fragment code runs on it unchanged. Operations bound it like K1 (0.124 ms).
//
// Design (simple and right first). Packed rows are read in place through
// seq_offsets: no aligned layout, no head padding, no tile worklist. 8 warps
// per CTA on mma.sync m16n8k16 tensor-core tiles. The CTA's own 64-row tile
// stays in shared memory while 32-row tiles of the other side stream through
// a two-stage cp.async ring, so the next tile's loads overlap this tile's
// math. Each warp computes a 16 x 16 block of the 64 x 32 score tile, applies
// mask and silu in registers and writes its bf16 product tile to shared
// memory; then each warp accumulates 16 rows x DH/2 columns of the output
// product.
//   forward: one CTA per (64 query rows, head, sequence), walking the key
//   tiles the mask can reach (`_kv_extent`: causal rows stop at their
//   diagonal, a tile that holds contextual rows goes to the end). The last
//   tiles of a sequence, which walk furthest, are launched first.
//   dk/dv: one CTA per (64 key rows, head, sequence), walking the query tiles
//   that reach it: the causal range from the key tile on, plus the tiles of
//   the contextual rows at the start of the sequence. It owns its dk and dv
//   rows, so dk and dv are deterministic (no atomics).
// Not done yet: wgmma/TMA, warp specialisation, skipping the mask on
// interior tiles (K1-K3 and K4's dq have all three).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hstu_mask.cuh"
#include "sm90_mma.cuh"

namespace {

using sm90::bf16;
using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::ld32;
using sm90::ldmatrix_x4;
using sm90::ldmatrix_x4_trans;
using sm90::mma;
using sm90::pack_bf16;
using sm90::widen16;

constexpr int NT = 256;   // 8 warps: row block warp % 4, half warp / 4
constexpr int BT = 64;    // rows of the CTA's own tile (4 row blocks of 16)
constexpr int BS = 32;    // rows of a streamed tile

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + __expf(-x)); }

template <int DH>
struct Layout {
  static constexpr int KS = DH + 8;    // row stride of a [rows][DH] tile: +16 B
  static constexpr int PS = BS + 8;    // row stride of a [BT][BS] product tile
  static constexpr int VPR = DH / 8;   // 16-byte vectors per row
  static constexpr int OC = DH / 2;    // accumulator columns per warp
  static constexpr int TILE = BT * KS, STREAM = BS * KS, PTILE = BT * PS;
};

// Copy rows [row0, row0 + ROWS) of one head of a sequence (`src` = its row
// 0, `ld` elements between rows) into a [ROWS][KS] shared tile; rows at or
// past n are zero-filled.
template <int DH, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t ld,
                                          int row0, int n) {
  using L = Layout<DH>;
  for (int e = threadIdx.x; e < ROWS * L::VPR; e += NT) {
    const int r = e / L::VPR, vv = e % L::VPR;
    const bool ok = row0 + r < n;
    cp_async16(dst + r * L::KS + vv * 8,
               ok ? src + (size_t)(row0 + r) * ld + vv * 8 : src, ok);
  }
}

// acc = a[rb*16 .. +16] . b[hf*16 + j*8 .. +8]^T over DH, for j = 0, 1:
// the warp's 16 x 16 block of the [BT][BS] score tile a . b^T. Even and odd
// k-steps accumulate apart, so two mma chains are in flight.
template <int DH>
__device__ __forceinline__ void score_block(float (&acc)[2][4], const bf16* a,
                                            const bf16* b, int rb, int hf, int lane) {
  constexpr int KS = Layout<DH>::KS;
  const int g = lane / 4, t = lane % 4;
  float s[2][2][4] = {};
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const bf16* ar = a + (rb * 16 + g) * KS + kk * 16 + 2 * t;
    const uint32_t af[4] = {ld32(ar), ld32(ar + 8 * KS), ld32(ar + 8),
                            ld32(ar + 8 * KS + 8)};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bf16* br = b + (hf * 16 + j * 8 + g) * KS + kk * 16 + 2 * t;
      mma(s[kk & 1][j], af, ld32(br), ld32(br + 8));
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = s[0][j][e] + s[1][j][e];
}

// Row (in the tile) and column (in the streamed tile) of element e of
// n-tile j of a score block.
__device__ __forceinline__ int blk_row(int rb, int lane, int e) {
  return rb * 16 + lane / 4 + (e >> 1) * 8;
}
__device__ __forceinline__ int blk_col(int hf, int lane, int j, int e) {
  return hf * 16 + j * 8 + 2 * (lane % 4) + (e & 1);
}

// Store a score block's four values of n-tile j, rounded to bf16, into the
// [BT][PS] product tile.
template <int DH>
__device__ __forceinline__ void put_block(bf16* tile, int rb, int hf, int lane, int j,
                                          const float v[4]) {
  constexpr int PS = Layout<DH>::PS;
  bf16* r = tile + (rb * 16 + lane / 4) * PS + hf * 16 + j * 8 + 2 * (lane % 4);
  *reinterpret_cast<uint32_t*>(r) = pack_bf16(v[0], v[1]);
  *reinterpret_cast<uint32_t*>(r + 8 * PS) = pack_bf16(v[2], v[3]);
}

// acc[16 rows x DH/2 cols] += p[rb*16 .. +16][0 .. BS] . x[0 .. BS][hf*DH/2 ..]:
// p through ldmatrix, x (row-major [BS][KS]) through ldmatrix.trans, two
// n-tiles at a time.
template <int DH>
__device__ __forceinline__ void accumulate(float (&acc)[DH / 16][4], const bf16* p,
                                           const bf16* x, int rb, int hf, int lane) {
  using L = Layout<DH>;
  const int mi = lane / 8, rr = lane % 8;
#pragma unroll
  for (int kk = 0; kk < BS / 16; ++kk) {
    uint32_t pa[4];
    ldmatrix_x4(pa, p + (rb * 16 + rr + (mi & 1) * 8) * L::PS + kk * 16 + (mi >> 1) * 8);
#pragma unroll
    for (int np = 0; np < L::OC / 16; ++np) {
      uint32_t bx[4];
      ldmatrix_x4_trans(bx, x + (kk * 16 + rr + (mi & 1) * 8) * L::KS + hf * L::OC +
                                np * 16 + (mi >> 1) * 8);
      mma(acc[2 * np], pa, bx[0], bx[1]);
      mma(acc[2 * np + 1], pa, bx[2], bx[3]);
    }
  }
}

// Write the warp's accumulator rows row0 + rb*16 + {g, g+8} (those < n) to
// `dst` (row 0 of the sequence at this head).
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst, size_t ld,
                                           const float (&acc)[DH / 16][4], int row0,
                                           int n, int rb, int hf, int lane) {
  const int r0 = row0 + rb * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < DH / 16; ++j) {
    const int col = hf * Layout<DH>::OC + j * 8 + 2 * (lane % 4);
    if (r0 < n)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r0 * ld + col) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    if (r0 + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)(r0 + 8) * ld + col) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
}

// The bias of the warp's score block, in the block's element order: the
// tile's rows start at `row0` and the streamed tile's at `col0`; with
// `transposed` (K3) the block's rows are keys and its columns queries.
// Elements past the sequence's end read as 0.
__device__ __forceinline__ void load_bias(float (&bias)[2][4], const Rab& rab,
                                          size_t plane, int n, int row0, int col0,
                                          int rb, int hf, int lane, bool transposed) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + blk_row(rb, lane, e), c = col0 + blk_col(hf, lane, j, e);
      bias[j][e] = (r < n && c < n) ? (transposed ? rab.at(plane, c, r) : rab.at(plane, r, c))
                                    : 0.f;
    }
}

// ------------------------------------------------------------ K4: forward
template <int DH>
constexpr size_t fwd_smem() {
  using L = Layout<DH>;
  return sizeof(bf16) * (L::TILE + 4 * L::STREAM + L::PTILE);
}

template <int DH>
__global__ void __launch_bounds__(NT, 2)
fwd_rab_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out, Params p, Rab rab) {
  using L = Layout<DH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // [BT][KS]
  bf16* sK = sQ + L::TILE;                         // [2][BS][KS]
  bf16* sV = sK + 2 * L::STREAM;                   // [2][BS][KS]
  bf16* sP = sV + 2 * L::STREAM;                   // [BT][PS]

  const Seq s(p, blockIdx.z);
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BT;
  if (m0 >= s.n) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rb = warp % 4, hf = warp / 4;
  const size_t ld = (size_t)p.H * DH;
  const size_t base = (size_t)s.off * ld + (size_t)blockIdx.y * DH;
  const int n_tiles = (s.kv_end(p, m0, BT) + BS - 1) / BS;
  const size_t plane = rab.plane(blockIdx.z, blockIdx.y);

  float o[DH / 16][4] = {};
  load_tile<DH, BT>(sQ, q + base, ld, m0, s.n);   // joins key tile 0's group
  load_tile<DH, BS>(sK, k + base, ld, 0, s.n);
  load_tile<DH, BS>(sV, v + base, ld, 0, s.n);
  cp_async_commit();
  for (int ci = 0; ci < n_tiles; ++ci) {
    const int buf = ci & 1;
    if (ci + 1 < n_tiles) {   // that stage was freed by the last sync
      load_tile<DH, BS>(sK + (buf ^ 1) * L::STREAM, k + base, ld, (ci + 1) * BS, s.n);
      load_tile<DH, BS>(sV + (buf ^ 1) * L::STREAM, v + base, ld, (ci + 1) * BS, s.n);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* k_s = sK + buf * L::STREAM;
    const bf16* v_s = sV + buf * L::STREAM;

    float sc[2][4], bias[2][4];
    load_bias(bias, rab, plane, s.n, m0, ci * BS, rb, hf, lane, false);
    score_block<DH>(sc, sQ, k_s, rb, hf, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[j][e] * p.alpha + bias[j][e];
        pv[e] = s.valid(p, m0 + blk_row(rb, lane, e), ci * BS + blk_col(hf, lane, j, e))
                    ? x * sigmoid(x) * p.inv_scaling : 0.f;
      }
      put_block<DH>(sP, rb, hf, lane, j, pv);
    }
    __syncthreads();
    accumulate<DH>(o, sP, v_s, rb, hf, lane);
    __syncthreads();   // this stage and P are free again
  }
  store_rows<DH>(out + base, ld, o, m0, s.n, rb, hf, lane);
}

// ------------------------------------------------------------ K5: int8 forward
template <int DH>
struct LayoutI8 {
  static constexpr int RS = DH + 16;    // int8 row stride in bytes: +16 B
  static constexpr int VPR = DH / 16;   // 16-byte vectors per int8 row
  static constexpr int STREAM = BS * RS;
};

template <int DH>
constexpr size_t fwd_i8_smem() {
  using L = Layout<DH>;
  // Q, one K and one V compute tile, P (bf16); the int8 K and V ring
  return sizeof(bf16) * (L::TILE + 2 * L::STREAM + L::PTILE) + 4 * LayoutI8<DH>::STREAM;
}

// Copy int8 rows [row0, row0 + BS) of one head into a [BS][RS] ring stage;
// rows at or past n are zero-filled.
template <int DH>
__device__ __forceinline__ void load_tile_i8(int8_t* dst, const int8_t* src, size_t ld,
                                             int row0, int n) {
  using L8 = LayoutI8<DH>;
  for (int e = threadIdx.x; e < BS * L8::VPR; e += NT) {
    const int r = e / L8::VPR, vv = e % L8::VPR;
    const bool ok = row0 + r < n;
    cp_async16(dst + r * L8::RS + vv * 16,
               ok ? src + (size_t)(row0 + r) * ld + vv * 16 : src, ok);
  }
}

template <int DH>
__global__ void __launch_bounds__(NT, 2)
fwd_i8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
              const int8_t* __restrict__ v, bf16* __restrict__ out, Params p,
              float v_scale) {
  using L = Layout<DH>;
  using L8 = LayoutI8<DH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // [BT][KS]
  bf16* sK = sQ + L::TILE;                         // [BS][KS] compute tile
  bf16* sV = sK + L::STREAM;                       // [BS][KS]
  bf16* sP = sV + L::STREAM;                       // [BT][PS]
  int8_t* rK = reinterpret_cast<int8_t*>(sP + L::PTILE);   // [2][BS][RS] ring
  int8_t* rV = rK + 2 * L8::STREAM;                         // [2][BS][RS]

  const Seq s(p, blockIdx.z);
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BT;
  if (m0 >= s.n) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rb = warp % 4, hf = warp / 4;
  const size_t ld = (size_t)p.H * DH;
  const size_t base = (size_t)s.off * ld + (size_t)blockIdx.y * DH;
  const int n_tiles = (s.kv_end(p, m0, BT) + BS - 1) / BS;

  float o[DH / 16][4] = {};
  load_tile_i8<DH>(rK, k + base, ld, 0, s.n);
  load_tile_i8<DH>(rV, v + base, ld, 0, s.n);
  cp_async_commit();
  // the CTA's own Q rows: read once, widened on the way into shared memory
  for (int e = threadIdx.x; e < BT * L8::VPR; e += NT) {
    const int r = e / L8::VPR, vv = e % L8::VPR;
    int4 raw = make_int4(0, 0, 0, 0);
    if (m0 + r < s.n)
      raw = *reinterpret_cast<const int4*>(q + base + (size_t)(m0 + r) * ld + vv * 16);
    widen16(sQ + r * L::KS + vv * 16, raw);
  }
  for (int ci = 0; ci < n_tiles; ++ci) {
    const int buf = ci & 1;
    if (ci + 1 < n_tiles) {   // that stage was freed by the last sync
      load_tile_i8<DH>(rK + (buf ^ 1) * L8::STREAM, k + base, ld, (ci + 1) * BS, s.n);
      load_tile_i8<DH>(rV + (buf ^ 1) * L8::STREAM, v + base, ld, (ci + 1) * BS, s.n);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int e = threadIdx.x; e < BS * L8::VPR; e += NT) {
      const int r = e / L8::VPR, vv = e % L8::VPR;
      const int src = buf * L8::STREAM + r * L8::RS + vv * 16;
      widen16(sK + r * L::KS + vv * 16, *reinterpret_cast<const int4*>(rK + src));
      widen16(sV + r * L::KS + vv * 16, *reinterpret_cast<const int4*>(rV + src));
    }
    __syncthreads();

    float sc[2][4];
    score_block<DH>(sc, sQ, sK, rb, hf, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[j][e] * p.alpha;
        pv[e] = s.valid(p, m0 + blk_row(rb, lane, e), ci * BS + blk_col(hf, lane, j, e))
                    ? x * sigmoid(x) * p.inv_scaling : 0.f;
      }
      put_block<DH>(sP, rb, hf, lane, j, pv);
    }
    __syncthreads();
    accumulate<DH>(o, sP, sV, rb, hf, lane);
    __syncthreads();   // the compute tiles and P are free again
  }
#pragma unroll
  for (int j = 0; j < DH / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] *= v_scale;
  store_rows<DH>(out + base, ld, o, m0, s.n, rb, hf, lane);
}

// ------------------------------------------------------------ K4: dk, dv
template <int DH>
constexpr size_t dkv_smem() {
  using L = Layout<DH>;
  return sizeof(bf16) * (2 * L::TILE + 4 * L::STREAM + 2 * L::PTILE);
}

template <int DH>
__global__ void __launch_bounds__(NT, 1)
dkv_rab_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               bf16* __restrict__ dk, bf16* __restrict__ dv, Params p, Rab rab) {
  using L = Layout<DH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);   // [BT][KS]
  bf16* sV = sK + L::TILE;                         // [BT][KS]
  bf16* sQ = sV + L::TILE;                         // [2][BS][KS]
  bf16* sO = sQ + 2 * L::STREAM;                   // [2][BS][KS] dO
  bf16* sP = sO + 2 * L::STREAM;                   // [BT][PS] P^T
  bf16* sS = sP + L::PTILE;                        // [BT][PS] dS^T

  const Seq s(p, blockIdx.z);
  const int n0 = blockIdx.x * BT;   // causal: the first key tiles walk furthest
  if (n0 >= s.n) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rb = warp % 4, hf = warp / 4;
  const size_t ld = (size_t)p.H * DH;
  const size_t base = (size_t)s.off * ld + (size_t)blockIdx.y * DH;
  const float ds_scale = p.inv_scaling * p.alpha;
  const size_t plane = rab.plane(blockIdx.z, blockIdx.y);
  const QueryTiles tiles(p, s, n0, BS);   // the 32-row query tiles that reach these keys

  float dka[DH / 16][4] = {}, dva[DH / 16][4] = {};
  load_tile<DH, BT>(sK, k + base, ld, n0, s.n);
  load_tile<DH, BT>(sV, v + base, ld, n0, s.n);
  load_tile<DH, BS>(sQ, q + base, ld, tiles.row0(0), s.n);
  load_tile<DH, BS>(sO, dout + base, ld, tiles.row0(0), s.n);
  cp_async_commit();
  for (int ci = 0; ci < tiles.count; ++ci) {
    const int buf = ci & 1;
    if (ci + 1 < tiles.count) {
      const int r1 = tiles.row0(ci + 1);
      load_tile<DH, BS>(sQ + (buf ^ 1) * L::STREAM, q + base, ld, r1, s.n);
      load_tile<DH, BS>(sO + (buf ^ 1) * L::STREAM, dout + base, ld, r1, s.n);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* q_s = sQ + buf * L::STREAM;
    const bf16* o_s = sO + buf * L::STREAM;
    const int q0 = tiles.row0(ci);

    // transposed scores: rows are keys, columns queries
    float st[2][4], dpt[2][4], bias[2][4];
    load_bias(bias, rab, plane, s.n, n0, q0, rb, hf, lane, true);
    score_block<DH>(st, sK, q_s, rb, hf, lane);
    score_block<DH>(dpt, sV, o_s, rb, hf, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float pv[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = st[j][e] * p.alpha + bias[j][e];
        const float sg = sigmoid(x);
        const bool ok =
            s.valid(p, q0 + blk_col(hf, lane, j, e), n0 + blk_row(rb, lane, e));
        pv[e] = ok ? x * sg * p.inv_scaling : 0.f;
        ds[e] = ok ? dpt[j][e] * sg * (1.f + x * (1.f - sg)) * ds_scale : 0.f;
      }
      put_block<DH>(sP, rb, hf, lane, j, pv);
      put_block<DH>(sS, rb, hf, lane, j, ds);
    }
    __syncthreads();
    accumulate<DH>(dva, sP, o_s, rb, hf, lane);   // dv += P^T dO
    accumulate<DH>(dka, sS, q_s, rb, hf, lane);   // dk += dS^T q
    __syncthreads();
  }
  store_rows<DH>(dk + base, ld, dka, n0, s.n, rb, hf, lane);
  store_rows<DH>(dv + base, ld, dva, n0, s.n, rb, hf, lane);
}

// ------------------------------------------------------------ launch
template <class T>
struct same { using type = T; };

template <typename... A>
int launch(void (*kern)(A...), size_t smem, dim3 grid, cudaStream_t st,
           typename same<A>::type... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, NT, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

Params make_params(const int* seq_offsets, const int* num_contextuals,
                   const int* num_targets, int H, float alpha, float inv_scaling,
                   int causal, int group, int max_attn_len, int min_full) {
  return Params{seq_offsets, num_contextuals, num_targets, H, alpha, inv_scaling,
                causal, group, max_attn_len, min_full};
}

// K4's kernels: without a bias, -1
#define HSTU_DISPATCH_DH_RAB(dh, CALL)                                \
  if (!r.ptr) return -1;                                              \
  switch (dh) {                                                       \
    case 32: { constexpr int DH = 32; return CALL; }                  \
    case 64: { constexpr int DH = 64; return CALL; }                  \
    case 128: { constexpr int DH = 128; return CALL; }                \
    case 256: { constexpr int DH = 256; return CALL; }                \
    default: return -1;                                               \
  }

}  // namespace

// Both take bf16 [T, H, dh] tensors (dh 32, 64, 128 or 256), int32
// seq_offsets [B + 1] and optional int32 num_contextuals / num_targets [B]
// (null when absent), and the fp32 or bf16 bias `rab` [rb, rh, nq, nk] with
// `rab_sb` / `rab_sh` elements between batches / heads (0 for a broadcast
// dim) and `rab_nk` between rows; `drab` and `drab_atomic` are not read
// (K4's dq + drab is hstu_attention_bwd.cu's). Each returns the CUDA error
// code of its launch (0 on success) or -1 for an unsupported head dim or
// group size, or without a bias.
#define HSTU_COMMON_ARGS                                                         \
  const int *seq_offsets, const int *num_contextuals, const int *num_targets,    \
      int B, int H, int dh, int max_seqlen, float alpha, float inv_scaling,      \
      int causal, int target_group_size, int max_attn_len,                       \
      int min_full_attn_seq_len, const void *rab, void *drab, long long rab_sb,  \
      long long rab_sh, int rab_nk, int rab_is_bf16, int drab_atomic, void *stream

#define HSTU_PROLOGUE                                                            \
  if (target_group_size < 1) return -1;                                          \
  if (B == 0 || H == 0 || max_seqlen == 0) return 0;                             \
  const Params p = make_params(seq_offsets, num_contextuals, num_targets, H,     \
                               alpha, inv_scaling, causal, target_group_size,    \
                               max_attn_len, min_full_attn_seq_len);             \
  const Rab r{rab, static_cast<float*>(drab), rab_sb, rab_sh, rab_nk,            \
              rab_is_bf16, drab_atomic};                                         \
  const dim3 grid((max_seqlen + BT - 1) / BT, H, B);                             \
  cudaStream_t st = static_cast<cudaStream_t>(stream);

extern "C" int hstu_attn_rab_fwd_launch(const void* q, const void* k, const void* v,
                                        void* out, HSTU_COMMON_ARGS) {
  HSTU_PROLOGUE
  const bf16 *Q = static_cast<const bf16*>(q), *K = static_cast<const bf16*>(k),
             *V = static_cast<const bf16*>(v);
  bf16* O = static_cast<bf16*>(out);
  HSTU_DISPATCH_DH_RAB(dh, launch(fwd_rab_kernel<DH>, fwd_smem<DH>(), grid, st, Q, K, V, O, p,
                                  r))
}

extern "C" int hstu_attn_rab_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                            const void* dout, void* dk, void* dv,
                                            HSTU_COMMON_ARGS) {
  HSTU_PROLOGUE
  const bf16 *Q = static_cast<const bf16*>(q), *K = static_cast<const bf16*>(k),
             *V = static_cast<const bf16*>(v), *dO = static_cast<const bf16*>(dout);
  bf16 *dK = static_cast<bf16*>(dk), *dV = static_cast<bf16*>(dv);
  HSTU_DISPATCH_DH_RAB(dh, launch(dkv_rab_kernel<DH>, dkv_smem<DH>(), grid, st, Q, K, V,
                                  dO, dK, dV, p, r))
}

// K5: int8 q, k, v [T, H, dh], `alpha` already times q_scale * k_scale, the
// output bf16 [T, H, dh] times `v_scale`. No bias. Same return codes.
extern "C" int hstu_attn_fwd_int8_launch(
    const void* q, const void* k, const void* v, void* out, const int* seq_offsets,
    const int* num_contextuals, const int* num_targets, int B, int H, int dh,
    int max_seqlen, float alpha, float inv_scaling, int causal, int target_group_size,
    int max_attn_len, int min_full_attn_seq_len, float v_scale, void* stream) {
  if (target_group_size < 1) return -1;
  if (B == 0 || H == 0 || max_seqlen == 0) return 0;
  const Params p = make_params(seq_offsets, num_contextuals, num_targets, H, alpha,
                               inv_scaling, causal, target_group_size, max_attn_len,
                               min_full_attn_seq_len);
  const dim3 grid((max_seqlen + BT - 1) / BT, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t *Q = static_cast<const int8_t*>(q), *K = static_cast<const int8_t*>(k),
               *V = static_cast<const int8_t*>(v);
  bf16* O = static_cast<bf16*>(out);
  switch (dh) {
    case 32: return launch(fwd_i8_kernel<32>, fwd_i8_smem<32>(), grid, st, Q, K, V, O, p, v_scale);
    case 64: return launch(fwd_i8_kernel<64>, fwd_i8_smem<64>(), grid, st, Q, K, V, O, p, v_scale);
    case 128: return launch(fwd_i8_kernel<128>, fwd_i8_smem<128>(), grid, st, Q, K, V, O, p, v_scale);
    case 256: return launch(fwd_i8_kernel<256>, fwd_i8_smem<256>(), grid, st, Q, K, V, O, p, v_scale);
    default: return -1;
  }
}

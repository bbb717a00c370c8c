// The int8 forward of the jagged SiLU (HSTU) attention (K5) on mma.sync for
// Hopper (sm_90a). Every other kernel of the attention is on wgmma with
// TMA-fed tiles: the forward (K1) and K4's forward with a relative attention
// bias in hstu_attention_fwd.cu, the backward (K2, K3) and K4's dq + drab and
// dk/dv in hstu_attention_bwd.cu.
//
// K5 replaces `hstu_attn_varlen_quantized_calibrated` (:1541) of
// recsys_examples_tpu/ops/pallas/hstu_attention.py (the `quantized` branch
// of `_fwd_kernel`): the forward on int8 q, k [T, H, D] and v [T, H, V] with
// three per-tensor fp32 scales, no bias. For each sequence b of the packed
// tensors (rows seq_offsets[b] .. seq_offsets[b + 1]) and each head, as on
// the TPU the int8 values are widened to bf16 (exact) and the products run
// in bf16 with fp32 sums:
//   S = (alpha q_scale k_scale) q8 k8^T,  P = silu(S) / scaling * mask,
//   out = bf16(v_scale . P(bf16) v8)
// with the mask of `_compute_mask` (hstu_mask.cuh): causal or not,
// contextual rows collapsed to position 0 and attending the history, the
// target-group purge, the max_attn_len window with its min-full tail, and
// the in-sequence guards. The caller folds the two scales into alpha and
// zero-fills the output: rows that no sequence owns are never written.
// Operations bound it like K1: 0.124 ms at the full-width training batch
// (22,458 tokens, 4 heads of 256; 989 TFLOP/s dense bf16, 3.35 TB/s), whose
// int8 operands are half of the bf16 forward's bytes.
//
// Design (simple and right first). Packed rows are read in place through
// seq_offsets: no aligned layout, no head padding, no tile worklist. One CTA
// per (64 query rows, head, sequence), walking the key tiles the mask can
// reach (`_kv_extent`: causal rows stop at their diagonal, a tile that holds
// contextual rows goes to the end); the last tiles of a sequence, which walk
// furthest, are launched first. 8 warps per CTA on mma.sync m16n8k16
// tensor-core tiles. The CTA's own 64 query rows are widened once into a
// bf16 tile; 32-row int8 tiles of K and V stream through a two-stage
// cp.async ring (rows of D bytes, 16-byte vectors, row stride D + 16), so the
// next tile's loads overlap this tile's math, and each arrived tile is
// widened into one bf16 compute tile. Each warp computes a 16 x 16 block of
// the 64 x 32 score tile, applies mask and silu in registers and writes its
// bf16 product tile to shared memory; then each warp accumulates 16 rows x
// DH/2 columns of the output product. The mask is evaluated on every
// element.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hstu_mask.cuh"
#include "sm90_wgmma.cuh"   // sm90::launch; includes sm90_mma.cuh

namespace {

using sm90::bf16;
using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::launch;
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
  static constexpr int OC = DH / 2;    // accumulator columns per warp
  static constexpr int TILE = BT * KS, STREAM = BS * KS, PTILE = BT * PS;
};

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

}  // namespace

// K5: int8 q, k, v [T, H, dh] (dh 32, 64, 128 or 256), int32 seq_offsets
// [B + 1] and optional int32 num_contextuals / num_targets [B] (null when
// absent); `alpha` already times q_scale * k_scale, the output bf16 [T, H,
// dh] times `v_scale`. Returns the CUDA error code of its launch (0 on
// success) or -1 for an unsupported head dim or group size.
extern "C" int hstu_attn_fwd_int8_launch(
    const void* q, const void* k, const void* v, void* out, const int* seq_offsets,
    const int* num_contextuals, const int* num_targets, int B, int H, int dh,
    int max_seqlen, float alpha, float inv_scaling, int causal, int target_group_size,
    int max_attn_len, int min_full_attn_seq_len, float v_scale, void* stream) {
  if (target_group_size < 1) return -1;
  if (B == 0 || H == 0 || max_seqlen == 0) return 0;
  const Params p{seq_offsets, num_contextuals, num_targets, H, alpha, inv_scaling, causal,
                 target_group_size, max_attn_len, min_full_attn_seq_len};
  const dim3 grid((max_seqlen + BT - 1) / BT, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t *Q = static_cast<const int8_t*>(q), *K = static_cast<const int8_t*>(k),
               *V = static_cast<const int8_t*>(v);
  bf16* O = static_cast<bf16*>(out);
  switch (dh) {
    case 32: return launch(fwd_i8_kernel<32>, fwd_i8_smem<32>(), grid, NT, st, Q, K, V, O, p, v_scale);
    case 64: return launch(fwd_i8_kernel<64>, fwd_i8_smem<64>(), grid, NT, st, Q, K, V, O, p, v_scale);
    case 128: return launch(fwd_i8_kernel<128>, fwd_i8_smem<128>(), grid, NT, st, Q, K, V, O, p, v_scale);
    case 256: return launch(fwd_i8_kernel<256>, fwd_i8_smem<256>(), grid, NT, st, Q, K, V, O, p, v_scale);
    default: return -1;
  }
}

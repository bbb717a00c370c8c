// The backward of the jagged SiLU (HSTU) attention for Hopper (sm_90a): dq
// (K2) and dk/dv (K3), and with a relative attention bias dq + drab and
// dk/dv (K4's backward), on wgmma with TMA-fed tiles.
//
// Replaces the TPU kernels `_bwd_dq_kernel` (:448) and `_bwd_dkv_kernel`
// (:677) of recsys_examples_tpu/ops/pallas/hstu_attention.py, both launched
// by `_hstu_bwd_impl` (:1202), and their `has_rab` branches (dq :549-629,
// dk/dv :861-874) reached through `hstu_attn_varlen_rab` (:1482). For each sequence b of the packed [T, H, D]
// bf16 tensors (rows seq_offsets[b] .. seq_offsets[b + 1]) and each head:
//   S = alpha q k^T,  P = silu(S) / scaling * mask,  dP = dO v^T,
//   dS = dP * dsilu(S) * mask / scaling
//   dq = alpha dS(bf16) k                                   (K2)
//   dv = P(bf16)^T dO,  dk = alpha dS(bf16)^T q             (K3)
// with S and dP in fp32, P and dS rounded to bf16 before their products,
// fp32 sums and bf16 outputs, and the mask of `_compute_mask`
// (hstu_mask.cuh). Rows that no sequence owns are never written: the caller
// zero-fills the outputs. Each CTA owns its output rows, so both kernels are
// deterministic (no atomics).
//
// K4's dq is the RAB = true instance of K2's template, K4's dk/dv that of
// K3's. With rab [B|1, H|1, Nq, Nk] (fp32 or bf16, positions local to the
// sequence):
//   x = alpha S + rab,  g_rab = dP * dsilu(x) * mask / scaling,
//   dS = alpha g_rab,   drab += g_rab (dq only)
// drab is an fp32 tensor of rab's shape that the caller zero-fills. A cell of
// a broadcast dim is shared by the CTAs of every sequence (or head), which
// run in no order: those adds are fp32 atomics, so drab's last bits depend on
// their order; with a B- and H-sized rab each cell has one owner and is
// stored. dq stays deterministic. The bias does not go through TMA and shared
// memory: K2's layout leaves 18 KB free at D = 256, less than two 16 KB fp32
// bias stages, and the model's [1, 4, 8195, 8195] fp32 bias has a row stride
// of 32,780 bytes, which is not the multiple of 16 that TMA needs. Each
// consumer thread instead reads the bias of its 16 score elements from
// global memory before it issues the score chains, so the loads fly behind
// them, and adds its g_rab of the valid pairs into drab after the dP chain,
// as 8-byte pairs where a pair is 8-byte aligned (with an odd Nk, every
// other row's are not) and else a cell at a time. Every valid pair then
// reads one bias cell and adds one drab cell: at the full-width batch
// (22,458 tokens, a [1, 4, 8195, 8195] fp32 bias) about 480 MB each way,
// 0.29 ms at 3.35 TB/s if L2 reuses none of it, beside the 0.186 ms of its
// products (chip_smoke.py's bound counts each cell once: 167 MB each way).
// The drab atomics, not the products, set its time (PERF.md). K4's dk/dv
// reads the bias transposed (its score blocks' rows are keys): each consumer
// thread loads its 16 cells, rab[query][key], with 8 consecutive keys of 4
// queries a warp load, a tile ahead: right after its SiLU pass has used
// this tile's cells, so the loads fly behind the tile's products and the
// next tile's chains (loaded just before the chains, as dq does, they left
// dk/dv 11% slower: PERF.md). It writes no drab, so it has no atomics and
// stays deterministic, and shared memory, which K3 fills to 225 KB at
// D = 256, needs no room for it.
//
// What bounds them on an H100 (989 TFLOP/s dense bf16, 3.35 TB/s):
// operations. Every valid (query, key) pair costs K2 three products (S, dP,
// dq) and K3 four (S, dP, dk, dv) of 2 D FLOPs each: at the full-width
// training batch (22,458 tokens, 4 heads of 256) 0.186 and 0.248 ms, against
// 0.07-0.08 ms for their bytes.
//
// Design. The operands stay where they are: one 2-D TMA map per tensor over
// [T][H * D] reads a 64-row tile of one head as D / 64 swizzled panels
// (sm90_wgmma.cuh), so the packed rows need no copy, no padding and no
// worklist. A CTA has three warpgroups:
//   - a producer warp (its warpgroup trimmed to 40 registers) that loads the
//     CTA's own 64-row tiles once and keeps the next 64-row tiles of the
//     other side in flight through a two-stage ring with full/empty
//     mbarriers;
//   - two consumer warpgroups (232 registers). Consumer w computes the
//     64 x 32 score and dP blocks of the tile's columns w * 32 .. w * 32 + 31
//     as wgmma m64n32k16 chains over D, both operands in shared memory, then
//     mask, SiLU and dSiLU in registers, and writes P and dS (bf16, 128-byte
//     swizzle, by stmatrix) into shared product tiles. S and dP commit
//     apart, so the SiLU work on S starts while the dP chain runs. After a
//     named barrier of the two, consumer w accumulates the output columns
//     w * D/2 .. of the whole 64-wide reduction (m64n(D/2)k16 chains, A the
//     product tile, B the streamed tile read MN-major): D/2 fp32 sums per
//     thread and output. The product tiles are double-buffered, so one
//     barrier per tile suffices.
// The two consumers meet at the product tile every tile, so the tensor
// cores idle during the SiLU pass; at D = 256 shared memory holds two ring
// stages only, which rules out running the next tile's scores beside it.
// The mask is evaluated per element only on edge tiles: a tile that
// `tile_fully_valid` certifies (causal, no window, every row inside the
// sequence, every column a history column: JAX's `_tile_fully_valid`) skips
// `Seq::valid` and its divisions. Where the mask is causal with no targets
// and no window (`causal_edge`, bench.py's configuration), an edge tile
// takes its three-comparison form; other masks take `Seq::valid`.
//   K2: one CTA per (64 query rows, head, sequence); Q and dO resident, key
//   tiles up to `kv_end`; the last query tiles, which walk furthest, first.
//   K3: one CTA per (64 key rows, head, sequence); K and V resident, the
//   query tiles of `QueryTiles` (the contextual rows' tiles, then the causal
//   range from the key tile on); the first key tiles first. Its score tiles
//   are transposed (rows keys, columns queries), so P^T and dS^T come out of
//   the score products as the A operands of dv and dk.
// A packed tile that starts at row off + r0 holds the next sequence's rows
// past n (TMA zero-fills only past T): the mask makes P and dS zero there,
// and stores stay below n.
//
// Shared memory at D = 256: K3 holds K + V (64 KB), the ring 2 x (Q + dO)
// (128 KB) and 2 x (P^T + dS^T) (32 KB); K2 Q + dO, 2 x (K + V) and 2 x dS.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hstu_mask.cuh"
#include "sm90_wgmma.cuh"

namespace {

using sm90::bf16;
using sm90::load_tile;

constexpr int BT = sm90::TILE_ROWS;       // rows of every tile (64)
constexpr int NC = 2;                     // consumer warpgroups
constexpr int NTHREADS = 128 * (NC + 1);  // + the producer's warpgroup
constexpr int STAGES = 2;
constexpr int PT = BT * BT * 2;           // bytes of a [64][64] bf16 product tile

template <int DH>
struct Tile : sm90::Tile<DH> {
  static constexpr int HALF = DH / NC;           // output columns per consumer
};

// fast reciprocal: two ulps at most, far below the bf16 rounding of P and dS
__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }

// acc[64 x 32] = A[64][DH] . B[b0 .. b0 + 32][DH]^T, A and B tiles read
// K-major.
template <int DH>
__device__ __forceinline__ void score_chain(float (&acc)[16], const unsigned char* a,
                                            const unsigned char* b, int b0) {
  using L = Tile<DH>;
  constexpr int SL = L::PW / 16;   // 16-wide k-slices per panel
#pragma unroll
  for (int s = 0; s < DH / 16; ++s) {
    const int off = (s / SL) * L::PANEL + (s % SL) * 32;
    sm90::Wgmma<32, 0>::run(acc, sm90::smem_desc(a + off, 16, 8 * L::PB, L::SW),
                            sm90::smem_desc(b + b0 * L::PB + off, 16, 8 * L::PB, L::SW), s > 0);
  }
}

// acc[64 x DH/2] += P[64][64] . X[64][c0 .. c0 + DH/2]: P a product tile
// (K-major), X a tile read MN-major.
template <int DH>
__device__ __forceinline__ void out_chain(float (&acc)[Tile<DH>::HALF / 2],
                                          const unsigned char* pt, const unsigned char* x,
                                          int c0) {
  using L = Tile<DH>;
  const unsigned char* xb = x + (c0 / L::PW) * L::PANEL + (c0 % L::PW) * 2;
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
    sm90::Wgmma<L::HALF, 1>::run(acc, sm90::smem_desc(pt + kk * 32, 16, 1024, sm90::SW128),
                                 sm90::smem_desc(xb + kk * 16 * L::PB, L::PANEL, 8 * L::PB, L::SW),
                                 1);
}

__device__ __forceinline__ void put_pair(unsigned char* tile, int r, int c, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(tile + sm90::swz128(r, c)) = sm90::pack_bf16(lo, hi);
}

// A consumer warp's 16 packed accumulator pairs (pk[k]: elements 2k, 2k + 1)
// into columns c0 .. c0 + 31 of a product tile, by two stmatrix.x4: matrix m
// of store x is the 8 x 8 block (rows + 8 (m % 2), columns + 8 (2x + m / 2)).
__device__ __forceinline__ void put_block(unsigned char* tile, int c0, const uint32_t (&pk)[8], int t) {
  const int l = t & 31, m = l >> 3;
  const int row = (t >> 5) * 16 + (m & 1) * 8 + (l & 7);
#pragma unroll
  for (int x = 0; x < 2; ++x)
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(sm90::smem_u32(tile + sm90::swz128(row, c0 + (2 * x + (m >> 1)) * 8))),
                    "r"(pk[4 * x]), "r"(pk[4 * x + 1]), "r"(pk[4 * x + 2]), "r"(pk[4 * x + 3])
                 : "memory");
}

// Store a consumer's [64 x DH/2] accumulator (its columns c0 ..) as bf16 to
// rows row0 + r < n of `dst` (row 0 of the sequence at this head).
template <int DH>
__device__ __forceinline__ void store_acc(bf16* dst, size_t ld, const float (&acc)[Tile<DH>::HALF / 2],
                                          int row0, int n, int c0, int t) {
#pragma unroll
  for (int i = 0; i < Tile<DH>::HALF / 2; i += 2) {
    const int r = row0 + sm90::acc_row(t, i);
    if (r < n)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * ld + c0 + sm90::acc_col(t, i)) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

// Shared memory: the resident pair, the ring's pairs, the product tiles,
// then the barriers; 1024 bytes of slack align the base.
template <int DH, int PTILES>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)(2 + 2 * STAGES) * Tile<DH>::BYTES + PTILES * PT +
         sizeof(sm90::Ring<STAGES>) + 8;
}

// ------------------------------------------------------------ elementwise
// The part of a score block's elementwise work that needs S alone, done
// while the dP chain still runs: each element's SiLU factor g = dsilu(x) *
// mask * alpha / scaling (0 where masked), and with `sp` P in bf16 into
// that product tile. The block's rows are `r0 + acc_row`, its columns
// `c0 + acc_col` of the tile; with TRANS the mask reads (column, row), K3's
// transposed blocks. With BIAS (K4): x = alpha S + bias. With DRAB (K4's dq)
// besides: g leaves out alpha (dP g is drab's share), and bit i of `okm`
// says element i is valid.
template <Mask MASK, bool TRANS, bool BIAS, bool DRAB>
__device__ __forceinline__ void silu_part(const float (&sc)[16], float (&g)[16], unsigned char* sp,
                                          const float* bias, uint32_t* okm, const Params& p,
                                          const Seq& s, int r0, int c0, int w, int t) {
  static_assert(BIAS || !DRAB, "drab comes with a bias");
  const float g_scale = DRAB ? p.inv_scaling : p.inv_scaling * p.alpha;
  uint32_t pk[8];
#pragma unroll
  for (int i = 0; i < 16; i += 2) {
    float pv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = sm90::acc_row(t, i + e), c = w * 32 + sm90::acc_col(t, i + e);
      float x = sc[i + e] * p.alpha;
      if constexpr (BIAS) x += bias[i + e];
      const float sg = sigmoid(x);
      const int qr = TRANS ? c0 + c : r0 + r, kc = TRANS ? r0 + r : c0 + c;
      const bool ok = mask_ok<MASK>(p, s, qr, kc);
      pv[e] = ok ? x * sg * p.inv_scaling : 0.f;
      g[i + e] = ok ? sg * (1.f + x * (1.f - sg)) * g_scale : 0.f;
      if constexpr (DRAB) *okm |= (uint32_t)ok << (i + e);
    }
    pk[i / 2] = sm90::pack_bf16(pv[0], pv[1]);
  }
  if (sp) put_block(sp, w * 32, pk, t);
}

// silu_part with the tile's mask form: tile rows [q0, q0 + 64) of queries
// and [k0, k0 + 64) of keys.
template <bool TRANS, bool BIAS = false, bool DRAB = false>
__device__ __forceinline__ void silu_tile(const float (&sc)[16], float (&g)[16], unsigned char* sp,
                                          const Params& p, const Seq& s, int q0, int k0, int w,
                                          int t, const float* bias = nullptr,
                                          uint32_t* okm = nullptr) {
  const int r0 = TRANS ? k0 : q0, c0 = TRANS ? q0 : k0;
  if (s.tile_fully_valid(p, q0, k0, BT))
    silu_part<NONE, TRANS, BIAS, DRAB>(sc, g, sp, bias, okm, p, s, r0, c0, w, t);
  else if (s.causal_edge(p))
    silu_part<CAUSAL, TRANS, BIAS, DRAB>(sc, g, sp, bias, okm, p, s, r0, c0, w, t);
  else
    silu_part<FULL, TRANS, BIAS, DRAB>(sc, g, sp, bias, okm, p, s, r0, c0, w, t);
}

// dS = dP * g, in bf16, into the product tile `ss`.
__device__ __forceinline__ void ds_part(const float (&dp)[16], const float (&g)[16],
                                        unsigned char* ss, int w, int t) {
  uint32_t pk[8];
#pragma unroll
  for (int i = 0; i < 16; i += 2) pk[i / 2] = sm90::pack_bf16(dp[i] * g[i], dp[i + 1] * g[i + 1]);
  put_block(ss, w * 32, pk, t);
}

// K4: the bias of a consumer's 16 score elements, rows row0 + acc_row and
// columns col0 + acc_col of the block; 0 past the sequence's end. With TRANS
// (dk/dv) the block's rows are keys and its columns queries, so element
// (r, c) reads rab[c][r].
template <bool TRANS>
__device__ __forceinline__ void load_bias(float (&b)[16], const Rab& rab, size_t plane, int n,
                                          int row0, int col0, int t) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = row0 + sm90::acc_row(t, i), c = col0 + sm90::acc_col(t, i);
    b[i] = r < n && c < n ? (TRANS ? rab.at(plane, c, r) : rab.at(plane, r, c)) : 0.f;
  }
}

// K4: g_rab = dP * g; dS = alpha g_rab in bf16 into the product tile `ss`,
// and g_rab of the valid elements (`okm`) into drab at rows row0 + acc_row,
// columns col0 + w * 32 + acc_col: a thread's cell pairs (c, c + 1), c even,
// as 8-byte accesses where aligned (with an odd `nk`, every other row's are
// not).
__device__ __forceinline__ void ds_rab_part(const float (&dp)[16], const float (&g)[16],
                                            uint32_t okm, unsigned char* ss, const Rab& rab,
                                            size_t plane, float alpha, int row0, int col0, int w,
                                            int t) {
  uint32_t pk[8];
#pragma unroll
  for (int i = 0; i < 16; i += 2) {
    const float g0 = dp[i] * g[i], g1 = dp[i + 1] * g[i + 1];
    pk[i / 2] = sm90::pack_bf16(g0 * alpha, g1 * alpha);
    if (rab.grad)
      rab.add_grad2(rab.grad + plane + (size_t)(row0 + sm90::acc_row(t, i)) * rab.nk + col0 +
                        w * 32 + sm90::acc_col(t, i),
                    g0, g1, (okm >> i) & 1, (okm >> (i + 1)) & 1);
  }
  put_block(ss, w * 32, pk, t);
}

// ------------------------------------------------------------ K3: dk, dv (RAB: K4's dk, dv)
template <int DH, bool RAB>
__global__ void __launch_bounds__(NTHREADS, 1)
dkv_wgmma_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mo,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, Params p, Rab rab) {
  using L = Tile<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = sm90::align1024(smem_raw);
  unsigned char* sV = sK + L::BYTES;
  unsigned char* sQ = sV + L::BYTES;                 // [STAGES] tiles
  unsigned char* sO = sQ + STAGES * L::BYTES;        // [STAGES] tiles of dO
  unsigned char* sP = sO + STAGES * L::BYTES;        // [2] P^T
  unsigned char* sS = sP + 2 * PT;                   // [2] dS^T
  auto* ring = reinterpret_cast<sm90::Ring<STAGES>*>(sS + 2 * PT);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(ring + 1);

  const Seq s(p, blockIdx.z);
  const int n0 = blockIdx.x * BT;   // causal: the first key tiles walk furthest
  if (n0 >= s.n) return;
  const int col = blockIdx.y * DH;
  const QueryTiles tiles(p, s, n0, BT);
  const size_t plane = RAB ? rab.plane(blockIdx.z, blockIdx.y) : 0;
  if (threadIdx.x == 0) {
    ring->init(NC * 128);
    sm90::mbar_init(kv_full, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {   // producer
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == NC * 128) {
      sm90::mbar_expect_tx(kv_full, 2 * L::BYTES);
      load_tile<DH>(sK, &mk, col, s.off + n0, kv_full);
      load_tile<DH>(sV, &mv, col, s.off + n0, kv_full);
      for (int i = 0; i < tiles.count; ++i) {
        const int st = i % STAGES, row = s.off + tiles.row0(i);
        ring->producer_acquire(i, 2 * L::BYTES);
        load_tile<DH>(sQ + st * L::BYTES, &mq, col, row, &ring->full[st]);
        load_tile<DH>(sO + st * L::BYTES, &mo, col, row, &ring->full[st]);
      }
    }
  } else {          // consumers
    sm90::setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128;
    float dka[L::HALF / 2], dva[L::HALF / 2];
#pragma unroll
    for (int i = 0; i < L::HALF / 2; ++i) dka[i] = dva[i] = 0.f;
    float bias[16];   // K4: the bias of this tile's score block, loaded a tile ahead
    if constexpr (RAB) load_bias<true>(bias, rab, plane, s.n, n0, tiles.row0(0) + wg * 32, t);
    sm90::mbar_wait(kv_full, 0);
    for (int i = 0; i < tiles.count; ++i) {
      const unsigned char* q_s = sQ + (i % STAGES) * L::BYTES;
      const unsigned char* o_s = sO + (i % STAGES) * L::BYTES;
      unsigned char* sp = sP + (i & 1) * PT;
      unsigned char* ss = sS + (i & 1) * PT;
      const int q0 = tiles.row0(i);
      ring->consumer_wait(i);

      // transposed score blocks: rows keys, columns queries wg * 32 ..; S
      // and dP commit apart, so the SiLU work overlaps the dP chain
      float st[16], dpt[16], g[16];
      sm90::wgmma_fence();
      score_chain<DH>(st, sK, q_s, wg * 32);
      sm90::wgmma_commit();
      score_chain<DH>(dpt, sV, o_s, wg * 32);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(st);
      silu_tile<true, RAB>(st, g, sp, p, s, q0, n0, wg, t, bias);
      if constexpr (RAB)   // the next tile's bias flies behind this tile's products
        if (i + 1 < tiles.count)
          load_bias<true>(bias, rab, plane, s.n, n0, tiles.row0(i + 1) + wg * 32, t);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dpt);
      ds_part(dpt, g, ss, wg, t);
      sm90::fence_async_smem();
      sm90::named_sync<NC * 128>(1);   // both halves of P^T and dS^T written

      sm90::fence_regs(dva);
      sm90::fence_regs(dka);
      sm90::wgmma_fence();
      out_chain<DH>(dva, sp, o_s, wg * L::HALF);   // dv += P^T dO
      out_chain<DH>(dka, ss, q_s, wg * L::HALF);   // dk += dS^T q
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dva);
      sm90::fence_regs(dka);
      ring->consumer_release(i);
    }
    const size_t ld = (size_t)p.H * DH;
    const size_t base = (size_t)s.off * ld + col;
    store_acc<DH>(dk + base, ld, dka, n0, s.n, wg * L::HALF, t);
    store_acc<DH>(dv + base, ld, dva, n0, s.n, wg * L::HALF, t);
  }
}

// ------------------------------------------------------------ K2: dq (RAB: K4's dq + drab)
template <int DH, bool RAB>
__global__ void __launch_bounds__(NTHREADS, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mo,
                bf16* __restrict__ dq, Params p, Rab rab) {
  using L = Tile<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = sm90::align1024(smem_raw);
  unsigned char* sO = sQ + L::BYTES;                 // dO
  unsigned char* sK = sO + L::BYTES;                 // [STAGES] tiles
  unsigned char* sV = sK + STAGES * L::BYTES;        // [STAGES] tiles
  unsigned char* sS = sV + STAGES * L::BYTES;        // [2] dS
  auto* ring = reinterpret_cast<sm90::Ring<STAGES>*>(sS + 2 * PT);
  uint64_t* qo_full = reinterpret_cast<uint64_t*>(ring + 1);

  const Seq s(p, blockIdx.z);
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BT;   // the last tiles walk furthest
  if (m0 >= s.n) return;
  const int col = blockIdx.y * DH;
  const int n_tiles = (s.kv_end(p, m0, BT) + BT - 1) / BT;
  const size_t plane = RAB ? rab.plane(blockIdx.z, blockIdx.y) : 0;
  if (threadIdx.x == 0) {
    ring->init(NC * 128);
    sm90::mbar_init(qo_full, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {   // producer
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == NC * 128) {
      sm90::mbar_expect_tx(qo_full, 2 * L::BYTES);
      load_tile<DH>(sQ, &mq, col, s.off + m0, qo_full);
      load_tile<DH>(sO, &mo, col, s.off + m0, qo_full);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES, row = s.off + i * BT;
        ring->producer_acquire(i, 2 * L::BYTES);
        load_tile<DH>(sK + st * L::BYTES, &mk, col, row, &ring->full[st]);
        load_tile<DH>(sV + st * L::BYTES, &mv, col, row, &ring->full[st]);
      }
    }
  } else {          // consumers
    sm90::setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128;
    float dqa[L::HALF / 2];
#pragma unroll
    for (int i = 0; i < L::HALF / 2; ++i) dqa[i] = 0.f;
    sm90::mbar_wait(qo_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const unsigned char* k_s = sK + (i % STAGES) * L::BYTES;
      const unsigned char* v_s = sV + (i % STAGES) * L::BYTES;
      unsigned char* ss = sS + (i & 1) * PT;
      const int k0 = i * BT;
      ring->consumer_wait(i);

      // score blocks, columns wg * 32 ..; S and dP commit apart. The bias
      // loads are issued first, so they fly behind the chains.
      float sc[16], dp[16], g[16], bias[16];
      uint32_t okm = 0;
      if constexpr (RAB) load_bias<false>(bias, rab, plane, s.n, m0, k0 + wg * 32, t);
      sm90::wgmma_fence();
      score_chain<DH>(sc, sQ, k_s, wg * 32);
      sm90::wgmma_commit();
      score_chain<DH>(dp, sO, v_s, wg * 32);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(sc);
      silu_tile<false, RAB, RAB>(sc, g, nullptr, p, s, m0, k0, wg, t, bias, &okm);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
      if constexpr (RAB)
        ds_rab_part(dp, g, okm, ss, rab, plane, p.alpha, m0, k0, wg, t);
      else
        ds_part(dp, g, ss, wg, t);
      sm90::fence_async_smem();
      sm90::named_sync<NC * 128>(1);   // both halves of dS written

      sm90::fence_regs(dqa);
      sm90::wgmma_fence();
      out_chain<DH>(dqa, ss, k_s, wg * L::HALF);   // dq += dS k
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dqa);
      ring->consumer_release(i);
    }
    const size_t ld = (size_t)p.H * DH;
    store_acc<DH>(dq + (size_t)s.off * ld + col, ld, dqa, m0, s.n, wg * L::HALF, t);
  }
}

// ------------------------------------------------------------ layout check
// One CTA of the two consumer warpgroups runs the kernels' two product
// chains on one tile pair: s = a b^T ([64][64], consumer w its columns
// w * 32 ..) from two TMA-loaded [64][DH] tiles read K-major, and o = p b
// ([64][DH], consumer w its columns w * DH/2 ..) with p written by the
// threads into a product tile and b read MN-major. chip_smoke.py holds both
// against torch.matmul, so a wrong descriptor shows as itself.
template <int DH>
__global__ void __launch_bounds__(NC * 128)
tile_check_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
                  const bf16* __restrict__ pg, float* __restrict__ s_out,
                  float* __restrict__ o_out) {
  using L = Tile<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sA = sm90::align1024(smem_raw);
  unsigned char* sB = sA + L::BYTES;
  unsigned char* sP = sB + L::BYTES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sP + PT);
  if (threadIdx.x == 0) {
    sm90::mbar_init(bar, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_expect_tx(bar, 2 * L::BYTES);
    load_tile<DH>(sA, &ma, 0, 0, bar);
    load_tile<DH>(sB, &mb, 0, 0, bar);
  }
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  for (int e = t; e < BT * 16; e += 128) {   // this consumer's 32 columns, in pairs
    const int r = e / 16, c = wg * 32 + (e % 16) * 2;
    put_pair(sP, r, c, __bfloat162float(pg[r * BT + c]), __bfloat162float(pg[r * BT + c + 1]));
  }
  sm90::mbar_wait(bar, 0);
  sm90::fence_async_smem();
  sm90::named_sync<NC * 128>(1);

  float sacc[16], oacc[L::HALF / 2];
#pragma unroll
  for (int i = 0; i < L::HALF / 2; ++i) oacc[i] = 0.f;
  sm90::fence_regs(oacc);
  sm90::wgmma_fence();
  score_chain<DH>(sacc, sA, sB, wg * 32);
  out_chain<DH>(oacc, sP, sB, wg * L::HALF);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sacc);
  sm90::fence_regs(oacc);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    s_out[sm90::acc_row(t, i) * BT + wg * 32 + sm90::acc_col(t, i)] = sacc[i];
#pragma unroll
  for (int i = 0; i < L::HALF / 2; ++i)
    o_out[sm90::acc_row(t, i) * DH + wg * L::HALF + sm90::acc_col(t, i)] = oacc[i];
}

// ------------------------------------------------------------ launch
using sm90::launch;

#define BWD_DISPATCH_DH(dh, CALL)                                     \
  switch (dh) {                                                       \
    case 32: { constexpr int DH = 32; return CALL; }                  \
    case 64: { constexpr int DH = 64; return CALL; }                  \
    case 128: { constexpr int DH = 128; return CALL; }                \
    case 256: { constexpr int DH = 256; return CALL; }                \
    default: return -1;                                               \
  }

}  // namespace

// All four take bf16 [T, H, dh] q, k, v and dO (dh 32, 64, 128 or 256;
// 16-byte aligned), int32 seq_offsets [B + 1] and optional int32
// num_contextuals / num_targets [B] (null when absent), and write the bf16
// gradients of the rows the sequences own. Each returns the CUDA error code
// of its launch (0 on success), -1 for an unsupported head dim or group size
// (or, for K4's, a missing bias), -2 / -3 when a tensor map cannot be
// made.
#define BWD_ARGS                                                                 \
  const int *seq_offsets, const int *num_contextuals, const int *num_targets,    \
      int T, int B, int H, int dh, int max_seqlen, float alpha, float inv_scaling, \
      int causal, int target_group_size, int max_attn_len,                       \
      int min_full_attn_seq_len

#define BWD_PROLOGUE                                                             \
  if (target_group_size < 1) return -1;                                          \
  if (T == 0 || B == 0 || H == 0 || max_seqlen == 0) return 0;                   \
  const Params p{seq_offsets, num_contextuals, num_targets, H, alpha,            \
                 inv_scaling, causal, target_group_size, max_attn_len,           \
                 min_full_attn_seq_len};                                         \
  CUtensorMap m[4];                                                              \
  const void* const x[4] = {q, k, v, dout};                                      \
  if (dh != 32 && dh != 64 && dh != 128 && dh != 256) return -1;                 \
  if (const int err = sm90::make_row_maps(m, x, T, H, dh)) return err;           \
  const dim3 grid((max_seqlen + BT - 1) / BT, H, B);                             \
  cudaStream_t st = static_cast<cudaStream_t>(stream);

extern "C" int hstu_attn_bwd_dq_launch(const void* q, const void* k, const void* v,
                                       const void* dout, void* dq, BWD_ARGS, void* stream) {
  BWD_PROLOGUE
  bf16* dQ = static_cast<bf16*>(dq);
  const Rab none{};
  BWD_DISPATCH_DH(dh, launch(dq_wgmma_kernel<DH, false>, smem_bytes<DH, 2>(), grid, NTHREADS,
                             st, m[0], m[1], m[2], m[3], dQ, p, none))
}

// K4's dq + drab: besides, the fp32 or bf16 bias `rab` [rb, rh, nq, nk] with
// `rab_sb` / `rab_sh` elements between batches / heads (0 for a broadcast
// dim) and `rab_nk` between rows, and the zero-filled fp32 `drab` of the same
// layout (null: no bias gradient), summed with atomics when `drab_atomic`.
extern "C" int hstu_attn_rab_bwd_dq_launch(const void* q, const void* k, const void* v,
                                           const void* dout, void* dq, BWD_ARGS,
                                           const void* rab, void* drab, long long rab_sb,
                                           long long rab_sh, int rab_nk, int rab_is_bf16,
                                           int drab_atomic, void* stream) {
  if (!rab) return -1;
  BWD_PROLOGUE
  bf16* dQ = static_cast<bf16*>(dq);
  const Rab r{rab, static_cast<float*>(drab), rab_sb, rab_sh, rab_nk, rab_is_bf16, drab_atomic};
  BWD_DISPATCH_DH(dh, launch(dq_wgmma_kernel<DH, true>, smem_bytes<DH, 2>(), grid, NTHREADS,
                             st, m[0], m[1], m[2], m[3], dQ, p, r))
}

extern "C" int hstu_attn_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                        const void* dout, void* dk, void* dv, BWD_ARGS,
                                        void* stream) {
  BWD_PROLOGUE
  bf16 *dK = static_cast<bf16*>(dk), *dV = static_cast<bf16*>(dv);
  const Rab none{};
  BWD_DISPATCH_DH(dh, launch(dkv_wgmma_kernel<DH, false>, smem_bytes<DH, 4>(), grid, NTHREADS,
                             st, m[0], m[1], m[2], m[3], dK, dV, p, none))
}

// K4's dk/dv: the bias arguments of K4's dq; `drab` and `drab_atomic` are
// not read (dk/dv writes no bias gradient).
extern "C" int hstu_attn_rab_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                            const void* dout, void* dk, void* dv, BWD_ARGS,
                                            const void* rab, void* drab, long long rab_sb,
                                            long long rab_sh, int rab_nk, int rab_is_bf16,
                                            int drab_atomic, void* stream) {
  if (!rab) return -1;
  BWD_PROLOGUE
  bf16 *dK = static_cast<bf16*>(dk), *dV = static_cast<bf16*>(dv);
  const Rab r{rab, nullptr, rab_sb, rab_sh, rab_nk, rab_is_bf16, 0};
  BWD_DISPATCH_DH(dh, launch(dkv_wgmma_kernel<DH, true>, smem_bytes<DH, 4>(), grid, NTHREADS,
                             st, m[0], m[1], m[2], m[3], dK, dV, p, r))
}

// The layout check: bf16 a, b [64][dh] and p [64][64] (row-major), fp32
// s_out [64][64] = a b^T and o_out [64][dh] = p b. Same return codes.
extern "C" int hstu_bwd_tile_check_launch(const void* a, const void* b, const void* pg,
                                          void* s_out, void* o_out, int dh, void* stream) {
  if (dh != 32 && dh != 64 && dh != 128 && dh != 256) return -1;
  CUtensorMap m[2];
  const void* const x[2] = {a, b};
  if (const int err = sm90::make_row_maps(m, x, BT, 1, dh)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* P = static_cast<const bf16*>(pg);
  float *S = static_cast<float*>(s_out), *O = static_cast<float*>(o_out);
  BWD_DISPATCH_DH(dh, launch(tile_check_kernel<DH>, 1024 + 2 * Tile<DH>::BYTES + PT + 8,
                             dim3(1), NC * 128, st, m[0], m[1], P, S, O))
}

// The forward of the jagged SiLU (HSTU) attention for Hopper (sm_90a): K1,
// K4's forward (K1 with a dense relative attention bias) as its RAB = true
// instance, and K5 (K1 on int8 q, k, v) as its I8 = true instance, on wgmma
// with TMA-fed tiles and P kept in registers.
//
// Replaces the TPU kernel `_fwd_kernel` (:235) of
// recsys_examples_tpu/ops/pallas/hstu_attention.py, launched by
// `_hstu_fwd_impl` (:1092, pallas_call :1173), its `has_rab` branch
// (:391-392) reached through `hstu_attn_varlen_rab` (:1482), and its
// `quantized` branch (:375-384, :421-422) reached through
// `hstu_attn_varlen_quantized_calibrated` (:1541). For each
// sequence b of the packed [T, H, D] bf16 tensors (rows seq_offsets[b] ..
// seq_offsets[b + 1]) and each head:
//   S = alpha q k^T (+ rab) (fp32),  P = silu(S) / scaling * mask,  out = P(bf16) v
// with fp32 sums, a bf16 output and the mask of `_compute_mask`
// (hstu_mask.cuh); rab is [B|1, H|1, Nq, Nk], fp32 or bf16, positions local
// to the sequence. K5 takes int8 q, k, v with per-tensor scales: alpha
// holds alpha q_scale k_scale, and out = bf16(v_scale P(bf16) v8). Rows that
// no sequence owns are never written: the caller zero-fills the output.
// Each CTA owns its output rows (no atomics), so every instance is
// deterministic.
//
// What bounds it on an H100 (989 TFLOP/s dense bf16, 3.35 TB/s): operations.
// Every valid (query, key) pair costs two products (S, P v) of 2 D FLOPs: at
// the full-width training batch (22,458 tokens, 4 heads of 256) 122.8 GFLOP
// or 0.124 ms, against 0.055 ms for the 184 MB of q, k, v and out (and, with
// the model's fp32 [1, 4, 8195, 8195] bias, 0.05 ms more for the 167 MB of
// bias cells that a valid pair reaches).
//
// Design. One CTA per (128 query rows, head, sequence), the last query rows
// (which walk furthest) launched first. Three warpgroups:
//   - a producer warp (its warpgroup trimmed to 24 registers) loads the CTA's
//     Q once, as two 64-row tiles, and streams the 64-row K and V tiles
//     through two rings of two stages each (full/empty mbarriers), over the
//     same [T][H * D] TMA maps as K2 and K3 (sm90_wgmma.cuh);
//   - two consumer warpgroups (240 registers: O's 128 sums and the score's
//     64 a thread are live while the score chains run). Consumer w owns the
//     query rows m0 + 64 w .. + 63 and computes the key tiles those rows
//     reach (`fwd_tiles`); past them, and when its rows lie past the
//     sequence, it releases the stages untouched. Per key tile: S = Q_w K^T
//     (two m64n64k16 chains over D, both operands K-major), the mask and
//     SiLU in registers, then P repacked to bf16 A fragments (`acc_to_a`)
//     for O_w += P V (A in registers, V read MN-major, m64nNk16 chains with
//     N = min(D, 128)). P never goes through shared memory, and O_w stays in
//     D / 2 fp32 registers a thread.
// The two consumers take turns at issuing, through two named barriers
// (FlashAttention-3's ping-pong): consumer w issues S_i, hands the turn on
// and runs its SiLU pass while the other's products run, then issues
// P_i V_i. K_i is freed after S_i, V_i after P_i V_i, so K and V have rings
// of their own. (Pipelining S_{i+1} behind P_i V_i in one turn, as
// FlashAttention-3 does, holds P and both score sums beside O, more than
// 240 registers at D = 256.)
// The mask is evaluated per element only on edge tiles, as in K2 and K3: a
// (consumer, key tile) pair that `tile_fully_valid` certifies skips it, an
// edge tile takes the causal form where `causal_edge` holds, else
// `Seq::valid`. A packed tile that starts at row off + r0 holds the next
// sequence's rows past n (TMA zero-fills only past T): the mask makes P zero
// there, and stores stay below n.
//
// The bias (RAB). Every tile adds its bias cells, interior tiles too; cells
// past the sequence's end read 0. It cannot ride TMA (the model's row
// stride, 32,780 bytes, is not a multiple of 16), and 32 more live registers
// a thread would spill O. So each consumer thread has a slot of 32 fp32
// words in shared memory (16 KB a consumer) for the bias cells of its own
// accumulator elements, and each warp fills its threads' slots by 4-byte
// cp.async, row by row: a copy instruction reads 32 neighbouring cells of
// one row, where each thread copying its own cells would touch 8 rows of 4
// (0.028 ms slower at the full-width batch: PERF.md). The warp then needs
// its own copies only: cp.async.wait_group and a warp sync, no barrier.
// Tile i + 1's copies start right after tile i's SiLU pass has read the
// slots, so they fly behind P_i V_i, the other consumer's S turn and
// S_{i + 1}. Each copy moves the aligned 4-byte word that holds the cell: an
// fp32 cell, or a bf16 cell beside its neighbour (with an odd row stride
// every other row's bf16 pairs are not 4-byte aligned); the SiLU pass takes
// the cell's half, and reads a slot quad of a warp as 512 contiguous bytes.
//
// Shared memory at D = 256: Q 64 KB and 2 x (K + V) 128 KB, 192 KB of 227;
// with the bias 224 KB.
//
// K5, the int8 instance. Its score is a product of int8 values: each term
// is at most 127^2 in size, so at D <= 256 every partial sum stays below 2^24
// and an fp32 sum of the terms is exact in any order. Q and K arrive as int8
// tiles by TMA over int8 [T, H * D] maps (a 128-byte swizzle panel holds 128
// int8 columns: `Tile8`), and S = Q K^T runs as one m64n64k32 s8.s8.s32
// chain, converted to fp32: the same S, bit for bit, as the TPU kernel's
// product of the values widened to bf16, at twice the bf16 rate (both
// bounds are in PERF.md). P is bf16, so V is widened: the producer warp
// loads V's int8 rows by TMA into a ring of its own, and the producer's
// warpgroup's other three warps (96 threads) widen each arrived tile into
// the swizzled bf16 V stage that K1 reads (two integer ops and one bf16x2
// subtraction a pair of values, exact), then arrive on the consumers' full
// barrier: one producer a ring. The consumers give up K1's second score sum
// (the int32 chain is exact), so setmaxnreg gives them 216 registers and
// the producer's warpgroup 72. Shared memory at D = 256: Q 32 KB, the K
// ring 32 KB, the int8 V ring 32 KB and the bf16 V stages 64 KB: 160 KB.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "hstu_mask.cuh"
#include "sm90_wgmma.cuh"

namespace {

using sm90::bf16;
using sm90::load_tile;
using sm90::Tile;
using sm90::Tile8;

constexpr int BT = sm90::TILE_ROWS;       // rows of every tile (64)
constexpr int NC = 2;                     // consumer warpgroups
constexpr int NTHREADS = 128 * (NC + 1);  // + the producer's warpgroup
constexpr int STAGES = 2;                 // of the K ring and of the V ring
constexpr int TURN = 1;                   // named barrier TURN + w: consumer w's turn
constexpr int WIDENED = TURN + NC;        // named barrier of K5's widening warps

// setmaxnreg's split of the 168 registers a thread holds at entry: K1 and
// K4 give the consumers (O's DH / 2 sums, two score sums, P) 240 and the
// producer warp 24; K5's consumers hold one score sum, and its producer's
// warpgroup widens V.
template <bool I8>
struct Roles {
  static constexpr int WIDEN = I8 ? 96 : 0;   // widening threads
  static constexpr int CONSUMER = I8 ? 216 : 240;
  static constexpr int PRODUCER = I8 ? 72 : 24;
  static_assert(NC * 128 * CONSUMER + 128 * PRODUCER <= 168 * NTHREADS, "");
};

// The product chains K1 shares with K6 (sm90_wgmma.cuh).
using sm90::Out;
using sm90::fence_out;
using sm90::pv_chain;
using sm90::score_chain;
using sm90::sigmoid;

// ------------------------------------------------------------ K4: the bias
constexpr int SLOT = 32 * 128 * 4;   // bytes of a consumer's bias slots: 32 words a thread

// Byte offset of thread t's word i in its consumer's slots: quad i / 4 of
// every thread, then the next quad, so a warp reads a quad as 512
// contiguous bytes.
__device__ __forceinline__ uint32_t slot_word(int i, int t) {
  return ((i / 4 * 128 + t) * 4 + i % 4) * 4;
}

// Cell index of a consumer thread's bias row h (query row q0 + acc_row(t,
// 2 h) of the sequence) in rab, for this CTA's sequence and head.
__device__ __forceinline__ size_t bias_row(const Rab& rab, int q0, int t, int h) {
  return rab.plane(blockIdx.z, blockIdx.y) + (size_t)(q0 + sm90::acc_row(t, 2 * h)) * rab.nk;
}

// How a consumer thread reads its slot words back as fp32 bias cells:
// (word << shift) & mask. An fp32 cell is its word (shift 0, mask ~0). A
// bf16 cell is one half of its word: the high half (shift 0) or the low one
// (shift 16), mask 0xffff0000. Which half depends on the parity of the
// cell's address, so on its row (h = (i / 2) % 2) and its column's parity (i
// % 2, a tile's first column being even): the shift of (h, j) sits at bits
// 8 (2 h + j) of `shifts`. Made every tile from an `opaque` thread index,
// like the copies' addresses, so nothing of it stays live across the tile
// loop, where O's sums and the score's fill the registers.
struct BiasRead {
  uint32_t slot, shifts, mask;
  __device__ float cell(uint32_t word, int i) const {
    const uint32_t sh = (shifts >> (8 * (i & 3))) & 31;
    return __uint_as_float((word << sh) & mask);
  }
};

__device__ __forceinline__ BiasRead bias_read(const Rab& rab, int q0, int t, uint32_t slot) {
  t = sm90::opaque(t);
  BiasRead b{slot + slot_word(0, t), 0u, ~0u};
  if (rab.is_bf16) {
    b.mask = 0xffff0000u;
    const size_t cell0 = reinterpret_cast<uintptr_t>(rab.ptr) / 2;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (((cell0 + bias_row(rab, q0, t, h) + j) & 1) == 0) b.shifts |= 16u << (8 * (2 * h + j));
  }
  return b;
}

// Start the copies of the bias cells of a consumer warp's 16 score rows
// (query rows q0 + 16 w + r of the sequence, w the warp, r < 16) and the
// tile's 64 columns (k0 + c) into their owners' slot words (the thread that
// holds element i of row r, column c): row by row, lane l copying cells l
// and 32 + l, so each copy instruction reads 32 neighbouring cells (the
// owners' own copies would touch 8 rows of 4 cells). Each copy is the
// aligned 4-byte word that holds the cell. Cells past the sequence, and
// every cell when !go, come in as zero. The thread index is made `opaque`,
// so the addresses are computed here, per tile: hoisted out of the tile
// loop, they would pin registers that O's sums need.
__device__ __forceinline__ void fetch_bias(const Rab& rab, uint32_t slot, int n, int q0, int k0,
                                           int t, bool go) {
  t = sm90::opaque(t);
  const int lane = t & 31, w = t >> 5;
  const int lg = rab.is_bf16 ? 1 : 2;                // log2 of a cell's bytes
  const int r0 = q0 + 16 * w;                        // the warp's first row
  const int rows = go ? n - r0 : 0;                  // its rows r < rows lie inside
  const int lim = n - k0;                            // a row's cells c < lim lie inside
  const uintptr_t base = reinterpret_cast<uintptr_t>(rab.ptr), safe = base & ~uintptr_t(3);
  const size_t stride = (size_t)rab.nk << lg;
  uintptr_t row = base + ((rab.plane(blockIdx.z, blockIdx.y) + (size_t)r0 * rab.nk + k0) << lg);
#pragma unroll
  for (int r = 0; r < 16; ++r, row += stride)
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int c = lane + 32 * x;
      const int i = 4 * (c >> 3) + 2 * (r >> 3) + (c & 1);       // the owner's element
      const int owner = 32 * w + 4 * (r & 7) + ((c >> 1) & 3);   // and its thread
      const bool ok = r < rows && c < lim;
      const uintptr_t a = ok ? (row + ((uintptr_t)c << lg)) & ~uintptr_t(3) : safe;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(slot + slot_word(i, owner)), "l"(a), "r"(ok ? 4 : 0));
    }
  sm90::cp_async_commit();
}

// ------------------------------------------------------------ elementwise
// P = silu(x) / scaling * mask in place, x = alpha S (RAB: + the bias cells
// of the thread's slot, landed), for query rows q0 + acc_row and key columns
// k0 + acc_col.
template <Mask MASK, bool RAB>
__device__ __forceinline__ void silu_part(float (&sc)[32], const Params& p, const Seq& s, int q0,
                                          int k0, int t, const BiasRead& b) {
#pragma unroll
  for (int i = 0; i < 32; i += 4) {
    uint4 w{};
    if constexpr (RAB) w = sm90::ld_shared4(b.slot + slot_word(i, 0));
    const uint32_t word[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[i + e] * p.alpha;
      if constexpr (RAB) x += b.cell(word[e], i + e);
      const bool ok = mask_ok<MASK>(p, s, q0 + sm90::acc_row(t, i + e), k0 + sm90::acc_col(t, i + e));
      sc[i + e] = ok ? x * sigmoid(x) * p.inv_scaling : 0.f;
    }
  }
}

// silu_part with the mask form of the tile [q0, q0 + 64) x [k0, k0 + 64).
template <bool RAB>
__device__ __forceinline__ void silu_tile(float (&sc)[32], const Params& p, const Seq& s, int q0,
                                          int k0, int t, const BiasRead& b) {
  if (s.tile_fully_valid(p, q0, k0, BT))
    silu_part<NONE, RAB>(sc, p, s, q0, k0, t, b);
  else if (s.causal_edge(p))
    silu_part<CAUSAL, RAB>(sc, p, s, q0, k0, t, b);
  else
    silu_part<FULL, RAB>(sc, p, s, q0, k0, t, b);
}

// Store a consumer's [64 x DH] accumulator as bf16 to rows row0 + r < n of
// `dst` (row 0 of the sequence at this head).
template <int DH>
__device__ __forceinline__ void store_out(bf16* dst, size_t ld,
                                          const float (&o)[Out<DH>::NCH][Out<DH>::CH / 2],
                                          int row0, int n, int t) {
#pragma unroll
  for (int j = 0; j < Out<DH>::NCH; ++j)
#pragma unroll
    for (int i = 0; i < Out<DH>::CH / 2; i += 2) {
      const int r = row0 + sm90::acc_row(t, i);
      if (r < n)
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * ld + j * Out<DH>::CH +
                                           sm90::acc_col(t, i)) =
            __floats2bfloat162_rn(o[j][i], o[j][i + 1]);
    }
}

// Shared memory: Q's two tiles, the K and V rings, (RAB) the consumers' bias
// slots, (I8) the ring of V's int8 rows, then the rings' barriers and Q's;
// 1024 bytes of slack align the base. I8: Q and K are int8 tiles (`Tile8`).
template <int DH, bool RAB, bool I8>
struct Smem {
  using QK = typename std::conditional<I8, Tile8<DH>, Tile<DH>>::type;
  static constexpr int RAW = I8 ? BT * DH : 0;   // bytes of V's int8 rows
  static constexpr int K = NC * QK::BYTES;        // offsets from the aligned base
  static constexpr int V = K + STAGES * QK::BYTES;
  static constexpr int BIAS = V + STAGES * Tile<DH>::BYTES;
  static constexpr int R = BIAS + (RAB ? NC * SLOT : 0);
  static constexpr int BARS = R + STAGES * RAW;
  static constexpr size_t bytes = 1024 + BARS + 3 * sizeof(sm90::Ring<STAGES>) + 8;
};

// K5's widening warps (`w` the thread's index among them) feed the bf16 V
// ring, use by use: each tile's int8 rows from the int8 ring, widened into
// the swizzled bf16 stage, after which they free the int8 stage and arrive
// on the consumers' full barrier.
template <int DH>
__device__ __forceinline__ void widen_v(unsigned char* sR, unsigned char* sV,
                                        sm90::Ring<STAGES>* rring, sm90::Ring<STAGES>* vring,
                                        int n_tiles, int w) {
  constexpr int VPR = DH / 16;   // 16-byte int8 vectors a row
  constexpr int WIDEN = Roles<true>::WIDEN;
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES;
    sm90::mbar_wait(&vring->empty[st], ((i / STAGES) & 1) ^ 1);   // the bf16 stage is free
    rring->consumer_wait(i);
    const uint32_t src = sm90::smem_u32(sR + st * BT * DH);
    const uint32_t dst = sm90::smem_u32(sV + st * Tile<DH>::BYTES);
    for (uint32_t v = w; v < BT * VPR; v += WIDEN) {
      const uint32_t r = v / VPR, c16 = (v % VPR) * 16;
      uint32_t o[8];
      sm90::widen16(o, sm90::ld_shared4(src + r * DH + c16));
      sm90::st_shared4(dst + sm90::tile_off<DH>(r, c16), make_uint4(o[0], o[1], o[2], o[3]));
      sm90::st_shared4(dst + sm90::tile_off<DH>(r, c16 + 8), make_uint4(o[4], o[5], o[6], o[7]));
    }
    rring->consumer_release(i);   // the int8 stage is read
    sm90::fence_async_smem();      // the widened tile, for wgmma
    sm90::named_sync<WIDEN>(WIDENED);
    if (w == 0) sm90::mbar_arrive(&vring->full[st]);
  }
}

// ------------------------------------------------------------ K1 (RAB: K4's forward; I8: K5)
template <int DH, bool RAB, bool I8>
__global__ void __launch_bounds__(NTHREADS, 1)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv, bf16* __restrict__ out, Params p,
                 Rab rab, float v_scale) {
  using L = Tile<DH>;
  using O = Out<DH>;
  using S = Smem<DH, RAB, I8>;
  using QK = typename S::QK;
  using R = Roles<I8>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = sm90::align1024(smem_raw);     // [NC] tiles: consumer w's rows
  unsigned char* sK = sQ + S::K;                     // [STAGES] tiles
  unsigned char* sV = sQ + S::V;                     // [STAGES] tiles (bf16)
  unsigned char* sB = sQ + S::BIAS;                  // RAB: [NC] consumers' bias slots
  unsigned char* sR = sQ + S::R;                     // I8: [STAGES] V's int8 rows
  auto* kring = reinterpret_cast<sm90::Ring<STAGES>*>(sQ + S::BARS);
  auto* vring = kring + 1;
  auto* rring = kring + 2;                           // I8: V's int8 rows
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kring + 3);

  const Seq s(p, blockIdx.z);
  const int m0 = (gridDim.x - 1 - blockIdx.x) * NC * BT;   // the last rows walk furthest
  if (m0 >= s.n) return;
  const int col = blockIdx.y * DH;
  const int n_tiles = s.fwd_cta_tiles(p, m0);
  if (threadIdx.x == 0) {
    kring->init(NC * 128);
    vring->init(NC * 128);
    if (I8) rring->init(R::WIDEN);
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {   // producer (I8: and the wideners)
    sm90::setmaxnreg_dec<R::PRODUCER>();
    const int pt = threadIdx.x - NC * 128;
    if (pt == 0) {
      const int nq = m0 + BT < s.n ? NC : 1;   // consumer 1's rows, if it has any
      sm90::mbar_expect_tx(q_full, nq * QK::BYTES);
      for (int w = 0; w < nq; ++w) {
        if constexpr (I8)
          sm90::load_tile8<DH>(sQ + w * QK::BYTES, &mq, col, s.off + m0 + w * BT, q_full);
        else
          load_tile<DH>(sQ + w * QK::BYTES, &mq, col, s.off + m0 + w * BT, q_full);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES, row = s.off + i * BT;
        kring->producer_acquire(i, QK::BYTES);
        if constexpr (I8) {
          sm90::load_tile8<DH>(sK + st * QK::BYTES, &mk, col, row, &kring->full[st]);
          rring->producer_acquire(i, S::RAW);
          sm90::tma_load_2d(sR + st * S::RAW, &mv, col, row, &rring->full[st]);
        } else {
          load_tile<DH>(sK + st * L::BYTES, &mk, col, row, &kring->full[st]);
          vring->producer_acquire(i, L::BYTES);
          load_tile<DH>(sV + st * L::BYTES, &mv, col, row, &vring->full[st]);
        }
      }
    }
    if constexpr (I8) {
      if (pt >= 32) widen_v<DH>(sR, sV, rring, vring, n_tiles, pt - 32);
    }
  } else {          // consumers
    sm90::setmaxnreg_inc<R::CONSUMER>();
    const int t = threadIdx.x % 128;
    const int q0 = m0 + wg * BT;
    const int mine = s.fwd_tiles(p, q0);   // the key tiles this consumer computes
    const unsigned char* q_s = sQ + wg * QK::BYTES;
    const uint32_t slot = sm90::smem_u32(sB + wg * SLOT);
    if constexpr (RAB) fetch_bias(rab, slot, s.n, q0, 0, t, mine > 0);   // behind Q's load
    float o[O::NCH][O::CH / 2];
#pragma unroll
    for (int j = 0; j < O::NCH; ++j)
#pragma unroll
      for (int i = 0; i < O::CH / 2; ++i) o[j][i] = 0.f;
    uint32_t pa[16];   // P, as A fragments
    float sc[32], odd[32];
    int si[32];        // I8: the int32 score
    const auto k_s = [&](int i) { return sK + (i % STAGES) * QK::BYTES; };
    const auto v_s = [&](int i) { return sV + (i % STAGES) * L::BYTES; };
    // Two turns a key tile: S_i, then P_i V_i. Consumer 0 goes first, each
    // hands the turn on after issuing, and consumer 0 takes one more turn at
    // the end, for consumer 1's last hand-on. A consumer's SiLU pass runs
    // between its two turns, beside the other's products. The wgmma chains
    // sit in straight code: issued under a branch, ptxas serialises them.
    const auto turn = [&] { sm90::named_sync<NC * 128>(TURN + wg); };
    const auto pass = [&] { sm90::named_arrive<NC * 128>(TURN + 1 - wg); };
    if (wg == 1) sm90::named_arrive<NC * 128>(TURN);
    sm90::mbar_wait(q_full, 0);
    int i = 0;
    for (; i < mine; ++i) {
      kring->consumer_wait(i);
      turn();
      sm90::wgmma_fence();
      if constexpr (I8)
        sm90::score_chain8<DH>(si, q_s, k_s(i));
      else
        score_chain<DH>(sc, odd, q_s, k_s(i));
      sm90::wgmma_commit();
      pass();
      sm90::wgmma_wait<0>();
      if constexpr (I8) {
        sm90::fence_regs(si);
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] = (float)si[e];   // exact: |S| < 2^24
      } else {
        sm90::fence_regs(sc);
        sm90::fence_regs(odd);
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] += odd[e];
      }
      kring->consumer_release(i);
      if constexpr (RAB) {   // the warp's copies of this tile's bias landed
        sm90::cp_async_wait<0>();
        __syncwarp();
      }
      silu_tile<RAB>(sc, p, s, q0, i * BT, t, RAB ? bias_read(rab, q0, t, slot) : BiasRead{});
      sm90::acc_to_a(pa, sc);
      // the warp has read its slots: key tile i + 1's bias flies behind P_i V_i
      if constexpr (RAB) {
        __syncwarp();
        fetch_bias(rab, slot, s.n, q0, (i + 1) * BT, t, i + 1 < mine);
      }
      vring->consumer_wait(i);
      turn();
      fence_out<DH>(o);
      sm90::wgmma_fence();
      pv_chain<DH>(o, pa, v_s(i));
      sm90::wgmma_commit();
      pass();
      sm90::wgmma_wait<0>();
      fence_out<DH>(o);
      vring->consumer_release(i);
    }
    if constexpr (RAB) sm90::cp_async_wait<0>();
    for (; i < n_tiles; ++i) {   // the CTA's tiles past this consumer's rows
      kring->consumer_wait(i);
      kring->consumer_release(i);
      vring->consumer_wait(i);
      vring->consumer_release(i);
      turn();
      pass();
      turn();
      pass();
    }
    if (wg == 0) turn();
    if constexpr (I8) {
#pragma unroll
      for (int j = 0; j < O::NCH; ++j)
#pragma unroll
        for (int e = 0; e < O::CH / 2; ++e) o[j][e] *= v_scale;
    }
    const size_t ld = (size_t)p.H * DH;
    store_out<DH>(out + (size_t)s.off * ld + col, ld, o, q0, s.n, t);
  }
}

// ------------------------------------------------------------ layout check
// One consumer warpgroup runs K1's two product chains on one tile pair:
// s = a b^T ([64][64]) from two TMA-loaded [64][DH] tiles read K-major, and
// o = p b ([64][DH]) with p loaded into the accumulator layout, repacked by
// `acc_to_a` into A fragments and b read MN-major. chip_smoke.py holds both
// against torch.matmul, so a wrong fragment or descriptor shows as itself.
template <int DH>
__global__ void __launch_bounds__(128)
tile_check_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
                  const bf16* __restrict__ pg, float* __restrict__ s_out,
                  float* __restrict__ o_out) {
  using L = Tile<DH>;
  using O = Out<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sA = sm90::align1024(smem_raw);
  unsigned char* sB = sA + L::BYTES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sB + L::BYTES);
  const int t = threadIdx.x;
  if (t == 0) {
    sm90::mbar_init(bar, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (t == 0) {
    sm90::mbar_expect_tx(bar, 2 * L::BYTES);
    load_tile<DH>(sA, &ma, 0, 0, bar);
    load_tile<DH>(sB, &mb, 0, 0, bar);
  }
  float pf[32], sacc[32], odd[32], o[O::NCH][O::CH / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i)
    pf[i] = __bfloat162float(pg[sm90::acc_row(t, i) * BT + sm90::acc_col(t, i)]);
  uint32_t pa[16];
  sm90::acc_to_a(pa, pf);
#pragma unroll
  for (int j = 0; j < O::NCH; ++j)
#pragma unroll
    for (int i = 0; i < O::CH / 2; ++i) o[j][i] = 0.f;
  sm90::mbar_wait(bar, 0);
  fence_out<DH>(o);
  sm90::wgmma_fence();
  score_chain<DH>(sacc, odd, sA, sB);
  pv_chain<DH>(o, pa, sB);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sacc);
  sm90::fence_regs(odd);
  fence_out<DH>(o);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    s_out[sm90::acc_row(t, i) * BT + sm90::acc_col(t, i)] = sacc[i] + odd[i];
#pragma unroll
  for (int j = 0; j < O::NCH; ++j)
#pragma unroll
    for (int i = 0; i < O::CH / 2; ++i)
      o_out[sm90::acc_row(t, i) * DH + j * O::CH + sm90::acc_col(t, i)] = o[j][i];
}

// The same for K5's two chains: s = a b^T from two int8 tiles (`Tile8`,
// the s8 chain), exact in int32; and o = p b with b's int8 rows loaded
// without swizzle and widened by the 128 threads into a bf16 tile, as K5's
// widening warps do, then read MN-major.
template <int DH>
__global__ void __launch_bounds__(128)
tile_check_i8_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
                     const __grid_constant__ CUtensorMap mr, const bf16* __restrict__ pg,
                     float* __restrict__ s_out, float* __restrict__ o_out) {
  using L8 = Tile8<DH>;
  using L = Tile<DH>;
  using O = Out<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sA = sm90::align1024(smem_raw);
  unsigned char* sB = sA + L8::BYTES;
  unsigned char* sW = sB + L8::BYTES;        // b widened
  unsigned char* sR = sW + L::BYTES;         // b's int8 rows
  uint64_t* bar = reinterpret_cast<uint64_t*>(sR + BT * DH);
  const int t = threadIdx.x;
  if (t == 0) {
    sm90::mbar_init(bar, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (t == 0) {
    sm90::mbar_expect_tx(bar, 2 * L8::BYTES + BT * DH);
    sm90::load_tile8<DH>(sA, &ma, 0, 0, bar);
    sm90::load_tile8<DH>(sB, &mb, 0, 0, bar);
    sm90::tma_load_2d(sR, &mr, 0, 0, bar);
  }
  float pf[32], o[O::NCH][O::CH / 2];
  int si[32];
#pragma unroll
  for (int i = 0; i < 32; ++i)
    pf[i] = __bfloat162float(pg[sm90::acc_row(t, i) * BT + sm90::acc_col(t, i)]);
  uint32_t pa[16];
  sm90::acc_to_a(pa, pf);
#pragma unroll
  for (int j = 0; j < O::NCH; ++j)
#pragma unroll
    for (int i = 0; i < O::CH / 2; ++i) o[j][i] = 0.f;
  sm90::mbar_wait(bar, 0);
  for (uint32_t v = t; v < BT * DH / 16; v += 128) {
    const uint32_t r = v / (DH / 16), c16 = (v % (DH / 16)) * 16;
    uint32_t w[8];
    sm90::widen16(w, sm90::ld_shared4(sm90::smem_u32(sR) + r * DH + c16));
    const uint32_t d = sm90::smem_u32(sW);
    sm90::st_shared4(d + sm90::tile_off<DH>(r, c16), make_uint4(w[0], w[1], w[2], w[3]));
    sm90::st_shared4(d + sm90::tile_off<DH>(r, c16 + 8), make_uint4(w[4], w[5], w[6], w[7]));
  }
  sm90::fence_async_smem();
  __syncthreads();
  fence_out<DH>(o);
  sm90::wgmma_fence();
  sm90::score_chain8<DH>(si, sA, sB);
  pv_chain<DH>(o, pa, sW);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(si);
  fence_out<DH>(o);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    s_out[sm90::acc_row(t, i) * BT + sm90::acc_col(t, i)] = (float)si[i];
#pragma unroll
  for (int j = 0; j < O::NCH; ++j)
#pragma unroll
    for (int i = 0; i < O::CH / 2; ++i)
      o_out[sm90::acc_row(t, i) * DH + j * O::CH + sm90::acc_col(t, i)] = o[j][i];
}

#define FWD_DISPATCH_DH(dh, CALL)                                     \
  switch (dh) {                                                       \
    case 32: { constexpr int DH = 32; return CALL; }                  \
    case 64: { constexpr int DH = 64; return CALL; }                  \
    case 128: { constexpr int DH = 128; return CALL; }                \
    case 256: { constexpr int DH = 256; return CALL; }                \
    default: return -1;                                               \
  }

// K1, K4's forward (RAB) and K5 (I8: int8 q, k, v).
template <bool RAB, bool I8>
int fwd_launch(const void* q, const void* k, const void* v, void* out, const int* seq_offsets,
               const int* num_contextuals, const int* num_targets, int T, int B, int H, int dh,
               int max_seqlen, float alpha, float inv_scaling, int causal, int target_group_size,
               int max_attn_len, int min_full_attn_seq_len, const Rab& rab, float v_scale,
               void* stream) {
  if (target_group_size < 1 || (RAB && !rab.ptr)) return -1;
  if (T == 0 || B == 0 || H == 0 || max_seqlen == 0) return 0;
  if (dh != 32 && dh != 64 && dh != 128 && dh != 256) return -1;
  const Params p{seq_offsets, num_contextuals, num_targets, H, alpha, inv_scaling, causal,
                 target_group_size, max_attn_len, min_full_attn_seq_len};
  CUtensorMap m[3];
  const void* const x[3] = {q, k, v};
  int err = 0;
  if (I8) {   // q and k in swizzled int8 panels; v's rows whole, unswizzled (widened)
    const uint64_t cols = (uint64_t)H * dh;
    err = sm90::make_row_map_i8(&m[0], q, T, H, dh);
    if (!err) err = sm90::make_row_map_i8(&m[1], k, T, H, dh);
    if (!err) err = sm90::make_map(&m[2], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, v, T, cols, cols, BT,
                                   dh, CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    err = sm90::make_row_maps(m, x, T, H, dh);
  }
  if (err) return err;
  const dim3 grid((max_seqlen + NC * BT - 1) / (NC * BT), H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* O = static_cast<bf16*>(out);
  FWD_DISPATCH_DH(dh, sm90::launch(fwd_wgmma_kernel<DH, RAB, I8>, Smem<DH, RAB, I8>::bytes, grid,
                                   NTHREADS, st, m[0], m[1], m[2], O, p, rab, v_scale))
}

}  // namespace

// K1: bf16 [T, H, dh] q, k, v (dh 32, 64, 128 or 256; 16-byte aligned),
// int32 seq_offsets [B + 1] and optional int32 num_contextuals / num_targets
// [B] (null when absent); writes the bf16 output rows the sequences own.
// Returns the CUDA error code of its launch (0 on success), -1 for an
// unsupported head dim or group size, -2 / -3 when a tensor map cannot be
// made.
extern "C" int hstu_attn_fwd_launch(const void* q, const void* k, const void* v, void* out,
                                    const int* seq_offsets, const int* num_contextuals,
                                    const int* num_targets, int T, int B, int H, int dh,
                                    int max_seqlen, float alpha, float inv_scaling, int causal,
                                    int target_group_size, int max_attn_len,
                                    int min_full_attn_seq_len, void* stream) {
  return fwd_launch<false, false>(q, k, v, out, seq_offsets, num_contextuals, num_targets, T, B,
                                  H, dh, max_seqlen, alpha, inv_scaling, causal,
                                  target_group_size, max_attn_len, min_full_attn_seq_len, Rab{},
                                  1.f, stream);
}

// K4's forward: besides, the fp32 or bf16 bias `rab` [rb, rh, nq, nk] with
// `rab_sb` / `rab_sh` elements between batches / heads (0 for a broadcast
// dim) and `rab_nk` between rows. `drab` and `drab_atomic` are not read (they
// keep the argument list of K4's dq). Same return codes; -1 without a bias.
extern "C" int hstu_attn_rab_fwd_launch(const void* q, const void* k, const void* v, void* out,
                                        const int* seq_offsets, const int* num_contextuals,
                                        const int* num_targets, int T, int B, int H, int dh,
                                        int max_seqlen, float alpha, float inv_scaling,
                                        int causal, int target_group_size, int max_attn_len,
                                        int min_full_attn_seq_len, const void* rab, void* drab,
                                        long long rab_sb, long long rab_sh, int rab_nk,
                                        int rab_is_bf16, int drab_atomic, void* stream) {
  const Rab r{rab, nullptr, rab_sb, rab_sh, rab_nk, rab_is_bf16, 0};
  return fwd_launch<true, false>(q, k, v, out, seq_offsets, num_contextuals, num_targets, T, B, H,
                                 dh, max_seqlen, alpha, inv_scaling, causal, target_group_size,
                                 max_attn_len, min_full_attn_seq_len, r, 1.f, stream);
}

// K5: int8 q, k, v [T, H, dh] (dh 32, 64, 128 or 256; 16-byte aligned), the
// rest as K1; `alpha` already times q_scale * k_scale, and the bf16 output
// is scaled by `v_scale`. Same return codes.
extern "C" int hstu_attn_fwd_int8_launch(const void* q, const void* k, const void* v, void* out,
                                         const int* seq_offsets, const int* num_contextuals,
                                         const int* num_targets, int T, int B, int H, int dh,
                                         int max_seqlen, float alpha, float inv_scaling,
                                         int causal, int target_group_size, int max_attn_len,
                                         int min_full_attn_seq_len, float v_scale, void* stream) {
  return fwd_launch<false, true>(q, k, v, out, seq_offsets, num_contextuals, num_targets, T, B, H,
                                 dh, max_seqlen, alpha, inv_scaling, causal, target_group_size,
                                 max_attn_len, min_full_attn_seq_len, Rab{}, v_scale, stream);
}

// The layout check: bf16 a, b [64][dh] and p [64][64] (row-major), fp32
// s_out [64][64] = a b^T and o_out [64][dh] = p b. Same return codes.
extern "C" int hstu_fwd_tile_check_launch(const void* a, const void* b, const void* pg,
                                          void* s_out, void* o_out, int dh, void* stream) {
  if (dh != 32 && dh != 64 && dh != 128 && dh != 256) return -1;
  CUtensorMap m[2];
  const void* const x[2] = {a, b};
  if (const int err = sm90::make_row_maps(m, x, BT, 1, dh)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* P = static_cast<const bf16*>(pg);
  float *S = static_cast<float*>(s_out), *O = static_cast<float*>(o_out);
  FWD_DISPATCH_DH(dh, sm90::launch(tile_check_kernel<DH>, 1024 + 2 * Tile<DH>::BYTES + 8,
                                   dim3(1), 128, st, m[0], m[1], P, S, O))
}

// K5's layout check: int8 a, b [64][dh], bf16 p [64][64] (row-major); fp32
// s_out [64][64] = a b^T (exact) and o_out [64][dh] = p b. Same return codes.
extern "C" int hstu_fwd_i8_tile_check_launch(const void* a, const void* b, const void* pg,
                                             void* s_out, void* o_out, int dh, void* stream) {
  if (dh != 32 && dh != 64 && dh != 128 && dh != 256) return -1;
  CUtensorMap m[3];
  int err = sm90::make_row_map_i8(&m[0], a, BT, 1, dh);
  if (!err) err = sm90::make_row_map_i8(&m[1], b, BT, 1, dh);
  if (!err) err = sm90::make_map(&m[2], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, b, BT, dh, dh, BT, dh,
                                 CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* P = static_cast<const bf16*>(pg);
  float *S = static_cast<float*>(s_out), *O = static_cast<float*>(o_out);
  FWD_DISPATCH_DH(dh, sm90::launch(tile_check_i8_kernel<DH>,
                                   1024 + 2 * Tile8<DH>::BYTES + Tile<DH>::BYTES + BT * DH + 8,
                                   dim3(1), 128, st, m[0], m[1], m[2], P, S, O))
}

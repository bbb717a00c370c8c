// The forward of the jagged SiLU (HSTU) attention for Hopper (sm_90a): K1,
// and K4's forward (K1 with a dense relative attention bias) as its RAB =
// true instance, on wgmma with TMA-fed tiles and P kept in registers.
//
// Replaces the TPU kernel `_fwd_kernel` (:235) of
// recsys_examples_tpu/ops/pallas/hstu_attention.py, launched by
// `_hstu_fwd_impl` (:1092, pallas_call :1173), and its `has_rab` branch
// (:391-392) reached through `hstu_attn_varlen_rab` (:1482). For each
// sequence b of the packed [T, H, D] bf16 tensors (rows seq_offsets[b] ..
// seq_offsets[b + 1]) and each head:
//   S = alpha q k^T (+ rab) (fp32),  P = silu(S) / scaling * mask,  out = P(bf16) v
// with fp32 sums, a bf16 output and the mask of `_compute_mask`
// (hstu_mask.cuh); rab is [B|1, H|1, Nq, Nk], fp32 or bf16, positions local
// to the sequence. Rows that no sequence owns are never written: the caller
// zero-fills the output. Each CTA owns its output rows (no atomics), so both
// instances are deterministic.
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hstu_mask.cuh"
#include "sm90_wgmma.cuh"

namespace {

using sm90::bf16;
using sm90::load_tile;
using sm90::Tile;

constexpr int BT = sm90::TILE_ROWS;       // rows of every tile (64)
constexpr int NC = 2;                     // consumer warpgroups
constexpr int NTHREADS = 128 * (NC + 1);  // + the producer's warpgroup
constexpr int STAGES = 2;                 // of the K ring and of the V ring
constexpr int TURN = 1;                   // named barrier TURN + w: consumer w's turn

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
// slots, then the rings' barriers and Q's; 1024 bytes of slack align the
// base.
template <int DH, bool RAB>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)(NC + 2 * STAGES) * Tile<DH>::BYTES + (RAB ? NC * SLOT : 0) +
         2 * sizeof(sm90::Ring<STAGES>) + 8;
}

// ------------------------------------------------------------ K1 (RAB: K4's forward)
template <int DH, bool RAB>
__global__ void __launch_bounds__(NTHREADS, 1)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv, bf16* __restrict__ out, Params p,
                 Rab rab) {
  using L = Tile<DH>;
  using O = Out<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = sm90::align1024(smem_raw);     // [NC] tiles: consumer w's rows
  unsigned char* sK = sQ + NC * L::BYTES;            // [STAGES] tiles
  unsigned char* sV = sK + STAGES * L::BYTES;        // [STAGES] tiles
  unsigned char* sB = sV + STAGES * L::BYTES;        // RAB: [NC] consumers' bias slots
  auto* kring = reinterpret_cast<sm90::Ring<STAGES>*>(sB + (RAB ? NC * SLOT : 0));
  auto* vring = kring + 1;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vring + 1);

  const Seq s(p, blockIdx.z);
  const int m0 = (gridDim.x - 1 - blockIdx.x) * NC * BT;   // the last rows walk furthest
  if (m0 >= s.n) return;
  const int col = blockIdx.y * DH;
  const int n_tiles = s.fwd_cta_tiles(p, m0);
  if (threadIdx.x == 0) {
    kring->init(NC * 128);
    vring->init(NC * 128);
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {   // producer
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == NC * 128) {
      const int nq = m0 + BT < s.n ? NC : 1;   // consumer 1's rows, if it has any
      sm90::mbar_expect_tx(q_full, nq * L::BYTES);
      for (int w = 0; w < nq; ++w)
        load_tile<DH>(sQ + w * L::BYTES, &mq, col, s.off + m0 + w * BT, q_full);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES, row = s.off + i * BT;
        kring->producer_acquire(i, L::BYTES);
        load_tile<DH>(sK + st * L::BYTES, &mk, col, row, &kring->full[st]);
        vring->producer_acquire(i, L::BYTES);
        load_tile<DH>(sV + st * L::BYTES, &mv, col, row, &vring->full[st]);
      }
    }
  } else {          // consumers
    sm90::setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128;
    const int q0 = m0 + wg * BT;
    const int mine = s.fwd_tiles(p, q0);   // the key tiles this consumer computes
    const unsigned char* q_s = sQ + wg * L::BYTES;
    const uint32_t slot = sm90::smem_u32(sB + wg * SLOT);
    if constexpr (RAB) fetch_bias(rab, slot, s.n, q0, 0, t, mine > 0);   // behind Q's load
    float o[O::NCH][O::CH / 2];
#pragma unroll
    for (int j = 0; j < O::NCH; ++j)
#pragma unroll
      for (int i = 0; i < O::CH / 2; ++i) o[j][i] = 0.f;
    uint32_t pa[16];   // P, as A fragments
    float sc[32], odd[32];
    const auto k_s = [&](int i) { return sK + (i % STAGES) * L::BYTES; };
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
      score_chain<DH>(sc, odd, q_s, k_s(i));
      sm90::wgmma_commit();
      pass();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      sm90::fence_regs(odd);
      kring->consumer_release(i);
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] += odd[e];
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

#define FWD_DISPATCH_DH(dh, CALL)                                     \
  switch (dh) {                                                       \
    case 32: { constexpr int DH = 32; return CALL; }                  \
    case 64: { constexpr int DH = 64; return CALL; }                  \
    case 128: { constexpr int DH = 128; return CALL; }                \
    case 256: { constexpr int DH = 256; return CALL; }                \
    default: return -1;                                               \
  }

// K1 and K4's forward.
template <bool RAB>
int fwd_launch(const void* q, const void* k, const void* v, void* out, const int* seq_offsets,
               const int* num_contextuals, const int* num_targets, int T, int B, int H, int dh,
               int max_seqlen, float alpha, float inv_scaling, int causal, int target_group_size,
               int max_attn_len, int min_full_attn_seq_len, const Rab& rab, void* stream) {
  if (target_group_size < 1 || (RAB && !rab.ptr)) return -1;
  if (T == 0 || B == 0 || H == 0 || max_seqlen == 0) return 0;
  if (dh != 32 && dh != 64 && dh != 128 && dh != 256) return -1;
  const Params p{seq_offsets, num_contextuals, num_targets, H, alpha, inv_scaling, causal,
                 target_group_size, max_attn_len, min_full_attn_seq_len};
  CUtensorMap m[3];
  const void* const x[3] = {q, k, v};
  if (const int err = sm90::make_row_maps(m, x, T, H, dh)) return err;
  const dim3 grid((max_seqlen + NC * BT - 1) / (NC * BT), H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* O = static_cast<bf16*>(out);
  FWD_DISPATCH_DH(dh, sm90::launch(fwd_wgmma_kernel<DH, RAB>, smem_bytes<DH, RAB>(), grid,
                                   NTHREADS, st, m[0], m[1], m[2], O, p, rab))
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
  return fwd_launch<false>(q, k, v, out, seq_offsets, num_contextuals, num_targets, T, B, H, dh,
                           max_seqlen, alpha, inv_scaling, causal, target_group_size,
                           max_attn_len, min_full_attn_seq_len, Rab{}, stream);
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
  return fwd_launch<true>(q, k, v, out, seq_offsets, num_contextuals, num_targets, T, B, H, dh,
                          max_seqlen, alpha, inv_scaling, causal, target_group_size,
                          max_attn_len, min_full_attn_seq_len, r, stream);
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

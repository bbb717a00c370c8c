// Beam-decode attention for SID-GR generation, for Hopper (sm_90a): the
// bf16 kernel on wgmma with TMA-fed context chunks, the keys of a
// (batch row, kv head) split over a thread-block cluster, and the fp32
// scalar kernel.
//
// Replaces the TPU kernel recsys_examples_tpu/ops/pallas/beam_decode_attention.py
// `_kernel` (:86, launched by `_pallas_impl` :235, pallas_call :313; entry
// `beam_decode_attn` :331). One decode step of softmax attention for W
// beams: per batch b, query beam w and head h
//   keys = k_ctx[b, :ctx_lens[b], h / G]
//          ++ [k_beam[b, n, ancestry[b, n, w], h / G] for n < N]
//   out[b, w, h] = softmax(q[b, w, h] . keys * sm_scale) . values
// with G = H / Hkv query heads sharing a kv head. The context is shared by
// the W beams of a batch row; the N tail keys differ per beam and are found
// through the ancestry (the beam slot that holds step n's K/V on w's path).
// A row with no key at all (ctx_len 0 and N 0) comes out as zero.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s dense bf16): bytes. At
// the full-width serving shape (B 16, W 200, H = Hkv = 8 heads of 128, bf16)
// every valid context row is 2 x 8 x 128 x 2 = 4 KB of K and V and serves
// 200 beams at 4 x 200 x 8 x 128 = 0.82 MFLOP: about 200 FLOP a byte, below
// the card's ridge of about 295, so the kernel reaches its bound only if each
// context chunk of a (batch row, kv head) is read from memory once and the
// tensor cores never wait on it. q, out and the tail rows the ancestry
// reaches add to the bytes. chip_smoke.py computes both bounds from the
// run's ctx_lens.
//
// Design (bf16). The plan is the plain statements of
// recsys_examples_torch/ops/beam_decode_attention.py, copied line by line:
// `beam_batch_order`, `beam_row_tiles`, `beam_cta_rows` and
// `beam_cta_chunks`, with the split of `beam_split_plan` from the wrapper
// (tests/test_torch_beam_plan.py holds them). The measurements behind it
// (a 256-row CTA of four consumers on 32-key chunks, the tail as
// diagonal-masked chunks, S of the next chunk issued before the softmax
// step, a two-chain score: all slower or no faster) are in PERF.md, from
// paged_study.py.
//  - Rows. A CTA's query rows are (query head, beam) pairs of one kv head of
//    one batch row, row r being beam r / G of query head kv_head G + r % G,
//    so the G heads of a GQA group share every context load. The G W rows
//    of a (b, kv head) go to the fewest CTAs of 128 rows (two consumer
//    warpgroups of 64), in even shares: at W 200 two tiles of 100 rows, and
//    no tile makes a context pass for a handful of rows while another is
//    full. Grid (splits, tiles, B Hkv): the tiles of a (b, kv head) launch
//    next to each other, so their second reads of the context hit L2, and
//    the batch rows in the order of their context lengths, longest first
//    (`beam_batch_order`, ranked by each CTA from ctx_lens): at B 16 the
//    256 CTAs take two waves, and a long row launched last would end the
//    call alone.
//  - Loads. A producer warp streams the 64-key context chunks of K and V
//    through a full/empty mbarrier ring by TMA, over 3-D maps
//    [B][S][Hkv D] (any position stride and batch stride, a context
//    broadcast over the batch being one batch of the map; positions past S
//    read as zero; no map at S 0). Q is loaded once, by the consumers, with
//    16-byte cp.async into the swizzled panel layout (a row's G heads are
//    strided by D, its beams by q's beam stride: no TMA box takes both).
//  - Products. S = Q K^T as one m64n64k16 chain over D (both K-major); the
//    online softmax (running m and l in fp32) works in the accumulator
//    layout, in log2 units (p = 2^(s c - m), c = sm_scale log2(e)), a row's
//    max and sum reduced as a tree over the thread's values and then over
//    the 4 threads of a quad. Masked columns take -1e30, never -inf, and
//    add exactly 0 to l and O.
//    Interior chunks take no mask, the last context chunk the column test
//    against ctx_len. P is rounded to bf16 and repacked into A fragments
//    (`acc_to_a`) for O += P V (V read MN-major); l sums the unrounded P.
//  - The beam tail. TMA cannot gather rows, so the producer's warpgroup
//    (128 threads) gathers step n's K/V rows (ancestry[b, n, w]) for a
//    consumer's 64 rows by cp.async into a ring stage, as one more chunk
//    whose key j belongs to row j. The gathers follow the context chunks in
//    the ring, so they are issued while the consumers still work on the
//    last context chunks, not after them. A thread loads the ancestry slots
//    of all its rows of a chunk before it issues a copy, and chunk k's
//    copies fly while chunk k - 1's are awaited: gathered one by one, with
//    a dependent slot load before each copy, a tail step cost about 13 us
//    at B 16. The consumers fold a tail chunk in as rank-1 updates from
//    shared memory, each thread over the columns its accumulator holds
//    (the rows in registers would take 64 a thread a step at D 128, beside
//    O's 64).
//  - Split over the context, summed in a cluster. When B Hkv tiles leaves
//    the card short of work (B 1, or GQA with few kv heads), the `splits`
//    CTAs of a cluster (along x) share the chunks of a (b, kv head, tile):
//    `splits` is the largest up to 16 whose clusters the card holds in one
//    wave (`beam_cluster_capacity`). Rank r takes an even share of the
//    ctx chunks + N units, the tail's N steps going to the last rank whole.
//    Each CTA puts its (m, l) and fp32 O in its own shared memory (where
//    the tiles were); after a cluster barrier rank r's consumers merge rows
//    [r R / splits, (r + 1) R / splits) over the ranks in rank order through
//    distributed shared memory, O = sum_q O_q e_q / sum_q l_q e_q with e_q =
//    2^(m_q - max_q m_q) (m in log2 units), round to bf16 and store them; a second barrier
//    keeps every CTA's shared memory alive until all have read it.
//    Deterministic: no workspace in device memory, no atomics; with one
//    split the merge is O / l.
//  - Warp specialisation: 384 threads, 168 registers a thread at entry;
//    setmaxnreg gives the consumers 216 and the producer's warpgroup 72
//    (at D 256: 224 and 56, O alone being 128 sums a consumer thread).
//    Shared memory at D 128: Q 32 KB and 5 stages of K + V (160 KB); at D
//    256: Q 64 KB and 2 stages (128 KB), the merge's fp32 O (133 KB) where
//    they were. Head dims 32, 64, 128 and 256 are built; the wrapper pads
//    others to the next.
// Positions in [ctx_len, S) of the last context chunk are read and masked:
// like the plain version, which multiplies their zero probabilities by V,
// that assumes finite contents (the model's context comes from its prefill).
//
// fp32 (off the serving path, which runs bf16): `scalar::kernel`, 256
// threads of scalar FMA, 32 rows per CTA, 8 threads a row, chunks of 32
// keys, the N tail keys folded in as rank-1 updates.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90_wgmma.cuh"

namespace {

using sm90::bf16;
using sm90::Tile;

constexpr float NEG = -1e30f;

struct Args {
  const int* ctx_lens;          // [B]
  const int* anc;               // [B, N, W] or null when N == 0
  int W, H, G, S, N;
  int tiles;                    // bf16: row tiles per (batch row, kv head)
  long long q_sb, q_sw;         // q: elements between batch rows / beams
  long long c_sb, c_ss;         // context K/V: between batch rows / positions
  long long b_sb, b_sn, b_sw;   // beam K/V: between batch rows / steps / slots
  float sm_scale;
};

// ------------------------------------------------ bf16: wgmma
namespace wg {

constexpr int NC = 2;                   // consumer warpgroups (BEAM_CONSUMERS)
constexpr int QR = sm90::TILE_ROWS;     // query rows per consumer (BEAM_ROWS)
constexpr int CTA_ROWS = NC * QR;       // BEAM_CTA_ROWS
constexpr int CK = 64;                  // context keys per chunk (BEAM_CHUNK)
// chunks in flight: 5 (a stage of K + V is 32 KB at DH 128); 2 at DH 256
// (64 KB a stage, beside 64 KB of Q)
template <int DH>
constexpr int stages() { return DH == 256 ? 2 : 320 / CK; }
constexpr int TPC = QR / CK;            // tail chunks of a consumer per step
constexpr int THREADS = 128 * (NC + 1);
constexpr int OPAD = 4;                 // fp32 words of padding per row of O
// named barriers
constexpr int CONSUMERS_DONE = 1, PRODUCER_READY = 2, GATHERED = 3, Q_READY = 4;   // + consumer

// setmaxnreg's split of the registers a thread holds at entry: the
// consumers hold O's DH / 2 sums, the score's CK / 2 and P's CK / 4 (at DH
// 256: 128 + 32 + 16 of 224).
constexpr int ENTRY = 65536 / THREADS / 8 * 8;
template <int DH>
struct Regs {
  static constexpr int CONSUMER = DH == 256 ? 224 : 216;
  static constexpr int PRODUCER = DH == 256 ? 56 : 72;
  static_assert(NC == 2 && NC * 128 * CONSUMER + 128 * PRODUCER <= ENTRY * THREADS, "");
};

// Shared memory after the ring's barriers, from a 1024-byte boundary: the
// consumers' Q tiles, then STAGES stages of (K tile, V tile) of CK rows.
// After the chunks, the merge's fp32 O [CTA_ROWS][DH + OPAD] and (m, l)
// [CTA_ROWS] take their place.
template <int DH>
struct Smem {
  using QT = Tile<DH>;
  using KT = Tile<DH, CK>;
  static constexpr int STAGE = 2 * KT::BYTES;
  static constexpr int KV = NC * QT::BYTES;
  static constexpr int STAGES = stages<DH>();
  static constexpr int END = KV + STAGES * STAGE;
  static constexpr int LD = DH + OPAD;
  static constexpr int ML = CTA_ROWS * LD * 4;
  static_assert(ML + CTA_ROWS * 8 <= END, "the merge fits where the tiles were");
  static constexpr int HEAD = sizeof(sm90::Ring<STAGES>) + 16;   // the ring, the batch row
  static constexpr size_t bytes = HEAD + 1024 + END;
};

// beam_batch_order: the batch row whose context is the k-th longest (ties
// by index), so the CTAs of the longest contexts launch first. The CTA's
// threads rank the B rows together; a barrier follows.
__device__ __forceinline__ void find_batch_row(const Args& a, int B, int k, int* row) {
  const auto len = [&](int i) { return max(0, min(a.ctx_lens[i], a.S)); };
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    const int li = len(i);
    int rank = 0;
    for (int j = 0; j < B; ++j) {
      const int lj = len(j);
      rank += lj > li || (lj == li && j < i);
    }
    if (rank == k) *row = i;
  }
}

// The CTA's (batch row, kv head), rows and chunks: beam_cta_rows and
// beam_cta_chunks; `b` from find_batch_row.
struct Cta {
  int b, ctx_b, kvh, r0, r1, ctx_len, n_ctx, c_begin, c_end;   // ctx_b: b in the maps
  bool tail;
  __device__ Cta(const Args& a, int b_, uint32_t rank, int splits)
      : b(b_), ctx_b(a.c_sb ? b_ : 0) {
    const int hkv = a.H / a.G, R = a.G * a.W;
    kvh = blockIdx.z % hkv;
    r0 = (int)blockIdx.y * R / a.tiles;
    r1 = ((int)blockIdx.y + 1) * R / a.tiles;
    ctx_len = max(0, min(a.ctx_lens[b], a.S));
    n_ctx = (ctx_len + CK - 1) / CK;
    const int T = n_ctx + a.N;
    c_begin = min((int)rank * T / splits, n_ctx);
    c_end = (int)rank == splits - 1 ? n_ctx : min(((int)rank + 1) * T / splits, n_ctx);
    tail = (int)rank == splits - 1 && a.N > 0;
  }
};

struct Maps {
  CUtensorMap k, v;   // the context as [B][S][Hkv D] bf16
};

// The producer's warpgroup (`pt` its thread): thread 0 loads the context
// chunks by TMA; then (the last rank) all 128 gather the tail's chunks:
// step n's K and V rows of consumer c's rows h CK .. h CK + CK - 1, key j in
// row j, rows past the CTA's zero-filled. A ring takes one producer at a
// time (its parity waits cannot tell a round from the one before the last):
// the gathers start once thread 0 has acquired every context use.
template <int DH>
__device__ __forceinline__ void produce(const Maps& m, const Args& a, const Cta& T,
                                        const bf16* __restrict__ k_beam,
                                        const bf16* __restrict__ v_beam, unsigned char* tiles,
                                        sm90::Ring<Smem<DH>::STAGES>* ring, int pt) {
  using S = Smem<DH>;
  using KT = typename S::KT;
  constexpr int STAGES = S::STAGES;
  const int nc = T.c_end - T.c_begin;
  if (pt == 0) {
    for (int u = 0; u < nc; ++u) {
      const int st = u % STAGES, c = T.c_begin + u;
      unsigned char* kt = tiles + S::KV + st * S::STAGE;
      ring->producer_acquire(u, 2 * KT::BYTES);
#pragma unroll
      for (int i = 0; i < KT::NP; ++i) {
        const int col = T.kvh * DH + i * KT::PW;
        sm90::tma_load_3d(kt + i * KT::PANEL, &m.k, col, c * CK, T.ctx_b, &ring->full[st]);
        sm90::tma_load_3d(kt + KT::BYTES + i * KT::PANEL, &m.v, col, c * CK, T.ctx_b,
                          &ring->full[st]);
      }
    }
  }
  if (!T.tail) return;
  sm90::named_sync<128>(PRODUCER_READY);
  // Thread pt copies the 16-byte piece c8 of rows j0, j0 + JS, ... of each
  // chunk: its slots are loaded together, then its copies issued; chunk k's
  // copies fly while chunk k - 1's are awaited and handed on.
  constexpr int VPR = DH / 8;                 // 16-byte pieces a row
  constexpr int JS = 128 / VPR;               // rows between a thread's pieces
  constexpr int RPT = CK / JS;                // pieces a thread copies a chunk
  const int c8 = (pt % VPR) * 8, j0 = pt / VPR;
  const int n_tail = a.N * NC * TPC;
  for (int k = 0; k <= n_tail; ++k) {
    if (k < n_tail) {
      const int u = nc + k, st = u % STAGES;
      const int n = k / (NC * TPC), first = T.r0 + ((k / TPC) % NC) * QR + (k % TPC) * CK;
      unsigned char* kt = tiles + S::KV + st * S::STAGE;
      const int* anc = a.anc + ((size_t)T.b * a.N + n) * a.W;
      const size_t base = (size_t)T.b * a.b_sb + (size_t)n * a.b_sn + (size_t)T.kvh * DH + c8;
      int slot[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = first + j0 + i * JS;
        slot[i] = r < T.r1 ? anc[r / a.G] : -1;   // rows past the CTA's: zero-filled
      }
      sm90::mbar_wait(&ring->empty[st], ((u / STAGES) & 1) ^ 1);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const bool ok = slot[i] >= 0;
        const size_t off = ok ? base + (size_t)slot[i] * a.b_sw : 0;
        const uint32_t d = sm90::tile_off<DH, CK>(j0 + i * JS, c8);
        sm90::cp_async16(kt + d, k_beam + off, ok);
        sm90::cp_async16(kt + KT::BYTES + d, v_beam + off, ok);
      }
      sm90::cp_async_commit();
    }
    if (k > 0) {   // chunk k - 1's rows landed: hand it to the consumers
      if (k < n_tail)
        sm90::cp_async_wait<1>();
      else
        sm90::cp_async_wait<0>();
      sm90::fence_async_smem();   // the gathered rows, for wgmma
      sm90::named_sync<128>(GATHERED);
      if (pt == 0) sm90::mbar_arrive(&ring->full[(nc + k - 1) % STAGES]);
    }
  }
}

enum Form { INTERIOR, EDGE };

// 2^x (the special-function unit's approximation, as __expf uses it)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two bf16 values at a shared-memory address, as floats.
__device__ __forceinline__ float2 bf2(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// max or sum of the thread's CK / 8 values of row x of an accumulator
// (elements 4 g + 2 x and + 1), as a tree: no chain of CK / 8 dependent
// operations
template <bool MAX>
__device__ __forceinline__ float row_reduce(const float (&v)[CK / 2], int x) {
  float r[CK / 8];
#pragma unroll
  for (int g = 0; g < CK / 8; ++g)
    r[g] = MAX ? fmaxf(v[4 * g + 2 * x], v[4 * g + 2 * x + 1]) : v[4 * g + 2 * x] + v[4 * g + 2 * x + 1];
#pragma unroll
  for (int w = CK / 16; w >= 1; w /= 2)
#pragma unroll
    for (int g = 0; g < w; ++g) r[g] = MAX ? fmaxf(r[g], r[g + w]) : r[g] + r[g + w];
  return r[0];
}

// One chunk's online-softmax step for the consumer thread's two rows (x =
// (i / 2) % 2 of its accumulator elements), in place: scores become P.
// Scores go to log2 units first (t = s c, c = sm_scale log2(e)), where m is
// kept, so p = 2^(t - m): one FMUL, one FADD and one ex2 an element. EDGE:
// columns j < lim hold (lim = ctx_len - the chunk's first position). corr:
// the factor that O's row takes.
template <Form FORM>
__device__ __forceinline__ void softmax_step(float (&sc)[CK / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int lim, int t, float c) {
#pragma unroll
  for (int i = 0; i < CK / 2; ++i) {
    const bool ok = FORM == INTERIOR || sm90::acc_col(t, i) < lim;
    sc[i] = ok ? sc[i] * c : NEG;
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    float mx = row_reduce<true>(sc, x);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m[x], mx);
    corr[x] = ex2(m[x] - mn);
    m[x] = mn;
  }
#pragma unroll
  for (int i = 0; i < CK / 2; ++i) {
    sc[i] = ex2(sc[i] - m[(i >> 1) & 1]);   // a masked column: exactly 0
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    float rs = row_reduce<false>(sc, x);
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l[x] = l[x] * corr[x] + rs;
  }
}

// Merge the cluster's (m, l, O) over this CTA's share of its live rows, in
// rank order (m in log2 units), and store them as bf16. The consumer threads call it,
// between two cluster barriers.
template <int DH>
__device__ __forceinline__ void cluster_merge(const Args& a, const Cta& T, const float* ob,
                                              const float2* ml, bf16* __restrict__ out,
                                              uint32_t rank, int splits) {
  constexpr int V4 = DH / 4, LD = Smem<DH>::LD;
  const int R = T.r1 - T.r0;
  const int lo = (int)rank * R / splits, hi = ((int)rank + 1) * R / splits;
  const uint32_t obase = sm90::smem_u32(ob), mbase = sm90::smem_u32(ml);
  for (int e = threadIdx.x; e < (hi - lo) * V4; e += NC * 128) {
    const int row = lo + e / V4, c4 = e % V4;
    const uint32_t oa = obase + (row * LD + 4 * c4) * 4, ma = mbase + row * 8;
    float M = NEG;
    for (int q = 0; q < splits; ++q) M = fmaxf(M, sm90::ld_cluster2(sm90::map_rank(ma, q)).x);
    float L = 0.f;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < splits; ++q) {
      const float2 lq = sm90::ld_cluster2(sm90::map_rank(ma, q));
      const float4 v = sm90::ld_cluster4(sm90::map_rank(oa, q));
      const float eq = ex2(lq.x - M);
      L += lq.y * eq;
      s.x += v.x * eq;
      s.y += v.y * eq;
      s.z += v.z * eq;
      s.w += v.w * eq;
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);   // L = 0: no key at all, out = 0
    const int r = T.r0 + row;
    const int h = T.kvh * a.G + r % a.G;
    const __nv_bfloat162 lo2 = __floats2bfloat162_rn(s.x * inv, s.y * inv);
    const __nv_bfloat162 hi2 = __floats2bfloat162_rn(s.z * inv, s.w * inv);
    uint2 pk;
    pk.x = *reinterpret_cast<const uint32_t*>(&lo2);
    pk.y = *reinterpret_cast<const uint32_t*>(&hi2);
    *reinterpret_cast<uint2*>(out + (((size_t)T.b * a.W + r / a.G) * a.H + h) * DH + 4 * c4) =
        pk;
  }
}

// One CTA: NC consumer warpgroups of 64 query rows and the producer's
// warpgroup.
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
beam_wgmma_kernel(const __grid_constant__ Maps m, const bf16* __restrict__ q,
                  const bf16* __restrict__ k_beam, const bf16* __restrict__ v_beam,
                  bf16* __restrict__ out, Args a) {
  using S = Smem<DH>;
  using QT = typename S::QT;
  using KT = typename S::KT;
  using O = sm90::Out<DH>;
  extern __shared__ unsigned char smem_raw[];
  constexpr int STAGES = S::STAGES;
  auto* ring = reinterpret_cast<sm90::Ring<STAGES>*>(smem_raw);
  int* row_b = reinterpret_cast<int*>(smem_raw + sizeof(sm90::Ring<STAGES>));
  unsigned char* tiles = sm90::align1024(smem_raw + S::HEAD);

  const int hkv = a.H / a.G;
  find_batch_row(a, gridDim.z / hkv, blockIdx.z / hkv, row_b);
  if (threadIdx.x == 0) {
    ring->init(NC * 128);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  const uint32_t rank = sm90::cluster_rank();
  const int splits = gridDim.x;
  const Cta T(a, *row_b, rank, splits);
  const int nc = T.c_end - T.c_begin;

  const int wg = threadIdx.x / 128;
  if (wg == NC) {   // the producer's warpgroup
    sm90::setmaxnreg_dec<Regs<DH>::PRODUCER>();
    produce<DH>(m, a, T, k_beam, v_beam, tiles, ring, threadIdx.x - NC * 128);
    sm90::cluster_sync();   // every CTA's (m, l, O) is in its shared memory
    sm90::cluster_sync();   // and stays there until the cluster has read it
    return;
  }
  // consumers
  sm90::setmaxnreg_inc<Regs<DH>::CONSUMER>();
  const int t = threadIdx.x % 128;
  const int rq = T.r0 + wg * QR;                // the consumer's first row
  const bool live = rq < T.r1;
  unsigned char* q_s = tiles + wg * QT::BYTES;
  {   // Q's rows, once: row r is beam r / G of query head kv_head G + r % G
    constexpr int VPR = DH / 8;
    for (int v = t; v < QR * VPR; v += 128) {
      const int j = v / VPR, c8 = (v % VPR) * 8, r = rq + j;
      const bool ok = r < T.r1;
      const size_t off = ok ? (size_t)T.b * a.q_sb + (size_t)(r / a.G) * a.q_sw +
                                  (size_t)(T.kvh * a.G + r % a.G) * DH + c8
                            : 0;
      sm90::cp_async16(q_s + sm90::tile_off<DH>(j, c8), q + off, ok);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<0>();
    sm90::fence_async_smem();
    sm90::named_sync<128>(Q_READY + wg);
  }
  const float c = a.sm_scale * 1.4426950408889634f;   // scores to log2 units
  float mrow[2] = {NEG, NEG}, lrow[2] = {0.f, 0.f}, corr[2];
  float o[O::NCH][O::CH / 2];
#pragma unroll
  for (int j = 0; j < O::NCH; ++j)
#pragma unroll
    for (int i = 0; i < O::CH / 2; ++i) o[j][i] = 0.f;
  float sc[CK / 2];
  uint32_t pa[CK / 4];   // P, as A fragments
  const auto stage = [&](int u) { return tiles + S::KV + (u % STAGES) * S::STAGE; };
  const auto skip = [&](int u) {
    ring->consumer_wait(u);
    ring->consumer_release(u);
  };
  // One chunk: S_u, the softmax step of its form (O's rows rescaled), O +=
  // P_u V_u. The wgmma chains sit in straight code: issued under a branch,
  // ptxas serialises them.
  const auto chunk = [&](int u, Form form, int lim) {
    ring->consumer_wait(u);
    const unsigned char* kt = stage(u);
    sm90::wgmma_fence();
    sm90::score_chain<DH, CK>(sc, q_s, kt);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    if (form == EDGE)
      softmax_step<EDGE>(sc, mrow, lrow, corr, lim, t, c);
    else
      softmax_step<INTERIOR>(sc, mrow, lrow, corr, lim, t, c);
#pragma unroll
    for (int j = 0; j < O::NCH; ++j)
#pragma unroll
      for (int i = 0; i < O::CH / 2; ++i) o[j][i] *= corr[(i >> 1) & 1];
    sm90::acc_to_a(pa, sc);
    sm90::fence_out<DH>(o);
    sm90::wgmma_fence();
    sm90::pv_chain<DH, CK>(o, pa, kt + KT::BYTES);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_out<DH>(o);
    ring->consumer_release(u);
  };
  // A tail chunk: key j is the gathered row of the consumer's row h CK + j.
  // Each thread folds the keys of its two rows (where they lie in the
  // chunk: a warp's rows all do or all do not) into O as rank-1 updates
  // from shared memory, over the columns its accumulator holds: the dot
  // product summed over the quad, then O = O corr + bf16(p) v.
  const auto tail = [&](int u, int h) {
    ring->consumer_wait(u);
    const uint32_t qa = sm90::smem_u32(q_s), ka = sm90::smem_u32(stage(u));
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = sm90::acc_row(t, 2 * x), j = r - h * CK;
      const bool in = j >= 0 && j < CK;
      const int jr = in ? j : 0;
      float dot = 0.f;
#pragma unroll
      for (int jo = 0; jo < O::NCH; ++jo)
#pragma unroll
        for (int k = 0; k < O::CH / 8; ++k) {
          const int col = jo * O::CH + 8 * k + 2 * (t & 3), at = (col & 7) * 2;
          const float2 qv = bf2(qa + sm90::tile_off<DH>(r, col & ~7) + at);
          const float2 kv = bf2(ka + sm90::tile_off<DH, CK>(jr, col & ~7) + at);
          dot = fmaf(qv.x, kv.x, fmaf(qv.y, kv.y, dot));
        }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      if (!in) continue;
      const float sn = dot * c, mn = fmaxf(mrow[x], sn);
      const float cr = ex2(mrow[x] - mn), p = ex2(sn - mn);
      const float pb = __bfloat162float(__float2bfloat16(p));   // P V's bf16 P
      mrow[x] = mn;
      lrow[x] = lrow[x] * cr + p;
#pragma unroll
      for (int jo = 0; jo < O::NCH; ++jo)
#pragma unroll
        for (int k = 0; k < O::CH / 8; ++k) {
          const int col = jo * O::CH + 8 * k + 2 * (t & 3);
          const float2 vv =
              bf2(ka + KT::BYTES + sm90::tile_off<DH, CK>(jr, col & ~7) + (col & 7) * 2);
          o[jo][4 * k + 2 * x] = fmaf(pb, vv.x, o[jo][4 * k + 2 * x] * cr);
          o[jo][4 * k + 2 * x + 1] = fmaf(pb, vv.y, o[jo][4 * k + 2 * x + 1] * cr);
        }
    }
    ring->consumer_release(u);
  };
  const int mine = live ? nc : 0;
  for (int u = 0; u < mine; ++u) {
    const int c0 = (T.c_begin + u) * CK;
    chunk(u, c0 + CK <= T.ctx_len ? INTERIOR : EDGE, T.ctx_len - c0);
  }
  for (int u = mine; u < nc; ++u) skip(u);
  // the tail (last rank): per step, the chunks of the consumers before this
  // one, this one's TPC, the ones after
  const int steps = T.tail ? a.N : 0, own = live ? TPC : 0;
  for (int n = 0; n < steps; ++n) {
    const int base = nc + n * NC * TPC;
    for (int k = 0; k < wg * TPC; ++k) skip(base + k);
    for (int h = 0; h < own; ++h) tail(base + wg * TPC + h, h);
    for (int h = own; h < TPC; ++h) skip(base + wg * TPC + h);
    for (int k = (wg + 1) * TPC; k < NC * TPC; ++k) skip(base + k);
  }

  // every consumer is done with Q and the stages: (m, l) and O go where
  // they were
  sm90::named_sync<NC * 128>(CONSUMERS_DONE);
  float* ob = reinterpret_cast<float*>(tiles);
  float2* ml = reinterpret_cast<float2*>(tiles + S::ML);
#pragma unroll
  for (int j = 0; j < O::NCH; ++j)
#pragma unroll
    for (int i = 0; i < O::CH / 2; i += 2)
      *reinterpret_cast<float2*>(ob + (wg * QR + sm90::acc_row(t, i)) * S::LD + j * O::CH +
                                 sm90::acc_col(t, i)) = make_float2(o[j][i], o[j][i + 1]);
  if (t % 4 == 0) {
    ml[wg * QR + sm90::acc_row(t, 0)] = make_float2(mrow[0], lrow[0]);
    ml[wg * QR + sm90::acc_row(t, 2)] = make_float2(mrow[1], lrow[1]);
  }
  sm90::cluster_sync();
  cluster_merge<DH>(a, T, ob, ml, out, rank, splits);
  sm90::cluster_sync();
}

// ------------------------------------------------ layout check
// One consumer warpgroup runs the kernel's two product chains on one tile
// pair: a [64][DH] tile q copied in by cp.async into the panel layout (as
// the consumers copy Q), a [CK][DH] tile x loaded by TMA through a 3-D map
// (as the producer loads a context chunk, from batch 1 of two); s = q x^T
// ([64][CK], both K-major) read out through the accumulator layout, and o = p
// x ([64][DH]) with p put in that layout, repacked by `acc_to_a` as the
// softmax's P is and x read MN-major. chip_smoke.py holds both against
// torch.matmul.
template <int DH>
__global__ void __launch_bounds__(128)
tile_check_kernel(const __grid_constant__ CUtensorMap mx, const bf16* __restrict__ qg,
                  const bf16* __restrict__ pg, float* __restrict__ s_out,
                  float* __restrict__ o_out) {
  using QT = Tile<DH>;
  using KT = Tile<DH, CK>;
  using O = sm90::Out<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = sm90::align1024(smem_raw);
  unsigned char* sX = sQ + QT::BYTES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sX + KT::BYTES);
  const int t = threadIdx.x;
  if (t == 0) {
    sm90::mbar_init(bar, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (t == 0) {
    sm90::mbar_expect_tx(bar, KT::BYTES);
    for (int i = 0; i < KT::NP; ++i)
      sm90::tma_load_3d(sX + i * KT::PANEL, &mx, i * KT::PW, 0, 1, bar);
  }
  for (int v = t; v < QR * DH / 8; v += 128) {
    const int j = v / (DH / 8), c8 = (v % (DH / 8)) * 8;
    sm90::cp_async16(sQ + sm90::tile_off<DH>(j, c8), qg + j * DH + c8, true);
  }
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  sm90::fence_async_smem();
  __syncthreads();
  float pf[CK / 2], sacc[CK / 2], o[O::NCH][O::CH / 2];
#pragma unroll
  for (int i = 0; i < CK / 2; ++i)
    pf[i] = __bfloat162float(pg[sm90::acc_row(t, i) * CK + sm90::acc_col(t, i)]);
  uint32_t pa[CK / 4];
  sm90::acc_to_a(pa, pf);
#pragma unroll
  for (int j = 0; j < O::NCH; ++j)
#pragma unroll
    for (int i = 0; i < O::CH / 2; ++i) o[j][i] = 0.f;
  sm90::mbar_wait(bar, 0);
  sm90::fence_out<DH>(o);
  sm90::wgmma_fence();
  sm90::score_chain<DH, CK>(sacc, sQ, sX);
  sm90::pv_chain<DH, CK>(o, pa, sX);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sacc);
  sm90::fence_out<DH>(o);
#pragma unroll
  for (int i = 0; i < CK / 2; ++i)
    s_out[sm90::acc_row(t, i) * CK + sm90::acc_col(t, i)] = sacc[i];
#pragma unroll
  for (int j = 0; j < O::NCH; ++j)
#pragma unroll
    for (int i = 0; i < O::CH / 2; ++i)
      o_out[sm90::acc_row(t, i) * DH + j * O::CH + sm90::acc_col(t, i)] = o[j][i];
}

}  // namespace wg

// ------------------------------------------------ fp32: scalar FMA
namespace scalar {

constexpr int BM = 32;    // query beams per CTA, 8 threads each
constexpr int BN = 32;    // context keys per chunk
constexpr int NT = 256;

template <int DH>
struct Smem {
  static constexpr int KS = DH + 4;   // fp32 row stride (+16 B)
  static constexpr int PS = BN + 1;
  static constexpr size_t bytes = sizeof(float) * (BM * KS + 2 * BN * KS + BM * PS);
};

__device__ __forceinline__ float group_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

// Thread (r = tid / 8, c = tid % 8) owns row r; of a chunk's scores the
// columns c + 8 jj, and of the head dim the columns c + 8 j.
template <int DH>
__global__ void __launch_bounds__(NT)
kernel(const float* __restrict__ q, const float* __restrict__ k_ctx,
       const float* __restrict__ v_ctx, const float* __restrict__ k_beam,
       const float* __restrict__ v_beam, float* __restrict__ out, Args a) {
  constexpr int KS = Smem<DH>::KS, PS = Smem<DH>::PS;
  constexpr int VPR = DH / 4;     // 16-byte vectors per row
  constexpr int CPT = DH / 8;     // head-dim columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);   // [BM][KS]
  float* sK = sQ + BM * KS;                          // [BN][KS]
  float* sV = sK + BN * KS;                          // [BN][KS]
  float* sP = sV + BN * KS;                          // [BM][PS]

  const int b = blockIdx.z, h = blockIdx.y, w0 = blockIdx.x * BM;
  const int kvh = h / a.G;
  const int tid = threadIdx.x, r = tid / 8, c = tid % 8;
  const int row = w0 + r;
  const int ctx_len = max(0, min(a.ctx_lens[b], a.S));
  const float* qb = q + (size_t)b * a.q_sb + (size_t)h * DH;
  const float* kb = k_ctx + (size_t)b * a.c_sb + (size_t)kvh * DH;
  const float* vb = v_ctx + (size_t)b * a.c_sb + (size_t)kvh * DH;

  for (int e = tid; e < BM * DH; e += NT) {
    const int qr = e / DH, d = e % DH;
    sQ[qr * KS + d] = w0 + qr < a.W ? qb[(size_t)(w0 + qr) * a.q_sw + d] : 0.f;
  }
  float acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc[j] = 0.f;
  float m = NEG, l = 0.f;

  for (int c0 = 0; c0 < ctx_len; c0 += BN) {
    __syncthreads();   // the previous chunk is consumed; Q is visible
    for (int e = tid; e < BN * VPR; e += NT) {
      const int kc = e / VPR, vv = e % VPR;
      const int pos = c0 + kc;
      float4 kz = make_float4(0.f, 0.f, 0.f, 0.f), vz = kz;
      if (pos < ctx_len) {
        kz = reinterpret_cast<const float4*>(kb + (size_t)pos * a.c_ss)[vv];
        vz = reinterpret_cast<const float4*>(vb + (size_t)pos * a.c_ss)[vv];
      }
      reinterpret_cast<float4*>(sK + kc * KS)[vv] = kz;
      reinterpret_cast<float4*>(sV + kc * KS)[vv] = vz;
    }
    __syncthreads();

    float s[BN / 8];
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) s[jj] = 0.f;
    for (int d = 0; d < DH; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(sQ + r * KS + d);
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
        const float4 kv = *reinterpret_cast<const float4*>(sK + (c + 8 * jj) * KS + d);
        s[jj] = fmaf(qv.x, kv.x, fmaf(qv.y, kv.y, fmaf(qv.z, kv.z, fmaf(qv.w, kv.w, s[jj]))));
      }
    }
    float mx = NEG;
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      s[jj] = c0 + c + 8 * jj < ctx_len ? s[jj] * a.sm_scale : NEG;
      mx = fmaxf(mx, s[jj]);
    }
    const float mn = fmaxf(m, group_max(mx));
    const float corr = expf(m - mn);
    float rs = 0.f;
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const float p = expf(s[jj] - mn);
      sP[r * PS + c + 8 * jj] = p;
      rs += p;
    }
    l = l * corr + group_sum(rs);
    m = mn;
    __syncwarp();      // a row's P is written and read by the same 8 lanes
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[j] *= corr;
    for (int n = 0; n < BN; ++n) {
      const float p = sP[r * PS + n];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[j] = fmaf(p, sV[n * KS + c + 8 * j], acc[j]);
    }
  }
  __syncthreads();     // Q is visible even when there was no chunk

  for (int n = 0; n < a.N; ++n) {
    const int slot = row < a.W ? a.anc[((size_t)b * a.N + n) * a.W + row] : 0;
    const size_t off = (size_t)b * a.b_sb + (size_t)n * a.b_sn + (size_t)slot * a.b_sw +
                       (size_t)kvh * DH;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      dot = fmaf(sQ[r * KS + c + 8 * j], k_beam[off + c + 8 * j], dot);
    const float sn = group_sum(dot) * a.sm_scale;
    const float mn = fmaxf(m, sn);
    const float cn = expf(m - mn), p = expf(sn - mn);
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[j] = fmaf(p, v_beam[off + c + 8 * j], acc[j] * cn);
    l = l * cn + p;
    m = mn;
  }

  if (row < a.W) {
    const float inv = 1.f / fmaxf(l, 1e-30f);   // l = 0: no key at all, out = 0
    float* orow = out + (((size_t)b * a.W + row) * a.H + h) * DH;
#pragma unroll
    for (int j = 0; j < CPT; ++j) orow[c + 8 * j] = acc[j] * inv;
  }
}

}  // namespace scalar

template <int DH>
int launch_wg(const void* q, const void* kc, const void* vc, const void* kb, const void* vb,
              void* out, const Args& a, int B, int splits, cudaStream_t st) {
  wg::Maps m{};
  const int hkv = a.H / a.G;
  if (a.S > 0) {   // S 0: no context chunk, no map read
    // a context broadcast over the batch (batch stride 0) is one batch of
    // the map, read at batch 0 (Cta::ctx_b)
    const uint64_t cols = (uint64_t)hkv * DH, nb = a.c_sb ? B : 1;
    const uint64_t ld_b = nb > 1 ? (uint64_t)a.c_sb : (uint64_t)a.S * a.c_ss;
    const uint32_t pw = Tile<DH>::PW;
    int err = sm90::make_tile_map(&m.k, kc, a.S, cols, a.c_ss, wg::CK, pw, nb, ld_b);
    if (!err) err = sm90::make_tile_map(&m.v, vc, a.S, cols, a.c_ss, wg::CK, pw, nb, ld_b);
    if (err) return err;
  }
  const dim3 grid(splits, a.tiles, B * hkv);
  return sm90::launch_cluster(wg::beam_wgmma_kernel<DH>, wg::Smem<DH>::bytes, grid, wg::THREADS,
                              splits, st, m, static_cast<const bf16*>(q),
                              static_cast<const bf16*>(kb), static_cast<const bf16*>(vb),
                              static_cast<bf16*>(out), a);
}

template <int DH>
int launch_scalar(const void* q, const void* kc, const void* vc, const void* kb, const void* vb,
                  void* out, const Args& a, int B, cudaStream_t st) {
  using F = const float*;
  const dim3 grid((a.W + scalar::BM - 1) / scalar::BM, a.H, B);
  return sm90::launch(scalar::kernel<DH>, scalar::Smem<DH>::bytes, grid, scalar::NT, st,
                      static_cast<F>(q), static_cast<F>(kc), static_cast<F>(vc),
                      static_cast<F>(kb), static_cast<F>(vb), static_cast<float*>(out), a);
}

// Clusters of `splits` CTAs of the bf16 instance at head dim DH that the card
// holds at once.
template <int DH>
int cluster_capacity(int splits) {
  return sm90::cluster_capacity(wg::beam_wgmma_kernel<DH>, wg::Smem<DH>::bytes, wg::THREADS,
                                splits);
}

#define BEAM_DISPATCH_DH(dh, CALL)                      \
  switch (dh) {                                         \
    case 32: { constexpr int DH = 32; return CALL; }    \
    case 64: { constexpr int DH = 64; return CALL; }    \
    case 128: { constexpr int DH = 128; return CALL; }  \
    case 256: { constexpr int DH = 256; return CALL; }  \
    default: return -1;                                 \
  }

}  // namespace

// dtype: 0 = bf16 (the wgmma kernel), 1 = fp32 (the scalar kernel); q, the
// context, the beam K/V and out share it. q [B, W, H, D] with strides q_sb /
// q_sw (elements) and dense [H, D]; the context [B, S, Hkv, D] with strides
// c_sb / c_ss and dense [Hkv, D]; the beam K/V [B, N, W, Hkv, D] with strides
// b_sb / b_sn / b_sw (null when N == 0); ancestry [B, N, W] and ctx_lens [B]
// dense int32; out dense [B, W, H, D]. splits (bf16): the CTAs of a cluster
// that share a (batch row, kv head, row tile)'s keys, 1 to 16, from
// `beam_split_plan`. Returns the CUDA error code of the launch (0 on
// success), -1 for an unsupported dtype, head dim, head grouping or split,
// -2 / -3 when a tensor map cannot be made.
extern "C" int beam_decode_attn_launch(
    int dtype, const void* q, const void* k_ctx, const void* v_ctx, const int* ctx_lens,
    const void* k_beam, const void* v_beam, const int* ancestry, void* out, int B, int W,
    int H, int Hkv, int D, int S, int N, long long q_sb, long long q_sw, long long c_sb,
    long long c_ss, long long b_sb, long long b_sn, long long b_sw, float sm_scale, int splits,
    void* stream) {
  if (Hkv <= 0 || H % Hkv) return -1;
  if (B == 0 || W == 0 || H == 0) return 0;
  const int G = H / Hkv;
  // beam_row_tiles
  const Args a{ctx_lens, ancestry, W, H, G, S, N, (G * W + wg::CTA_ROWS - 1) / wg::CTA_ROWS,
               q_sb, q_sw, c_sb, c_ss, b_sb, b_sn, b_sw, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (splits < 1 || splits > 16) return -1;
    BEAM_DISPATCH_DH(D, launch_wg<DH>(q, k_ctx, v_ctx, k_beam, v_beam, out, a, B, splits, st))
  }
  if (dtype == 1)
    BEAM_DISPATCH_DH(D, launch_scalar<DH>(q, k_ctx, v_ctx, k_beam, v_beam, out, a, B, st))
  return -1;
}

// The layout check: bf16 q [64][dh], x [2][CK][dh] (the map reads x[1]) and
// p [64][CK] (row-major); fp32 s_out [64][CK] = q x[1]^T and o_out [64][dh] =
// p x[1]. Same return codes.
extern "C" int beam_tile_check_launch(const void* q, const void* x, const void* pg, void* s_out,
                                      void* o_out, int dh, void* stream) {
  CUtensorMap m;
  const uint32_t pw = dh < 64 ? dh : 64;
  if (const int err = sm90::make_tile_map(&m, x, wg::CK, dh, dh, wg::CK, pw, 2,
                                          (uint64_t)wg::CK * dh))
    return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16 *Q = static_cast<const bf16*>(q), *P = static_cast<const bf16*>(pg);
  float *S = static_cast<float*>(s_out), *O = static_cast<float*>(o_out);
  BEAM_DISPATCH_DH(dh, sm90::launch(wg::tile_check_kernel<DH>,
                                    1024 + Tile<DH>::BYTES + Tile<DH, wg::CK>::BYTES + 8, dim3(1),
                                    128, st, m, Q, P, S, O))
}

// How many clusters of `splits` CTAs (1 to 16) of the bf16 kernel at head dim
// dh the card holds at once; negative on an error (-1 for an unsupported
// head dim or split).
extern "C" int beam_cluster_capacity(int dh, int splits) {
  if (splits < 1 || splits > 16) return -1;
  BEAM_DISPATCH_DH(dh, cluster_capacity<DH>(splits))
}

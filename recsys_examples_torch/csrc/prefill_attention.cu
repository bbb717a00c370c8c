// Causal GQA prefill attention for Hopper (sm_90a): Q1, on wgmma with
// TMA-fed tiles and P kept in registers, and its fp32 scalar kernel.
//
// Replaces no TPU kernel: the JAX package computes the prefill's attention
// outside any kernel (recsys_examples_tpu/models/qwen3.py:154-162, bf16
// operands with fp32 sums), and the port's plain version
// (`prefill_attn_ref` in ops/prefill_attention.py) built an fp32 [B, H, N, N]
// score tensor a layer. Per batch row b, query position i < N and head h:
//   out[b, i, h] = softmax_{j <= i, j < len[b]}(q[b, i, h] . k[b, j, h / G]
//                  * sm_scale) . v[b, j, h / G]
// with G = H / Hkv query heads sharing a kv head and len[b] clamped to
// [0, N]. Rows i >= len[b] come out as zero: they feed only padded
// positions, which nothing reads (the decode stops at the context length,
// the last logits take row len - 1, and every layer is causal).
//
// What bounds it on an H100 (989 TFLOP/s dense bf16, 3.35 TB/s): operations.
// Every valid (query, key) pair costs two products (S, P V) of 2 D FLOPs: at
// the qwen3_sid_ctx1k cell's prefill (B 8, contexts 512-1016 in a bucket of
// 1024, 16 / 8 heads of 128) about 20 GFLOP a layer, 0.02 ms, against
// 0.006 ms for the 21 MB of q, k, v and out.
//
// Design (bf16). One CTA per (128 query rows, head, batch row), the row
// tile the fastest grid dimension, in reverse: the CTAs of one (batch row,
// head) run together, the last query rows (which walk furthest) first, and
// the heads that share a kv head are neighbours, so the CTAs in flight read
// the K and V of a few (batch row, kv head) pairs, from L2 after the first
// read. (With the row tile slowest, which evens out the causal imbalance
// across the whole grid instead, it timed the same: PERF.md.) A CTA whose
// rows all lie at or past len[b] writes its zeros and exits. Three
// warpgroups, as K1 (hstu_attention_fwd.cu):
//   - a producer warp (its warpgroup trimmed to 24 registers) loads the
//     CTA's Q once, as two 64-row tiles, and streams 128-key K and V tiles
//     through two rings of two stages each (full/empty mbarriers), over 3-D
//     TMA maps [B][N][heads D] (q's and k/v's own strides: no transpose, no
//     repeat of the kv heads; positions past N read as zero, so N need not
//     be a multiple of 128);
//   - two consumer warpgroups (240 registers: O's D / 2 sums, the score's 64
//     and P's 32 a thread). Consumer w owns the query rows m0 + 64 w .. + 63
//     and walks the key tiles up to min(its last row + 1, len[b]). Per key
//     tile: S = Q_w K^T (one m64n128k16 chain over D, both operands
//     K-major), the online softmax in registers in log2 units (p = 2^(s c -
//     m), c = sm_scale log2(e), one FFMA and one ex2 an element; fp32 row
//     max m and sum l, a row's reduction over the thread's values and the 4
//     threads of a quad), O's rows rescaled, P rounded to bf16 and repacked
//     into A fragments (`acc_to_a`) for O_w += P V (V read MN-major). l sums
//     the unrounded P; the fp32 O is divided by l and rounded to bf16 once,
//     written into the consumer's Q tile and stored by one TMA copy
//     (4-byte stores from the accumulator layout took 2.6x the clocks).
// Overlap (FlashAttention-3's two kinds): within a consumer, S_i is issued
// together with P_{i-1} V_{i-1}, and S_i's softmax runs while that product
// does; across the two consumers, they take turns at issuing (K1's
// ping-pong), so one's softmax runs beside the other's products. K1's form
// (the softmax between S_i and P_i V_i, with those stores and a separate
// scale multiply) was 1.26x slower at the ctx1k shape.
// Only a tile that reaches past the consumer's first row or past len[b] is
// masked element by element (j <= i and j < len[b]); masked scores take
// -1e30, never -inf, and add exactly 0 to l and O. Key 0 is valid for
// every row, so every row's max is finite after the first tile. Shared
// memory at D 128: Q 32 KB, 2 x (K + V) 128 KB (a third stage timed the
// same). Head dims 64 and 128 are built; the wrapper pads others to the
// next. Measured at the ctx1k shape: 0.081 ms, 31.7% of the FLOP bound,
// as fast as PyTorch's causal scaled_dot_product_attention (PERF.md).
//
// fp32 (off the serving path, which runs bf16): `scalar::kernel`, 256
// threads of scalar FMA, 32 rows per CTA, 8 threads a row, chunks of 32
// keys, expf, no rounding of P.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90_wgmma.cuh"

namespace {

using sm90::bf16;
using sm90::Tile;

constexpr float NEG = -1e30f;

struct Args {
  const long long* lengths;   // [B] valid positions of each batch row
  int N, H, G;
  long long q_sb, q_sn;       // q: elements between batch rows / positions
  long long k_sb, k_sn;       // k and v: the same
  float sm_scale;
};

__device__ __forceinline__ int valid_len(const Args& a, int b) {
  const long long n = a.lengths[b];
  return n < 0 ? 0 : n > a.N ? a.N : (int)n;
}

// Row r of head h of batch row b in the dense out [B, N, H, DH].
template <int DH, typename T>
__device__ __forceinline__ T* out_row(T* out, const Args& a, int b, int h, int r) {
  return out + ((size_t)b * a.N + r) * a.H * DH + (size_t)h * DH;
}

// Zero rows [r0, r1) of head h of batch row b in out (DH a multiple of 8).
template <int DH, typename T>
__device__ __forceinline__ void zero_rows(T* out, const Args& a, int b, int h, int r0, int r1,
                                          int tid, int nthreads) {
  constexpr int VPR = DH * (int)sizeof(T) / 16;   // 16-byte pieces a row
  for (int e = tid; e < (r1 - r0) * VPR; e += nthreads)
    reinterpret_cast<uint4*>(out_row<DH>(out, a, b, h, r0 + e / VPR))[e % VPR] =
        make_uint4(0u, 0u, 0u, 0u);
}

// ------------------------------------------------ bf16: wgmma
namespace wg {

constexpr int QR = sm90::TILE_ROWS;      // query rows per consumer (64)
constexpr int NC = 2;                    // consumer warpgroups
constexpr int CTA_ROWS = NC * QR;        // PREFILL_ROWS
constexpr int BK = 128;                  // keys per tile (PREFILL_KEYS)
constexpr int STAGES = 2;                // of the K ring and of the V ring
constexpr int THREADS = 128 * (NC + 1);
static_assert(BK == CTA_ROWS, "a CTA's consumers walk the same key tiles");
constexpr int TURN = 1;                  // named barrier TURN + w: consumer w's turn
constexpr int EPILOGUE = TURN + NC;      // named barrier EPILOGUE + w: consumer w's stores
// setmaxnreg's split of the 168 registers a thread holds at entry
constexpr int CONSUMER = 240, PRODUCER = 24;
static_assert(NC * 128 * CONSUMER + 128 * PRODUCER <= 168 * THREADS, "");

template <int DH>
struct Smem {
  using QT = Tile<DH>;          // [64][DH]
  using KT = Tile<DH, BK>;      // [128][DH]
  static constexpr int K = NC * QT::BYTES;
  static constexpr int V = K + STAGES * KT::BYTES;
  static constexpr int BARS = V + STAGES * KT::BYTES;
  static constexpr size_t bytes = 1024 + BARS + 2 * sizeof(sm90::Ring<STAGES>) + 8;
};

struct Maps {
  CUtensorMap q, k, v, o;   // q, out: [B][N][H D] in 64-row boxes; k, v: [B][N][Hkv D] in 128
};

// The panels of rows [row, row + ROWS) of batch b, columns [col, col + DH),
// of a 3-D map into a [ROWS][DH] tile.
template <int DH, int ROWS>
__device__ __forceinline__ void load_tile3(unsigned char* dst, const CUtensorMap* map, int col,
                                           int row, int b, uint64_t* bar) {
  using L = Tile<DH, ROWS>;
#pragma unroll
  for (int i = 0; i < L::NP; ++i)
    sm90::tma_load_3d(dst + i * L::PANEL, map, col + i * L::PW, row, b, bar);
}

enum Form { INTERIOR, EDGE };

// 2^x (the special-function unit's approximation, as __expf uses it)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// max or sum of the thread's BK / 8 pairs of row x of an accumulator
// (elements 4 g + 2 x and + 1), in four independent chains. Every index is
// a constant once unrolled: a tree written with a halving loop bound left
// its array in local memory (64 bytes of stack), and the kernel took 1.86x
// as long at the ctx1k shape (PERF.md).
template <bool MAX>
__device__ __forceinline__ float row_reduce(const float (&v)[BK / 2], int x) {
  const auto op = [](float a, float b) { return MAX ? fmaxf(a, b) : a + b; };
  float r[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) r[g] = op(v[4 * g + 2 * x], v[4 * g + 2 * x + 1]);
#pragma unroll
  for (int g = 4; g < BK / 8; ++g)
    r[g % 4] = op(r[g % 4], op(v[4 * g + 2 * x], v[4 * g + 2 * x + 1]));
  return op(op(r[0], r[1]), op(r[2], r[3]));
}

// One key tile's online-softmax step for the consumer thread's two rows (x =
// (i / 2) % 2 of its accumulator elements), in place: raw scores become P =
// 2^(s c - m), one FFMA and one ex2 an element (m in log2 units; the row's
// max is taken on the raw scores and scaled once, c being positive). EDGE:
// key k0 + column is valid for row q0 + row if it is <= the row and < len.
// corr: the factor that O's row takes.
template <Form FORM>
__device__ __forceinline__ void softmax_step(float (&sc)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int q0, int k0, int len, int t,
                                             float c) {
  if (FORM == EDGE) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int j = k0 + sm90::acc_col(t, i);
      if (!(j <= q0 + sm90::acc_row(t, i) && j < len)) sc[i] = NEG;
    }
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    float mx = row_reduce<true>(sc, x);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m[x], mx * c);
    corr[x] = ex2(m[x] - mn);
    m[x] = mn;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i)   // a masked score: 2^(-1.4e30), exactly 0
    sc[i] = ex2(fmaf(sc[i], c, -m[(i >> 1) & 1]));
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    float rs = row_reduce<false>(sc, x);
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l[x] = l[x] * corr[x] + rs;
  }
}

// The softmax step of the form of key tile i for the consumer's rows [q0,
// q0 + 64): interior when every key of the tile is <= q0 and < len.
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int q0, int i, int len, int t,
                                             float c) {
  const int k0 = i * BK;
  if (k0 + BK <= min(q0 + 1, len))
    softmax_step<INTERIOR>(sc, m, l, corr, q0, k0, len, t, c);
  else
    softmax_step<EDGE>(sc, m, l, corr, q0, k0, len, t, c);
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
prefill_wgmma_kernel(const __grid_constant__ Maps m, bf16* __restrict__ out, Args a) {
  using S = Smem<DH>;
  using QT = typename S::QT;
  using KT = typename S::KT;
  using O = sm90::Out<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = sm90::align1024(smem_raw);   // [NC] tiles: consumer w's rows
  unsigned char* sK = sQ + S::K;                   // [STAGES] tiles
  unsigned char* sV = sQ + S::V;                   // [STAGES] tiles
  auto* kring = reinterpret_cast<sm90::Ring<STAGES>*>(sQ + S::BARS);
  auto* vring = kring + 1;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kring + 2);

  const int h = blockIdx.y, b = blockIdx.z;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * CTA_ROWS;   // the last rows walk furthest
  const int len = valid_len(a, b);
  if (m0 >= len) {   // every row is padding
    zero_rows<DH>(out, a, b, h, m0, min(m0 + CTA_ROWS, a.N), threadIdx.x, THREADS);
    return;
  }
  const int n_tiles = (min(m0 + CTA_ROWS, len) + BK - 1) / BK;
  if (threadIdx.x == 0) {
    kring->init(NC * 128);
    vring->init(NC * 128);
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {   // producer
    sm90::setmaxnreg_dec<PRODUCER>();
    if (threadIdx.x == NC * 128) {
      const int nq = m0 + QR < len ? NC : 1;   // consumer 1's rows, if it has a valid one
      sm90::mbar_expect_tx(q_full, nq * QT::BYTES);
      for (int w = 0; w < nq; ++w)
        load_tile3<DH, QR>(sQ + w * QT::BYTES, &m.q, h * DH, m0 + w * QR, b, q_full);
      const int col = (h / a.G) * DH;
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES;
        kring->producer_acquire(i, KT::BYTES);
        load_tile3<DH, BK>(sK + st * KT::BYTES, &m.k, col, i * BK, b, &kring->full[st]);
        vring->producer_acquire(i, KT::BYTES);
        load_tile3<DH, BK>(sV + st * KT::BYTES, &m.v, col, i * BK, b, &vring->full[st]);
      }
    }
    return;
  }
  // consumers
  sm90::setmaxnreg_inc<CONSUMER>();
  const int t = threadIdx.x % 128;
  const int q0 = m0 + wg * QR;
  const int mine = q0 < len ? n_tiles : 0;   // BK == CTA_ROWS: a live consumer walks them all
  unsigned char* q_s = sQ + wg * QT::BYTES;
  const float c = a.sm_scale * 1.4426950408889634f;   // scores to log2 units
  float mrow[2] = {NEG, NEG}, lrow[2] = {0.f, 0.f}, corr[2];
  float o[O::NCH][O::CH / 2];
#pragma unroll
  for (int j = 0; j < O::NCH; ++j)
#pragma unroll
    for (int i = 0; i < O::CH / 2; ++i) o[j][i] = 0.f;
  float sc[BK / 2];
  uint32_t pa[BK / 4];   // P of the tile whose P V runs, as A fragments
  const auto k_s = [&](int i) { return sK + (i % STAGES) * KT::BYTES; };
  const auto v_s = [&](int i) { return sV + (i % STAGES) * KT::BYTES; };
  // n_tiles + 1 turns a consumer: S_0; then S_i with P_{i-1} V_{i-1}, for i
  // = 1 .. n_tiles - 1; then the last P V. Consumer 0 goes first, each hands
  // the turn on after issuing, and consumer 0 takes one more turn at the
  // end, for consumer 1's last hand-on. Within a turn S_i is issued before
  // P_{i-1} V_{i-1}, so S_i's softmax runs beside that product
  // (FlashAttention-3's overlap inside a warpgroup) and beside the other
  // consumer's products (its ping-pong across warpgroups).
  const auto turn = [&] { sm90::named_sync<NC * 128>(TURN + wg); };
  const auto pass = [&] { sm90::named_arrive<NC * 128>(TURN + 1 - wg); };
  if (wg == 1) sm90::named_arrive<NC * 128>(TURN);
  sm90::mbar_wait(q_full, 0);
  if (mine) {
    kring->consumer_wait(0);
    turn();
    sm90::wgmma_fence();
    sm90::score_chain<DH, BK>(sc, q_s, k_s(0));
    sm90::wgmma_commit();
    pass();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    kring->consumer_release(0);
    softmax_tile(sc, mrow, lrow, corr, q0, 0, len, t, c);
    sm90::acc_to_a(pa, sc);
    for (int i = 1; i < mine; ++i) {
      kring->consumer_wait(i);
      vring->consumer_wait(i - 1);
      turn();
      sm90::fence_out<DH>(o);
      sm90::wgmma_fence();
      sm90::score_chain<DH, BK>(sc, q_s, k_s(i));
      sm90::wgmma_commit();
      sm90::pv_chain<DH, BK>(o, pa, v_s(i - 1));
      sm90::wgmma_commit();
      pass();
      sm90::wgmma_wait<1>();   // S_i landed; P_{i-1} V_{i-1} may still run
      sm90::fence_regs(sc);
      kring->consumer_release(i);
      softmax_tile(sc, mrow, lrow, corr, q0, i, len, t, c);
      sm90::wgmma_wait<0>();
      sm90::fence_out<DH>(o);
      sm90::fence_regs(pa);
      vring->consumer_release(i - 1);
#pragma unroll
      for (int j = 0; j < O::NCH; ++j)
#pragma unroll
        for (int e = 0; e < O::CH / 2; ++e) o[j][e] *= corr[(e >> 1) & 1];
      sm90::acc_to_a(pa, sc);
    }
    vring->consumer_wait(mine - 1);
    turn();
    sm90::fence_out<DH>(o);
    sm90::wgmma_fence();
    sm90::pv_chain<DH, BK>(o, pa, v_s(mine - 1));
    sm90::wgmma_commit();
    pass();
    sm90::wgmma_wait<0>();
    sm90::fence_out<DH>(o);
    vring->consumer_release(mine - 1);
  } else {   // rows past len: the stages and turns only
    for (int i = 0; i <= n_tiles; ++i) {
      if (i < n_tiles) {
        kring->consumer_wait(i);
        kring->consumer_release(i);
      }
      if (i > 0) {
        vring->consumer_wait(i - 1);
        vring->consumer_release(i - 1);
      }
      turn();
      pass();
    }
  }
  if (wg == 0) turn();
  // O / l as bf16 (rows at or past len zero) into the consumer's Q tile,
  // then one TMA store of its 64 rows (rows past N are not written)
  const float inv[2] = {1.f / fmaxf(lrow[0], 1e-30f), 1.f / fmaxf(lrow[1], 1e-30f)};
  const uint32_t qa = sm90::smem_u32(q_s);
#pragma unroll
  for (int j = 0; j < O::NCH; ++j)
#pragma unroll
    for (int e = 0; e < O::CH / 2; e += 2) {
      const int r = sm90::acc_row(t, e), col = j * O::CH + sm90::acc_col(t, e);
      const float s = q0 + r < len ? inv[(e >> 1) & 1] : 0.f;
      const __nv_bfloat162 v = __floats2bfloat162_rn(o[j][e] * s, o[j][e + 1] * s);
      sm90::st_shared_b32(qa + sm90::tile_off<DH>(r, col & ~7) + (col & 7) * 2,
                          *reinterpret_cast<const uint32_t*>(&v));
    }
  sm90::fence_async_smem();
  sm90::named_sync<128>(EPILOGUE + wg);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < QT::NP; ++i)
      sm90::tma_store_3d(&m.o, q_s + i * QT::PANEL, h * DH + i * QT::PW, q0, b);
    sm90::bulk_commit();
    sm90::bulk_wait_read<0>();   // the tile is read before the CTA's shared memory goes
  }
}

// ------------------------------------------------ layout check
// One consumer warpgroup runs the kernel's two product chains on one tile
// pair loaded as the producer loads them: a [64][DH] tile q through a 3-D
// map in 64-row boxes, a [128][DH] tile x from batch 1 of a 3-D map in
// 128-row boxes; s = q x^T ([64][128], both K-major) read out through the
// accumulator layout, and o = p x ([64][DH]) with p put in that layout,
// repacked by `acc_to_a` as the softmax's P is and x read MN-major.
// chip_smoke.py holds both against torch.matmul.
template <int DH>
__global__ void __launch_bounds__(128)
tile_check_kernel(const __grid_constant__ Maps m, const bf16* __restrict__ pg,
                  float* __restrict__ s_out, float* __restrict__ o_out) {
  using QT = Tile<DH>;
  using KT = Tile<DH, BK>;
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
    sm90::mbar_expect_tx(bar, QT::BYTES + KT::BYTES);
    load_tile3<DH, QR>(sQ, &m.q, 0, 0, 0, bar);
    load_tile3<DH, BK>(sX, &m.k, 0, 0, 1, bar);
  }
  float pf[BK / 2], sacc[BK / 2], o[O::NCH][O::CH / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i)
    pf[i] = __bfloat162float(pg[sm90::acc_row(t, i) * BK + sm90::acc_col(t, i)]);
  uint32_t pa[BK / 4];
  sm90::acc_to_a(pa, pf);
#pragma unroll
  for (int j = 0; j < O::NCH; ++j)
#pragma unroll
    for (int i = 0; i < O::CH / 2; ++i) o[j][i] = 0.f;
  sm90::mbar_wait(bar, 0);
  sm90::fence_out<DH>(o);
  sm90::wgmma_fence();
  sm90::score_chain<DH, BK>(sacc, sQ, sX);
  sm90::pv_chain<DH, BK>(o, pa, sX);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sacc);
  sm90::fence_out<DH>(o);
#pragma unroll
  for (int i = 0; i < BK / 2; ++i)
    s_out[sm90::acc_row(t, i) * BK + sm90::acc_col(t, i)] = sacc[i];
#pragma unroll
  for (int j = 0; j < O::NCH; ++j)
#pragma unroll
    for (int i = 0; i < O::CH / 2; ++i)
      o_out[sm90::acc_row(t, i) * DH + j * O::CH + sm90::acc_col(t, i)] = o[j][i];
}

}  // namespace wg

// ------------------------------------------------ fp32: scalar FMA
namespace scalar {

constexpr int BM = 32;    // query rows per CTA, 8 threads each
constexpr int BN = 32;    // keys per chunk
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

// Thread (r = tid / 8, c = tid % 8) owns row w0 + r; of a chunk's scores the
// columns c + 8 jj, and of the head dim the columns c + 8 j.
template <int DH>
__global__ void __launch_bounds__(NT)
kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
       float* __restrict__ out, Args a) {
  constexpr int KS = Smem<DH>::KS, PS = Smem<DH>::PS;
  constexpr int VPR = DH / 4;     // 16-byte vectors per row
  constexpr int CPT = DH / 8;     // head-dim columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);   // [BM][KS]
  float* sK = sQ + BM * KS;                          // [BN][KS]
  float* sV = sK + BN * KS;                          // [BN][KS]
  float* sP = sV + BN * KS;                          // [BM][PS]

  const int h = blockIdx.y, b = blockIdx.z;
  const int w0 = (gridDim.x - 1 - blockIdx.x) * BM;   // the last rows walk furthest
  const int len = valid_len(a, b);
  if (w0 >= len) {
    zero_rows<DH>(out, a, b, h, w0, min(w0 + BM, a.N), threadIdx.x, NT);
    return;
  }
  const int tid = threadIdx.x, r = tid / 8, c = tid % 8;
  const int row = w0 + r;
  const int kend = min(w0 + BM, len);   // keys past it are masked for every row
  const float* qb = q + (size_t)b * a.q_sb + (size_t)h * DH;
  const float* kb = k + (size_t)b * a.k_sb + (size_t)(h / a.G) * DH;
  const float* vb = v + (size_t)b * a.k_sb + (size_t)(h / a.G) * DH;

  for (int e = tid; e < BM * VPR; e += NT) {
    const int qr = e / VPR, vv = e % VPR;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (w0 + qr < a.N)
      x = reinterpret_cast<const float4*>(qb + (size_t)(w0 + qr) * a.q_sn)[vv];
    reinterpret_cast<float4*>(sQ + qr * KS)[vv] = x;
  }
  float acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc[j] = 0.f;
  float m = NEG, l = 0.f;

  for (int c0 = 0; c0 < kend; c0 += BN) {
    __syncthreads();   // the previous chunk is consumed; Q is visible
    for (int e = tid; e < BN * VPR; e += NT) {
      const int kc = e / VPR, vv = e % VPR;
      const int pos = c0 + kc;
      float4 kz = make_float4(0.f, 0.f, 0.f, 0.f), vz = kz;
      if (pos < kend) {
        kz = reinterpret_cast<const float4*>(kb + (size_t)pos * a.k_sn)[vv];
        vz = reinterpret_cast<const float4*>(vb + (size_t)pos * a.k_sn)[vv];
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
      const int key = c0 + c + 8 * jj;
      s[jj] = key <= row && key < len ? s[jj] * a.sm_scale : NEG;
      mx = fmaxf(mx, s[jj]);
    }
    const float mn = fmaxf(m, group_max(mx));
    const float corr = expf(m - mn);
    float rs = 0.f;
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const float p = expf(s[jj] - mn);   // masked: exactly 0
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

  if (row < a.N) {
    const float inv = row < len ? 1.f / fmaxf(l, 1e-30f) : 0.f;
    float* orow = out_row<DH>(out, a, b, h, row);
#pragma unroll
    for (int j = 0; j < CPT; ++j) orow[c + 8 * j] = acc[j] * inv;
  }
}

}  // namespace scalar

// The 3-D map of a bf16 tensor [B][N][heads DH] with `sb` / `sn` elements
// between batch rows / positions, read in boxes of `rows` x one panel.
template <int DH>
int head_map(CUtensorMap* map, const void* base, int B, int N, int heads, long long sb,
             long long sn, int rows) {
  const uint64_t ld_b = B > 1 ? (uint64_t)sb : (uint64_t)N * sn;   // a map's stride is never 0
  return sm90::make_tile_map(map, base, N, (uint64_t)heads * DH, sn, rows, Tile<DH>::PW, B,
                             ld_b);
}

template <int DH>
int launch_wg(const void* q, const void* k, const void* v, void* out, const Args& a, int B,
              cudaStream_t st) {
  wg::Maps m;
  const int hkv = a.H / a.G;
  int err = head_map<DH>(&m.q, q, B, a.N, a.H, a.q_sb, a.q_sn, wg::QR);
  if (!err) err = head_map<DH>(&m.k, k, B, a.N, hkv, a.k_sb, a.k_sn, wg::BK);
  if (!err) err = head_map<DH>(&m.v, v, B, a.N, hkv, a.k_sb, a.k_sn, wg::BK);
  if (!err)
    err = head_map<DH>(&m.o, out, B, a.N, a.H, (long long)a.N * a.H * DH, (long long)a.H * DH,
                       wg::QR);
  if (err) return err;
  const dim3 grid((a.N + wg::CTA_ROWS - 1) / wg::CTA_ROWS, a.H, B);
  return sm90::launch(wg::prefill_wgmma_kernel<DH>, wg::Smem<DH>::bytes, grid, wg::THREADS, st,
                      m, static_cast<bf16*>(out), a);
}

template <int DH>
int launch_scalar(const void* q, const void* k, const void* v, void* out, const Args& a, int B,
                  cudaStream_t st) {
  using F = const float*;
  const dim3 grid((a.N + scalar::BM - 1) / scalar::BM, a.H, B);
  return sm90::launch(scalar::kernel<DH>, scalar::Smem<DH>::bytes, grid, scalar::NT, st,
                      static_cast<F>(q), static_cast<F>(k), static_cast<F>(v),
                      static_cast<float*>(out), a);
}

template <int DH>
int launch_tile_check(const void* q, const void* x, const void* pg, void* s_out, void* o_out,
                      cudaStream_t st) {
  wg::Maps m{};   // m.v and m.o are not read
  int err = head_map<DH>(&m.q, q, 1, wg::QR, 1, 0, DH, wg::QR);
  if (!err) err = head_map<DH>(&m.k, x, 2, wg::BK, 1, (long long)wg::BK * DH, DH, wg::BK);
  if (err) return err;
  return sm90::launch(wg::tile_check_kernel<DH>,
                      1024 + Tile<DH>::BYTES + Tile<DH, wg::BK>::BYTES + 8, dim3(1), 128, st, m,
                      static_cast<const bf16*>(pg), static_cast<float*>(s_out),
                      static_cast<float*>(o_out));
}

#define PREFILL_DISPATCH_DH(dh, CALL)                   \
  switch (dh) {                                         \
    case 64: { constexpr int DH = 64; return CALL; }    \
    case 128: { constexpr int DH = 128; return CALL; }  \
    default: return -1;                                 \
  }

}  // namespace

// dtype: 0 = bf16 (the wgmma kernel), 1 = fp32 (the scalar kernel); q, k, v
// and out share it. q [B, N, H, D] with strides q_sb / q_sn (elements) and
// dense [H, D]; k and v [B, N, Hkv, D] with strides k_sb / k_sn and dense
// [Hkv, D]; out dense [B, N, H, D]; lengths [B] int64. Returns the CUDA error
// code of the launch (0 on success), -1 for an unsupported dtype, head dim or
// head grouping, -2 / -3 when a tensor map cannot be made.
extern "C" int prefill_attn_launch(int dtype, const void* q, const void* k, const void* v,
                                   const long long* lengths, void* out, int B, int N, int H,
                                   int Hkv, int D, long long q_sb, long long q_sn,
                                   long long k_sb, long long k_sn, float sm_scale,
                                   void* stream) {
  if (Hkv <= 0 || H % Hkv) return -1;
  if (B == 0 || N == 0 || H == 0) return 0;
  const Args a{lengths, N, H, H / Hkv, q_sb, q_sn, k_sb, k_sn, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) PREFILL_DISPATCH_DH(D, launch_wg<DH>(q, k, v, out, a, B, st))
  if (dtype == 1) PREFILL_DISPATCH_DH(D, launch_scalar<DH>(q, k, v, out, a, B, st))
  return -1;
}

// The layout check: bf16 q [64][dh], x [2][128][dh] (the map reads x[1]) and
// p [64][128] (row-major); fp32 s_out [64][128] = q x[1]^T and o_out [64][dh]
// = p x[1]. Same return codes.
extern "C" int prefill_tile_check_launch(const void* q, const void* x, const void* pg,
                                         void* s_out, void* o_out, int dh, void* stream) {
  PREFILL_DISPATCH_DH(dh, launch_tile_check<DH>(q, x, pg, s_out, o_out,
                                                static_cast<cudaStream_t>(stream)))
}

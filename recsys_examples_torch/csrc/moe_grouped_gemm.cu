// Grouped expert GEMM of the sparse MoE layer (recsys_examples_torch/ops/
// moe.py) on Hopper (sm_90a): for each expert e, the routed rows
// offsets[e] .. offsets[e+1] of A [M][K] (sorted by expert) times w[e]^T,
// w [E][N][K] bf16 with fp32 sums, in one launch, under one of two
// epilogues:
//  - SWIGLU: w[e] stacks the gate rows [0, N/2) and the up rows [N/2, N);
//    out[r][c] = silu(gate) * up, out [M][N/2].
//  - SCATTER: out[dst_rows[r]][c] = row_scale[r] * (A[r] . w[e][c]), out
//    [rows][N]: the routing weight applied and the row put back in token
//    order, so the combine is a plain reduction.
//
// It replaces no TPU kernel: the JAX package has no expert layer. It serves
// LFM2-24B-A2B's 38 MoE layers (64 experts of width 1536, top 4).
//
// Bound. At the serving cell's decode step 2,048 rows x 4 land on 64
// experts, ~128 rows each, so every launch reads every expert's weights
// (805 MB for w13 and 403 MB for w2 a layer) and does ~40% of that time's
// FLOPs: device memory bounds it. The design streams each weight tile from
// device memory once:
//  - A CTA owns 128 routed rows of one expert and 256 weight rows (the gate
//    and up tiles of the same 128 output columns for SWIGLU, 256 output
//    columns otherwise), two [64 x 128] fp32 accumulators a consumer
//    warpgroup.
//  - A producer thread fills a 4-stage ring of TMA tiles: per stage the A
//    tile [128][64] and two weight tiles [128][64] (128-byte swizzle, 48 KB
//    a stage), on mbarriers. Rows of A past the expert's last row (the next
//    expert's, or past M and zero-filled) are computed and not stored.
//  - Two consumer warpgroups run m64n128k16 wgmma chains (both operands
//    K-major from shared memory), one commit group a stage, the stage
//    released once the next stage's chain is issued and the one before it
//    has completed.
//  - The grid is (ceil(M / 128) + E row tiles, weight tiles). Each CTA reads
//    the offsets into shared memory and finds its expert and first row (the
//    t-th row tile over the experts in order, ceil(count / 128) each); CTAs
//    past the last tile return at once. The plan needs no count on the host,
//    so the launch waits for nothing. Row tiles of one weight tile are
//    neighbours in x, so the second row tile of an expert finds the weight
//    tile in L2.
//  - setmaxnreg gives the consumers 232 registers (128 accumulators) and
//    the producer's warpgroup 40.
#include "sm90_wgmma.cuh"

namespace {
using sm90::bf16;
using sm90::Tile;

constexpr int BM = 128;                 // routed rows a CTA
constexpr int BN = 128;                 // weight rows of one accumulator
constexpr int BK = 64;                  // reduction columns a stage: one 128-byte panel
constexpr int NC = 2;                   // consumer warpgroups, 64 rows each
constexpr int STAGES = 4;
constexpr int THREADS = 128 * (NC + 1);
constexpr int MAX_E = 256;              // experts the plan holds in shared memory
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;
static_assert(NC * 128 * CONSUMER_REGS + 128 * PRODUCER_REGS <= 65536, "register split");

using TA = Tile<BK, BM>;                // [128][64] bf16, 16 KB
using TW = Tile<BK, BN>;
constexpr int STAGE = TA::BYTES + 2 * TW::BYTES;
// the ring, the offsets, the CTA's (expert, first row, rows)
constexpr int HEAD = sizeof(sm90::Ring<STAGES>) + (MAX_E + 4) * 4;
constexpr size_t SMEM_BYTES = HEAD + 1024 + STAGES * STAGE;

enum : int { SWIGLU = 1, SCATTER = 2 };

struct Args {
  const int* offsets;          // [E + 1]
  const float* row_scale;      // [M] (SCATTER)
  const long long* dst_rows;   // [M] (SCATTER)
  bf16* out;
  int M, N, K, E, mode, n_out;
};

struct Maps {
  CUtensorMap a;   // A [M][K]
  CUtensorMap w;   // w as [E N][K]
};

__device__ __forceinline__ float silu(float x) { return x / (1.f + __expf(-x)); }

__global__ void __launch_bounds__(THREADS, 1)
moe_grouped_gemm_kernel(const __grid_constant__ Maps m, Args a) {
  extern __shared__ unsigned char smem_raw[];
  auto* ring = reinterpret_cast<sm90::Ring<STAGES>*>(smem_raw);
  int* s_off = reinterpret_cast<int*>(smem_raw + sizeof(sm90::Ring<STAGES>));
  int* s_tile = s_off + MAX_E + 1;
  unsigned char* tiles = sm90::align1024(smem_raw + HEAD);

  for (int i = threadIdx.x; i <= a.E; i += blockDim.x) s_off[i] = a.offsets[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = blockIdx.x, e = -1, row0 = 0, rows = 0;
    for (int i = 0; i < a.E; ++i) {
      const int lo = s_off[i], cnt = s_off[i + 1] - lo, n = (cnt + BM - 1) / BM;
      if (t < n) {
        e = i;
        row0 = lo + t * BM;
        rows = min(BM, cnt - t * BM);
        break;
      }
      t -= n;
    }
    s_tile[0] = e;
    s_tile[1] = row0;
    s_tile[2] = rows;
    if (e >= 0) {
      ring->init(NC * 128);
      sm90::mbar_init_fence();
    }
  }
  __syncthreads();
  const int e = s_tile[0];
  if (e < 0) return;
  const int row0 = s_tile[1], rows = s_tile[2];
  const int nk = a.K / BK;
  const bool swiglu = a.mode == SWIGLU;
  const int n0 = blockIdx.y * (swiglu ? BN : 2 * BN);   // the CTA's first output column
  const int w0 = e * a.N + n0;                           // weight rows of accumulator 0
  const int w1 = e * a.N + (swiglu ? a.N / 2 + n0 : n0 + BN);   // and of accumulator 1

  const int wg = threadIdx.x / 128;
  if (wg == NC) {   // the producer's warpgroup
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == NC * 128) {
      for (int k = 0; k < nk; ++k) {
        unsigned char* st = tiles + (k % STAGES) * STAGE;
        uint64_t* full = &ring->full[k % STAGES];
        ring->producer_acquire(k, STAGE);
        sm90::tma_load_2d(st, &m.a, k * BK, row0, full);
        sm90::tma_load_2d(st + TA::BYTES, &m.w, k * BK, w0, full);
        sm90::tma_load_2d(st + TA::BYTES + TW::BYTES, &m.w, k * BK, w1, full);
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<CONSUMER_REGS>();
  float d0[BN / 2], d1[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d0[i] = d1[i] = 0.f;
  for (int k = 0; k < nk; ++k) {
    ring->consumer_wait(k);
    const unsigned char* st = tiles + (k % STAGES) * STAGE;
    // this warpgroup's 64 rows of the A tile; each operand K-major, 8-row
    // groups 1024 bytes apart, a 16-wide k-slice 32 bytes further on
    const uint64_t da = sm90::opaque(sm90::smem_desc(st + wg * 64 * 128, 16, 1024, sm90::SW128));
    const uint64_t db0 = sm90::opaque(sm90::smem_desc(st + TA::BYTES, 16, 1024, sm90::SW128));
    const uint64_t db1 =
        sm90::opaque(sm90::smem_desc(st + TA::BYTES + TW::BYTES, 16, 1024, sm90::SW128));
    sm90::wgmma_fence();
#pragma unroll
    for (int s = 0; s < BK / 16; ++s) {
      sm90::Wgmma<BN, 0>::run(d0, sm90::desc_at(da, 32 * s), sm90::desc_at(db0, 32 * s), 1);
      sm90::Wgmma<BN, 0>::run(d1, sm90::desc_at(da, 32 * s), sm90::desc_at(db1, 32 * s), 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();   // the stage before this one has been read
    if (k > 0) ring->consumer_release(k - 1);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(d0);
  sm90::fence_regs(d1);
  ring->consumer_release(nk - 1);

  // Epilogue from registers: thread t holds rows r and r + 8 of its
  // warpgroup's 64, columns 8j + 2(t % 4) and the next.
  const int t = threadIdx.x % 128;
  const int r_lo = wg * 64 + (t >> 5) * 16 + ((t & 31) >> 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + 8 * half;
    if (r >= rows) continue;
    const int src = row0 + r;
    const size_t orow = swiglu ? (size_t)src : (size_t)a.dst_rows[src];
    const float sc = swiglu ? 1.f : a.row_scale[src];
    bf16* o = a.out + orow * a.n_out + n0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int i = 4 * j + 2 * half;        // the pair's first element
      const int c = 8 * j + 2 * (t & 3);
      if (swiglu) {
        *reinterpret_cast<uint32_t*>(o + c) =
            sm90::pack_bf16(silu(d0[i]) * d1[i], silu(d0[i + 1]) * d1[i + 1]);
      } else {
        *reinterpret_cast<uint32_t*>(o + c) = sm90::pack_bf16(sc * d0[i], sc * d0[i + 1]);
        if (n0 + BN < a.N)
          *reinterpret_cast<uint32_t*>(o + BN + c) = sm90::pack_bf16(sc * d1[i], sc * d1[i + 1]);
      }
    }
  }
}

}  // namespace

// A [M][K] and w [E][N][K] dense bf16; offsets [E + 1] int32 on the device
// (nondecreasing, offsets[E] = M); mode 1 (SWIGLU: out [M][N / 2], N / 2 a
// multiple of 128) or 2 (SCATTER: row_scale [M] fp32, dst_rows [M] int64,
// out [rows][N], N a multiple of 128); n_out = out's row length; K a
// multiple of 64; E <= 256. Returns the CUDA error code of the launch (0
// on success), -1 for an unsupported shape or mode, -2 / -3 when a tensor
// map cannot be made.
extern "C" int moe_grouped_gemm_launch(const void* A, const void* w, const int* offsets,
                                       const float* row_scale, const long long* dst_rows,
                                       void* out, int M, int N, int K, int E, int mode,
                                       int n_out, void* stream) {
  if (E < 1 || E > MAX_E || K % BK || (mode != SWIGLU && mode != SCATTER)) return -1;
  if (mode == SWIGLU ? (N % (2 * BN) || n_out != N / 2) : (N % BN || n_out != N)) return -1;
  if (M == 0) return 0;
  Maps m{};
  int err = sm90::make_tile_map(&m.a, A, M, K, K, BM, BK);
  if (!err) err = sm90::make_tile_map(&m.w, w, (uint64_t)E * N, K, K, BN, BK);
  if (err) return err;
  const Args args{offsets, row_scale, dst_rows, static_cast<bf16*>(out), M, N, K, E, mode, n_out};
  const dim3 grid((M + BM - 1) / BM + E, mode == SWIGLU ? N / 2 / BN : (N + 2 * BN - 1) / (2 * BN));
  return sm90::launch(moe_grouped_gemm_kernel, SMEM_BYTES, grid, THREADS,
                      static_cast<cudaStream_t>(stream), m, args);
}

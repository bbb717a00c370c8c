// Beam-decode attention for SID-GR generation, for Hopper (sm_90a).
//
// Replaces the TPU kernel recsys_examples_tpu/ops/pallas/beam_decode_attention.py
// `_kernel` (launched by `_pallas_impl`, entry `beam_decode_attn`). One decode
// step of softmax attention for W beams: per batch b, query beam w and head h
//   keys = k_ctx[b, :ctx_lens[b], h / G]
//          ++ [k_beam[b, n, ancestry[b, n, w], h / G] for n < N]
//   out[b, w, h] = softmax(q[b, w, h] . keys * sm_scale) . values
// with G = H / Hkv query heads sharing a kv head. The context is shared by
// the W beams of a batch row; the N tail keys differ per beam and are found
// through the ancestry (the beam slot that holds step n's K/V on w's path).
// A row with no key at all (ctx_len 0 and N 0) comes out as zero.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s dense bf16): bytes,
// narrowly. At the full-width serving shape (B 16, W 200, H = Hkv = 8 heads
// of 128, bf16) every valid context row is 2 x 8 x 128 x 2 = 4 KB of K and V
// and takes 4 x 200 x 8 x 128 = 0.82 MFLOP: 1.22 ns of memory time against
// 0.83 ns of tensor-core time, plus q, out and the tail. With GQA (G > 1) the
// operations per byte grow G-fold and bound it. chip_smoke.py computes both
// from the run's ctx_lens.
//
// Design (simple and right first). q, the context and the beam K/V are read
// in place through their strides: no transposes, no padding of D, W or S, no
// one-hot gather. One CTA per (tile of query beams, query head, batch row).
// The CTA streams the valid context rows [0, ctx_len) of its kv head in
// chunks and keeps an online softmax (m, l, acc) in fp32 registers; masked
// columns of the last chunk take -1e30 before the max (never -inf), and a
// chunk always holds at least one valid column, so exp() never sees
// -1e30 - (-1e30). Then the N tail keys are folded in as rank-1 updates:
// each thread owns the same head-dim columns of its rows in the accumulator,
// in q and in the tail's K/V rows, so the dot product is a partial sum per
// thread reduced over the threads of the row.
//   bf16: 4 warps on mma.sync m16n8k16, 16 query rows each (64 per CTA),
//   context chunks of 64 keys through a two-stage cp.async ring. S = Q K^T
//   stays in registers; P is rounded to bf16 and reused as the A fragment of
//   P V (the C layout of two n-tiles is the A layout of one k-step); l sums
//   the unrounded P.
//   fp32: 256 threads of scalar FMA, 32 rows per CTA, 8 threads a row,
//   chunks of 32 keys.
// The context is read once per 64-beam tile (4 times for W = 200); the
// repeats hit L2. Not done yet: wgmma/TMA, sharing a kv head's loads between
// the G query heads, a split over the context when B x H x tiles is small.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90_mma.cuh"

namespace {

using sm90::bf16;
using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::ld32;
using sm90::ldmatrix_x4_trans;
using sm90::mma;
using sm90::pack_bf16;

constexpr float NEG = -1e30f;

struct Args {
  const int* ctx_lens;          // [B]
  const int* anc;               // [B, N, W] or null when N == 0
  int W, H, G, S, N;
  long long q_sb, q_sw;         // q: elements between batch rows / beams
  long long c_sb, c_ss;         // context K/V: between batch rows / positions
  long long b_sb, b_sn, b_sw;   // beam K/V: between batch rows / steps / slots
  float sm_scale;
};

// ------------------------------------------------ bf16: tensor cores
namespace tc {

constexpr int BM = 64;    // query beams per CTA: 16 per warp
constexpr int BN = 64;    // context keys per ring stage
constexpr int NT = 128;

template <int DH>
struct Smem {
  static constexpr int KS = DH + 8;   // row stride: +16 B, conflict-free
  static constexpr size_t bytes = sizeof(bf16) * (BM * KS + 4 * BN * KS);
};

template <int DH>
__global__ void __launch_bounds__(NT)
kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_ctx,
       const bf16* __restrict__ v_ctx, const bf16* __restrict__ k_beam,
       const bf16* __restrict__ v_beam, bf16* __restrict__ out, Args a) {
  constexpr int KS = Smem<DH>::KS;
  constexpr int VPR = DH / 8;     // 16-byte vectors per row
  constexpr int NJ = BN / 8;      // score n-tiles per chunk
  constexpr int NO = DH / 8;      // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // [BM][KS]
  bf16* sK = sQ + BM * KS;                         // [2][BN][KS]
  bf16* sV = sK + 2 * BN * KS;                     // [2][BN][KS]

  const int b = blockIdx.z, h = blockIdx.y, w0 = blockIdx.x * BM;
  const int kvh = h / a.G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int mi = lane / 8, rr = lane % 8;   // ldmatrix: matrix and row of lane
  const int ctx_len = max(0, min(a.ctx_lens[b], a.S));
  const bf16* qb = q + (size_t)b * a.q_sb + (size_t)h * DH;
  const bf16* kb = k_ctx + (size_t)b * a.c_sb + (size_t)kvh * DH;
  const bf16* vb = v_ctx + (size_t)b * a.c_sb + (size_t)kvh * DH;

  // the Q tile joins the first chunk's copy group
  for (int e = tid; e < BM * VPR; e += NT) {
    const int r = e / VPR, vv = e % VPR;
    const bool ok = w0 + r < a.W;
    cp_async16(sQ + r * KS + vv * 8,
               ok ? qb + (size_t)(w0 + r) * a.q_sw + vv * 8 : q, ok);
  }
  auto load_chunk = [&](int ci, int buf) {
    for (int e = tid; e < BN * VPR; e += NT) {
      const int c = e / VPR, vv = e % VPR;
      const int pos = ci * BN + c;
      const bool ok = pos < ctx_len;    // rows past the context read as zero
      const size_t off = (size_t)pos * a.c_ss + vv * 8;
      cp_async16(sK + (buf * BN + c) * KS + vv * 8, ok ? kb + off : k_ctx, ok);
      cp_async16(sV + (buf * BN + c) * KS + vv * 8, ok ? vb + off : v_ctx, ok);
    }
  };

  // rows g and g + 8 of the warp's 16: running max, sum and accumulator
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  const int n_chunks = (ctx_len + BN - 1) / BN;
  const bf16* q_s = sQ + warp * 16 * KS;
  if (n_chunks > 0) load_chunk(0, 0);
  cp_async_commit();
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int buf = ci & 1;
    if (ci + 1 < n_chunks) {
      load_chunk(ci + 1, buf ^ 1);   // that stage was freed by the last sync
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* k_s = sK + buf * BN * KS;
    const bf16* v_s = sV + buf * BN * KS;

    // S = Q K^T on the warp's 16 rows x BN columns
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const bf16* qr = q_s + g * KS + kk * 16 + 2 * t;
      const uint32_t qa[4] = {ld32(qr), ld32(qr + 8 * KS), ld32(qr + 8),
                              ld32(qr + 8 * KS + 8)};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const bf16* kr = k_s + (j * 8 + g) * KS + kk * 16 + 2 * t;
        mma(s[j], qa, ld32(kr), ld32(kr + 8));
      }
    }
    // scale and mask, then the online-softmax step of this chunk
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = ci * BN + j * 8 + 2 * t + (e & 1);
        s[j][e] = col < ctx_len ? s[j][e] * a.sm_scale : NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
      const float mn = fmaxf(m[x], mx[x]);
      corr[x] = __expf(m[x] - mn);
      m[x] = mn;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __expf(s[j][e] - m[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      rs[x] += __shfl_xor_sync(0xffffffffu, rs[x], 1);
      rs[x] += __shfl_xor_sync(0xffffffffu, rs[x], 2);
      l[x] = l[x] * corr[x] + rs[x];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }
    // O += P V: two score n-tiles are the A fragment of one k-step
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < DH / 16; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, v_s + (kk * 16 + rr + (mi & 1) * 8) * KS + np * 16 +
                                  (mi >> 1) * 8);
        mma(o[2 * np], pa, bv[0], bv[1]);
        mma(o[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();   // this stage is free again
  }
  cp_async_wait<0>();
  __syncthreads();     // Q is in shared memory even when there was no chunk

  // the N tail keys: rank-1 updates; the thread holds columns j * 8 + 2t, +1
  // of rows g and g + 8
  for (int n = 0; n < a.N; ++n) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = warp * 16 + g + x * 8;
      const int row = w0 + r;
      const int slot = row < a.W ? a.anc[((size_t)b * a.N + n) * a.W + row] : 0;
      const size_t off = (size_t)b * a.b_sb + (size_t)n * a.b_sn + (size_t)slot * a.b_sw +
                         (size_t)kvh * DH;
      const bf16* kp = k_beam + off;
      const bf16* vp = v_beam + off;
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int col = j * 8 + 2 * t;
        const float2 kf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(kp + col));
        const float2 qf =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sQ + r * KS + col));
        dot = fmaf(qf.x, kf.x, fmaf(qf.y, kf.y, dot));
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const float sn = dot * a.sm_scale;
      const float mn = fmaxf(m[x], sn);
      const float c = __expf(m[x] - mn), p = __expf(sn - mn);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const float2 vf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(vp + j * 8 + 2 * t));
        o[j][2 * x] = fmaf(p, vf.x, o[j][2 * x] * c);
        o[j][2 * x + 1] = fmaf(p, vf.y, o[j][2 * x + 1] * c);
      }
      l[x] = l[x] * c + p;
      m[x] = mn;
    }
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int row = w0 + warp * 16 + g + x * 8;
    if (row >= a.W) continue;
    const float inv = 1.f / fmaxf(l[x], 1e-30f);   // l = 0: no key at all, out = 0
    bf16* orow = out + (((size_t)b * a.W + row) * a.H + h) * DH;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t) =
          __floats2bfloat162_rn(o[j][2 * x] * inv, o[j][2 * x + 1] * inv);
  }
}

}  // namespace tc

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

template <typename E, typename Kern>
int launch_kernel(Kern kern, size_t smem, int bm, int nt, const void* q, const void* kc,
                  const void* vc, const void* kb, const void* vb, void* out,
                  const Args& a, int B, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.W + bm - 1) / bm, a.H, B);
  kern<<<grid, nt, smem, st>>>(
      static_cast<const E*>(q), static_cast<const E*>(kc), static_cast<const E*>(vc),
      static_cast<const E*>(kb), static_cast<const E*>(vb), static_cast<E*>(out), a);
  return (int)cudaGetLastError();
}

template <typename E, int DH>
int launch(const void* q, const void* kc, const void* vc, const void* kb, const void* vb,
           void* out, const Args& a, int B, cudaStream_t st) {
  if constexpr (sizeof(E) == 2)
    return launch_kernel<E>(tc::kernel<DH>, tc::Smem<DH>::bytes, tc::BM, tc::NT, q, kc, vc,
                            kb, vb, out, a, B, st);
  else
    return launch_kernel<E>(scalar::kernel<DH>, scalar::Smem<DH>::bytes, scalar::BM,
                            scalar::NT, q, kc, vc, kb, vb, out, a, B, st);
}

template <typename E>
int dispatch_dh(int dh, const void* q, const void* kc, const void* vc, const void* kb,
                const void* vb, void* out, const Args& a, int B, cudaStream_t st) {
  switch (dh) {
    case 32: return launch<E, 32>(q, kc, vc, kb, vb, out, a, B, st);
    case 64: return launch<E, 64>(q, kc, vc, kb, vb, out, a, B, st);
    case 128: return launch<E, 128>(q, kc, vc, kb, vb, out, a, B, st);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = bf16, 1 = fp32 (q, the context, the beam K/V and out share it).
// q [B, W, H, D] with strides q_sb / q_sw (elements) and dense [H, D]; the
// context [B, S, Hkv, D] with strides c_sb / c_ss and dense [Hkv, D]; the beam
// K/V [B, N, W, Hkv, D] with strides b_sb / b_sn / b_sw (null when N == 0);
// ancestry [B, N, W] and ctx_lens [B] dense int32; out dense [B, W, H, D].
// Returns the CUDA error code of the launch (0 on success) or -1 for an
// unsupported dtype, head dim or head grouping.
extern "C" int beam_decode_attn_launch(
    int dtype, const void* q, const void* k_ctx, const void* v_ctx, const int* ctx_lens,
    const void* k_beam, const void* v_beam, const int* ancestry, void* out, int B, int W,
    int H, int Hkv, int D, int S, int N, long long q_sb, long long q_sw, long long c_sb,
    long long c_ss, long long b_sb, long long b_sn, long long b_sw, float sm_scale,
    void* stream) {
  if (Hkv <= 0 || H % Hkv) return -1;
  if (B == 0 || W == 0 || H == 0) return 0;
  const Args a{ctx_lens, ancestry, W, H, H / Hkv, S, N, q_sb, q_sw, c_sb, c_ss,
               b_sb, b_sn, b_sw, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<bf16>(D, q, k_ctx, v_ctx, k_beam, v_beam, out, a, B, st);
  if (dtype == 1)
    return dispatch_dh<float>(D, q, k_ctx, v_ctx, k_beam, v_beam, out, a, B, st);
  return -1;
}

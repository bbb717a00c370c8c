// Hopper (sm_90a) building blocks of the port's warp-specialised kernels:
// cp.async copies, wgmma shared-memory descriptors and the bf16 m64nNk16
// product with A from shared memory or from registers, the int8 m64nNk32
// product with int32 sums, the repack of an accumulator into A fragments,
// its fence / commit / wait, the TMA tensor map (2-D and 3-D) and the panel
// tile it loads, the widening of int8 rows into such a tile, the mbarrier
// full/empty ring, named barriers, setmaxnreg, thread-block clusters
// (barrier, distributed shared memory, launch) and the product chains of K1
// and K6.
//
// Tile layout. A [R][D] bf16 tile (R = 64 rows, or 32) arrives by TMA as
// D / PW panels of [R rows][PW columns], PW = 64 (128-byte rows, 128-byte
// swizzle) or, for D = 32, PW = 32 (64-byte rows, 64-byte swizzle). Panel i
// holds columns i*PW .. i*PW + PW - 1 at byte offset i * R * 2PW. Inside a
// panel, row r's 16-byte chunk j lies at r * 2PW + 16 * (j ^ f(r)), with
// f(r) = r % 8 for the 128-byte swizzle, (r / 2) % 4 for the 64-byte one
// and (r / 4) % 2 for the 32-byte one; the swizzle acts on address bits, so
// every panel starts on a 1024-byte boundary. An int8 [64][D] tile (`Tile8`)
// has the same bytes as a bf16 [64][D / 2] one: a 128-byte panel holds 128
// int8 columns, and at D = 32 the rows are 32 bytes with the 32-byte swizzle.
//
// The two ways wgmma reads such a tile (cute's canonical GMMA layouts):
//  - K-major (the reduction index runs along a row): start = the k-slice's
//    byte offset in the row (32 bytes a slice: 16 bf16 or 32 int8 values,
//    in panel k0 / PW); SBO = 8 rows = 8 * 2PW bytes between 8-row groups;
//    LBO unused.
//  - MN-major (the output index runs along a row; the B operand read with
//    its transpose bit): start = row k0, column n0 of the panel holding n0;
//    LBO = the panel size (the next PW output columns), SBO = 8 rows (the
//    next 8 k).
// A [64][64] product tile that a kernel writes itself (P, dS) uses the
// 128-byte swizzle with 128-byte rows: `swz128`.
// wgmma accumulator layout (m64nN, fp32, thread t of the warpgroup, element
// i of N/2): row (t / 32) * 16 + (t % 32) / 4 + 8 * ((i / 2) % 2), column
// 8 * (i / 4) + 2 * (t % 4) + i % 2.
//
// Register A (`WgmmaRS`). The A operand of an m64nNk16 bf16 product may come
// from four 32-bit registers a thread instead of shared memory. Their layout
// is the PTX ISA's "Register Fragments" of the warpgroup-level matrix
// multiply (section "Asynchronous Warpgroup Level Matrix Multiply-Accumulate
// Instructions" > "Register Fragments and Shared Memory Matrix Layouts",
// figure "WGMMA .m64nNk16 register fragment layout for matrix A"): warp
// t / 32 holds rows 16 (t / 32) .. + 15 of the 64 x 16 slice; with
// g = (t % 32) / 4 and c = 2 (t % 4), register 0 holds (row g, columns c and
// c + 1), register 1 (g + 8, c ..), register 2 (g, c + 8 ..), register 3
// (g + 8, c + 8 ..), the lower column in the low 16 bits. That is where an
// m64nN accumulator keeps its elements 8j .. 8j + 7 of columns 16j .. 16j +
// 15 (above), so slice j of a product's A is `acc_to_a` of the accumulator
// of the product before it: pack(d[8j], d[8j + 1]), pack(d[8j + 2],
// d[8j + 3]), ... (FlashAttention-3's P, which never goes through shared
// memory). The registers are read while the product runs: they must not be
// written before its wgmma_wait.
#pragma once

#include <cuda.h>            // CUtensorMap and its enums (types only: libcuda is not linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ copies
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16-byte async copy; zero-fills the destination when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}
// 4-byte async copy (one fp32 scale); zero-fills when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------ descriptors
enum : int { SW128 = 1, SW64 = 2, SW32 = 3 };   // the descriptor's layout_type

__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

// `x`, hidden from the compiler: the descriptors of a product chain (or the
// addresses of a copy) derived from it are then computed where the chain
// runs, not hoisted out of the tile loop into registers that stay live
// across it.
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// The descriptor of the operand `bytes` (a multiple of 16) further on in
// shared memory: the start address is the low 14 bits, in 16-byte units, and
// shared addresses stay below 2^18, so the add does not carry out of them.
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, int bytes) {
  return desc + (uint64_t)(bytes >> 4);
}

// Byte offset of element (r, c) in a [rows][64] bf16 tile with 128-byte rows
// and the 128-byte swizzle.
__device__ __forceinline__ int swz128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1));
}

__device__ __forceinline__ int acc_row(int t, int i) {
  return (t >> 5) * 16 + ((t & 31) >> 2) + ((i >> 1) & 1) * 8;
}
__device__ __forceinline__ int acc_col(int t, int i) {
  return (i >> 2) * 8 + (t & 3) * 2 + (i & 1);
}

// ------------------------------------------------------------ wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keep the compiler from moving reads of accumulators across a wait (or
// their initialisation past the first product).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define SM90_F8(i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),   \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x N] (+)= A[64 x 16] . B[16 x N] in bf16 with fp32 sums; A and B
// from shared memory through their descriptors; TB = 1 reads B MN-major.
// `acc` 0 overwrites d.
template <int N, int TB>
struct Wgmma;

template <int TB>
struct Wgmma<16, TB> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, %11;\n}\n"
        : SM90_F8(0)
        : "l"(a), "l"(b), "r"(acc), "n"(TB));
  }
};

template <int TB>
struct Wgmma<32, TB> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, %19;\n}\n"
        : SM90_F8(0), SM90_F8(8)
        : "l"(a), "l"(b), "r"(acc), "n"(TB));
  }
};

template <int TB>
struct Wgmma<64, TB> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, %35;\n}\n"
        : SM90_F8(0), SM90_F8(8), SM90_F8(16), SM90_F8(24)
        : "l"(a), "l"(b), "r"(acc), "n"(TB));
  }
};

template <int TB>
struct Wgmma<128, TB> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, %67;\n}\n"
        : SM90_F8(0), SM90_F8(8), SM90_F8(16), SM90_F8(24), SM90_F8(32), SM90_F8(40),
          SM90_F8(48), SM90_F8(56)
        : "l"(a), "l"(b), "r"(acc), "n"(TB));
  }
};

// d[64 x N] (+)= A[64 x 16] . B[16 x N] with A in registers (a0 .. a3, the
// register fragment above) and B from shared memory through its descriptor,
// read MN-major with TB = 1. `acc` 0 overwrites d.
template <int N, int TB>
struct WgmmaRS;

template <int TB>
struct WgmmaRS<32, TB> {
  static __device__ __forceinline__ void run(float (&d)[16], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : SM90_F8(0), SM90_F8(8)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(acc), "n"(TB));
  }
};

template <int TB>
struct WgmmaRS<64, TB> {
  static __device__ __forceinline__ void run(float (&d)[32], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : SM90_F8(0), SM90_F8(8), SM90_F8(16), SM90_F8(24)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(acc), "n"(TB));
  }
};

template <int TB>
struct WgmmaRS<128, TB> {
  static __device__ __forceinline__ void run(float (&d)[64], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : SM90_F8(0), SM90_F8(8), SM90_F8(16), SM90_F8(24), SM90_F8(32), SM90_F8(40),
          SM90_F8(48), SM90_F8(56)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(acc), "n"(TB));
  }
};

#define SM90_I8(i)                                                              \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),   \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d[64 x 64] (+)= A[64 x 32] . B[32 x 64] in int8 with int32 sums, both
// operands K-major from shared memory (the integer forms take no transpose).
// `acc` 0 overwrites d. Products of int8 values summed in int32 are exact.
struct WgmmaS8 {
  static __device__ __forceinline__ void run(int (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : SM90_I8(0), SM90_I8(8), SM90_I8(16), SM90_I8(24)
        : "l"(a), "l"(b), "r"(acc));
  }
};

#undef SM90_I8
#undef SM90_F8

// An m64nN accumulator (R = N / 2 values a thread) as the bf16 A fragments
// of its N / 16 k-slices: slice j is a[4j .. 4j + 3] (register A, above).
template <int R>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[R / 2], const float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i) a[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
}

// ------------------------------------------------------------ TMA, mbarrier
// Copy the box at (c0 = column, c1 = row) of `map` into shared memory at
// `dst`; the bytes arrive on `bar`'s transaction count.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(smem_u32(bar))
      : "memory");
}

// The same for a 3-D map: the box at (c0 = column, c1 = row, c2 = batch).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// after the inits, before any thread uses the barriers
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also expects `bytes` of TMA traffic
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}
// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
}

// A ring of STAGES buffers with full (producer -> consumers: the TMA bytes
// landed) and empty (consumers -> producer: the buffer was read) barriers.
// Use i of the ring is buffer i % STAGES in round i / STAGES; the producer's
// first round finds every buffer empty.
template <int STAGES>
struct Ring {
  uint64_t full[STAGES], empty[STAGES];
  __device__ void init(int consumers) {   // one thread
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers);
    }
  }
  __device__ void producer_acquire(int i, uint32_t bytes) {
    mbar_wait(&empty[i % STAGES], ((i / STAGES) & 1) ^ 1);
    mbar_expect_tx(&full[i % STAGES], bytes);
  }
  __device__ void consumer_wait(int i) { mbar_wait(&full[i % STAGES], (i / STAGES) & 1); }
  __device__ void consumer_release(int i) { mbar_arrive(&empty[i % STAGES]); }
};

// ------------------------------------------------------------ warpgroups
// Shared-memory writes of the generic proxy (st.shared), made visible to the
// async proxy (wgmma, TMA) before a barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
template <int THREADS>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(THREADS) : "memory");
}
// arrive at named barrier `id` without waiting for it
template <int THREADS>
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(THREADS) : "memory");
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

// 16 bytes from / to a shared-memory address (the state space explicit: a
// generic pointer passed down loses it, and generic accesses are slower).
__device__ __forceinline__ uint4 ld_shared4(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
  return v;
}
__device__ __forceinline__ void st_shared4(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(a), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

// ------------------------------------------------------------ clusters
// Every thread of every CTA of the cluster arrives; the wait returns when
// all have, and shared-memory writes before the arrive are visible to reads
// after the wait, in any CTA of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// The same shared-memory address in the CTA of cluster rank `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float2 ld_cluster2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// ------------------------------------------------------------ panel tiles
constexpr int TILE_ROWS = 64;   // rows of a TMA tile, unless a kernel says otherwise

// The panels of a [ROWS][DH] bf16 tile (the layout at the top of this file).
template <int DH, int ROWS = TILE_ROWS>
struct Tile {
  static constexpr int PW = DH < 64 ? DH : 64;   // panel columns (one TMA box row)
  static constexpr int PB = 2 * PW;              // panel row bytes = the swizzle span
  static constexpr int NP = DH / PW;             // panels per tile
  static constexpr int PANEL = ROWS * PB;        // bytes of a panel
  static constexpr int BYTES = NP * PANEL;       // bytes of a tile
  static constexpr int SW = PB == 128 ? SW128 : PB == 64 ? SW64 : SW32;
  static_assert(BYTES % 1024 == 0, "tiles start on 1024-byte boundaries");
};

// The panels of a [64][DH] int8 tile: the bytes of a bf16 [64][DH / 2] one
// (DH 32: 32-byte rows under the 32-byte swizzle).
template <int DH>
using Tile8 = Tile<DH / 2>;

// Byte offset of element (r, c), c a multiple of 8, in a [ROWS][DH] bf16
// tile of TMA panels.
template <int DH, int ROWS = TILE_ROWS>
__device__ __forceinline__ uint32_t tile_off(uint32_t r, uint32_t c) {
  using L = Tile<DH, ROWS>;
  const uint32_t f = L::PB == 128 ? (r & 7) : ((r >> 1) & 3);
  return (c / L::PW) * L::PANEL + r * L::PB + ((((c % L::PW) >> 3) ^ f) << 4);
}

// 16 int8 values (one 16-byte vector) -> 16 bf16 values, two a word in
// order, without a conversion instruction: for each value x, A = 0x4300 |
// (x & 127) reads 128 + (x & 127) and B = 0x4300 | (x & 128) reads 128 + 128 s
// (s the sign bit), so A - B (one bf16x2 subtraction a pair) is x, exactly.
__device__ __forceinline__ void widen16(uint32_t (&o)[8], uint4 raw) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t t = __byte_perm(w[i / 2], 0, i % 2 ? 0x4342 : 0x4140);   // bytes at 0 and 16
    const uint32_t a = (t & 0x007F007Fu) | 0x43004300u, b = (t & 0x00800080u) | 0x43004300u;
    asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(o[i]) : "r"(a), "r"(b));
  }
}

// Rows [row, row + 64) and columns [col, col + DH) of `map` into a tile.
template <int DH>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map, int col,
                                          int row, uint64_t* bar) {
  using L = Tile<DH>;
#pragma unroll
  for (int i = 0; i < L::NP; ++i) tma_load_2d(dst + i * L::PANEL, map, col + i * L::PW, row, bar);
}

// The same for an int8 tile (`Tile8`; an int8 map's columns are bytes).
template <int DH>
__device__ __forceinline__ void load_tile8(unsigned char* dst, const CUtensorMap* map, int col,
                                           int row, uint64_t* bar) {
  using L = Tile8<DH>;
#pragma unroll
  for (int i = 0; i < L::NP; ++i) tma_load_2d(dst + i * L::PANEL, map, col + i * L::PB, row, bar);
}

// ------------------------------------------------------------ product chains
// K1's, K5's, K6's and K7's: S = Q K^T and O += P V over [64][DH] tiles (K7:
// also [32][DH] ones).
template <int DH>
struct Out {
  static constexpr int CH = DH < 128 ? DH : 128;   // output columns of one P V chain
  static constexpr int NCH = DH / CH;              // chains per k-slice
};

// fast reciprocal: two ulps at most, far below the bf16 rounding of P
__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }

// A[64][DH] . B[64][DH]^T ([64 x 64]) as two sums, the even 16-wide
// k-slices into `even` and the odd ones into `odd`, both tiles read K-major:
// the score is even + odd, as the mma.sync forward before K1 summed it (a
// single chain over all slices rounds otherwise, enough to move
// chip_smoke.py's phase 6a loss past its limit). The descriptors are the
// tiles' own plus a constant each (`desc_at`), made where the chain runs
// (`opaque`): hoisted out of the tile loop, Q's 16 would pin 32 registers.
template <int DH>
__device__ __forceinline__ void score_chain(float (&even)[32], float (&odd)[32],
                                            const unsigned char* a, const unsigned char* b) {
  using L = Tile<DH>;
  constexpr int SL = L::PW / 16;   // 16-wide k-slices per panel
  const uint64_t da = sm90::opaque(sm90::smem_desc(a, 16, 8 * L::PB, L::SW));
  const uint64_t db = sm90::opaque(sm90::smem_desc(b, 16, 8 * L::PB, L::SW));
#pragma unroll
  for (int s = 0; s < DH / 16; ++s) {
    const int off = (s / SL) * L::PANEL + (s % SL) * 32;
    sm90::Wgmma<64, 0>::run(s % 2 ? odd : even, sm90::desc_at(da, off), sm90::desc_at(db, off),
                            s > 1);
  }
}

// The same product in one sum (K6's score: no loss limit to keep, and 32
// registers fewer beside O), or, with N < 64, against a [N][DH] tile b
// (K7's 32-key chunks): A[64][DH] . B[N][DH]^T ([64 x N]).
template <int DH, int N = TILE_ROWS>
__device__ __forceinline__ void score_chain(float (&acc)[N / 2], const unsigned char* a,
                                            const unsigned char* b) {
  using LA = Tile<DH>;
  using LB = Tile<DH, N>;
  constexpr int SL = LA::PW / 16;
  const uint64_t da = sm90::opaque(sm90::smem_desc(a, 16, 8 * LA::PB, LA::SW));
  const uint64_t db = sm90::opaque(sm90::smem_desc(b, 16, 8 * LB::PB, LB::SW));
#pragma unroll
  for (int s = 0; s < DH / 16; ++s) {
    const int k = (s % SL) * 32;
    sm90::Wgmma<N, 0>::run(acc, sm90::desc_at(da, (s / SL) * LA::PANEL + k),
                           sm90::desc_at(db, (s / SL) * LB::PANEL + k), s > 0);
  }
}

// The same product on int8 tiles (`Tile8`) in one int32 chain of DH / 32
// slices: int8 products summed in int32 are exact in any order.
template <int DH>
__device__ __forceinline__ void score_chain8(int (&acc)[32], const unsigned char* a,
                                             const unsigned char* b) {
  using L = Tile8<DH>;
  constexpr int SL = L::PB / 32;   // 32-byte k-slices per panel
  const uint64_t da = sm90::opaque(sm90::smem_desc(a, 16, 8 * L::PB, L::SW));
  const uint64_t db = sm90::opaque(sm90::smem_desc(b, 16, 8 * L::PB, L::SW));
#pragma unroll
  for (int s = 0; s < DH / 32; ++s) {
    const int off = (s / SL) * L::PANEL + (s % SL) * 32;
    sm90::WgmmaS8::run(acc, sm90::desc_at(da, off), sm90::desc_at(db, off), s > 0);
  }
}

// o[64 x DH] += P[64 x K] . X[K][DH]: P as A fragments (slice kk in
// pa[4 kk .. 4 kk + 3]), X a [K][DH] tile read MN-major (K = 64, or K7's 32).
template <int DH, int K = TILE_ROWS>
__device__ __forceinline__ void pv_chain(float (&o)[Out<DH>::NCH][Out<DH>::CH / 2],
                                         const uint32_t (&pa)[K / 4], const unsigned char* x) {
  using L = Tile<DH, K>;
  using O = Out<DH>;
  const uint64_t dx = sm90::opaque(sm90::smem_desc(x, L::PANEL, 8 * L::PB, L::SW));
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int j = 0; j < O::NCH; ++j) {
      const int c0 = j * O::CH;
      const int off = (c0 / L::PW) * L::PANEL + (c0 % L::PW) * 2 + kk * 16 * L::PB;
      sm90::WgmmaRS<O::CH, 1>::run(o[j], pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                                   pa[4 * kk + 3], sm90::desc_at(dx, off), 1);
    }
}

template <int DH>
__device__ __forceinline__ void fence_out(float (&o)[Out<DH>::NCH][Out<DH>::CH / 2]) {
#pragma unroll
  for (int j = 0; j < Out<DH>::NCH; ++j) sm90::fence_regs(o[j]);
}

// ------------------------------------------------------------ host: tensor maps
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: fetched through the runtime,
// so the library does not link libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// The map of a matrix [rows][cols] of `type` elements of `esize` bytes (`ld`
// elements between rows) or, with `ld_batch` > 0 elements between batches,
// of a tensor [batches][rows][cols] (3-D), read in boxes of box_rows x
// box_cols (of one batch), with the given swizzle. Rows and columns past the tensor read as zero, and a box's
// bytes all count on its barrier. Returns 0, or -2 without
// `cuTensorMapEncodeTiled`, -3 if it refuses the map.
inline int make_map(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* base,
                    uint64_t rows, uint64_t cols, uint64_t ld, uint32_t box_rows,
                    uint32_t box_cols, CUtensorMapSwizzle sw, uint64_t batches = 1,
                    uint64_t ld_batch = 0) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return -2;
  const cuuint32_t rank = ld_batch ? 3 : 2;
  const cuuint64_t dims[3] = {cols, rows, batches};
  const cuuint64_t strides[2] = {ld * esize, ld_batch * esize};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, type, rank, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

// The swizzle of a box row of `bytes` (128, 64 or 32).
inline CUtensorMapSwizzle swizzle_of(uint32_t bytes) {
  return bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
}

// The map of a bf16 matrix [rows][cols] (`ld` elements between rows) read in
// boxes of box_rows x box_cols, box_cols * 2 bytes being the swizzle span
// (128 or 64); with `ld_batch` > 0, of a bf16 tensor [batches][rows][cols]
// (3-D). Same return codes.
inline int make_tile_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                         uint64_t ld, uint32_t box_rows, uint32_t box_cols,
                         uint64_t batches = 1, uint64_t ld_batch = 0) {
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rows, cols, ld, box_rows,
                  box_cols, swizzle_of(box_cols * 2), batches, ld_batch);
}

// The maps of N packed bf16 tensors [T][H * dh], read in 64-row boxes of one
// panel. Same return codes as make_tile_map.
template <int N>
inline int make_row_maps(CUtensorMap (&m)[N], const void* const (&x)[N], int T, int H, int dh) {
  const int pw = dh < 64 ? dh : 64;
  for (int i = 0; i < N; ++i) {
    const int err = make_tile_map(&m[i], x[i], T, (uint64_t)H * dh, (uint64_t)H * dh,
                                  TILE_ROWS, pw);
    if (err) return err;
  }
  return 0;
}

// The map of a packed int8 tensor [T][H * dh], read in 64-row boxes of one
// `Tile8` panel (min(dh, 128) bytes, swizzled). Same return codes.
inline int make_row_map_i8(CUtensorMap* m, const void* x, int T, int H, int dh) {
  const uint32_t pb = dh < 128 ? dh : 128;
  return make_map(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, T, (uint64_t)H * dh, (uint64_t)H * dh,
                  TILE_ROWS, pb, swizzle_of(pb));
}

// ------------------------------------------------------------ host: launch
template <class T>
struct same { using type = T; };

// Launch `kern` with `smem` bytes of dynamic shared memory; the CUDA error
// code of the launch (0 on success).
template <typename... A>
int launch(void (*kern)(A...), size_t smem, dim3 grid, int threads, cudaStream_t st,
           typename same<A>::type... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// Launch `kern` as clusters of `cluster` CTAs along x (gridDim.x a multiple
// of it); more than 8 only where the card allows it. The CUDA error code of
// the launch.
template <typename... A>
int launch_cluster(void (*kern)(A...), size_t smem, dim3 grid, int threads, int cluster,
                   cudaStream_t st, typename same<A>::type... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` CTAs of `kern` (`threads` threads and `smem`
// bytes of dynamic shared memory each) the card holds at once; a negative
// CUDA error code when the query fails.
template <typename... A>
int cluster_capacity(void (*kern)(A...), size_t smem, int threads, int cluster) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace sm90

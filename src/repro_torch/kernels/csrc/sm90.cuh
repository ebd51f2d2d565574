// sm90.cuh — the Hopper (sm_90a) building blocks of the hand-written
// kernels: mbarriers, TMA tile loads through tensor maps, wgmma shared-
// memory descriptors for 128-byte-swizzled tiles, bf16 wgmma with float32
// accumulators (A from shared memory or from registers, B K-major or
// MN-major, N up to 256 either way), transposed ldmatrix, and the
// host-side encoding of a tensor map.
//
// Everything is inline PTX or a plain C++ inline function: the including
// source stays a plain C interface built by nvcc alone (no PyTorch
// headers, no -lcuda: cuTensorMapEncodeTiled is looked up at run time
// through the runtime's entry-point query).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the other threads and to the
// async proxy (TMA) before anyone uses them
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic for this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// spin until the phase of parity `parity` has completed.  A phase that
// never completes (bytes announced that never arrive) traps after about
// 2^35 cycles (~17 s), so a fault ends the launch with an error instead
// of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1LL << 35)) __trap();
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// copy the box at (c0, c1, c2) (innermost first) of `map` into shared
// memory at `dst`; completion is counted in bytes on `bar`.  Rows past the
// tensor's extent arrive as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a tile stored with the 128-byte
// swizzle (rows of 128 bytes, 8-row atoms of 1024 bytes, 1024-byte
// aligned).  `lbo` and `sbo` in bytes.  K-major operands (the contraction
// dimension contiguous) step 8-row groups by `sbo` and ignore `lbo`;
// MN-major ones step 8-row groups of the contraction dimension by one of
// them and 64-element blocks of the other dimension by the other.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;  // SWIZZLE_128B
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence / wait around it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define SM90_ACC32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "      \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "       \
  "%28, %29, %30, %31}"

#define SM90_OUT32(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),               \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),               \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),          \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),          \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),          \
  "+f"(d[30]), "+f"(d[31])

#define SM90_ACC64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "      \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "       \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "       \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "       \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

#define SM90_OUT64(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),               \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),               \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),          \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),          \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),          \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),          \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),          \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),          \
  "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),          \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),          \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),          \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define SM90_ACC128                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "      \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "       \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "       \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "       \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "       \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "       \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "       \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "       \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "      \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "      \
  "%127}"

#define SM90_OUT128(d)                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),               \
  "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),               \
  "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),          \
  "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),          \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),          \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),          \
  "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),          \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),          \
  "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),          \
  "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),          \
  "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),          \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),          \
  "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),          \
  "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),          \
  "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),          \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),          \
  "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),          \
  "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),          \
  "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),          \
  "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),                   \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),                   \
  "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),                   \
  "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),                   \
  "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),                   \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),                   \
  "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// d (64 x 64, float32) = A B (+ d when accumulate != 0): A 64 x 16 and B
// 64 x 16 (N x K), both bf16, K-major, in shared memory.  Thread t of the
// warpgroup holds d[4j + 2h + e] at row 16 (t / 32) + (t % 32) / 4 + 8 h,
// column 8 j + 2 (t % 4) + e.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t da,
                                                   uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_ACC32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N, float32) += A B for N in {64, 128, 256}: A 64 x 16 bf16 in
// registers (thread t holds a[2 h2 + h] = the pair at row 16 (t / 32) +
// (t % 32) / 4 + 8 h, columns 8 h2 + 2 (t % 4) + {0, 1}: the layout of d
// above), B 16 x N (K x N) bf16 in shared memory, MN-major (N contiguous:
// the transpose bit).  d holds N / 2 floats in the layout above.
template <int N>
__device__ __forceinline__ void wgmma_m64k16_rs_tb(float* d,
                                                   const uint32_t* a,
                                                   uint64_t db);

template <>
__device__ __forceinline__ void wgmma_m64k16_rs_tb<64>(float* d,
                                                      const uint32_t* a,
                                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_ACC32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : SM90_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16_rs_tb<128>(float* d,
                                                      const uint32_t* a,
                                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_ACC64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : SM90_OUT64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16_rs_tb<256>(float* d,
                                                      const uint32_t* a,
                                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " SM90_ACC128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : SM90_OUT128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x N, float32) += A B for N in {64, 128, 256}: A 64 x 16 bf16 in
// shared memory, K-major (as wgmma_m64n64k16_ss's), B 16 x N (K x N) bf16
// in shared memory, MN-major (the transpose bit, as wgmma_m64k16_rs_tb's).
// d in the layout above.
template <int N>
__device__ __forceinline__ void wgmma_m64k16_ss_tb(float* d, uint64_t da,
                                                   uint64_t db);

template <>
__device__ __forceinline__ void wgmma_m64k16_ss_tb<64>(float* d, uint64_t da,
                                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_ACC32
      ", %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : SM90_OUT32(d)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16_ss_tb<128>(float* d,
                                                       uint64_t da,
                                                       uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_ACC64
      ", %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : SM90_OUT64(d)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16_ss_tb<256>(float* d,
                                                       uint64_t da,
                                                       uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " SM90_ACC128
      ", %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : SM90_OUT128(d)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x N, float32) += A B^T for N in {64, 128, 256}: A 64 x 16 and B
// N x 16 (N x K), both bf16, K-major, in shared memory (as
// wgmma_m64n64k16_ss's; B's N rows in 8-row atoms 1024 bytes apart).
// d in the layout above.
template <int N>
__device__ __forceinline__ void wgmma_m64k16_ss_kb(float* d, uint64_t da,
                                                   uint64_t db);

template <>
__device__ __forceinline__ void wgmma_m64k16_ss_kb<64>(float* d, uint64_t da,
                                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_ACC32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_OUT32(d)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16_ss_kb<128>(float* d,
                                                       uint64_t da,
                                                       uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_ACC64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_OUT64(d)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16_ss_kb<256>(float* d,
                                                       uint64_t da,
                                                       uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " SM90_ACC128
      ", %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_OUT128(d)
      : "l"(da), "l"(db), "r"(1));
}

#undef SM90_ACC32
#undef SM90_OUT32
#undef SM90_ACC64
#undef SM90_OUT64
#undef SM90_ACC128
#undef SM90_OUT128

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

__device__ __forceinline__ __nv_bfloat162 bits_bf16x2(uint32_t u) {
  __nv_bfloat162 h;
  memcpy(&h, &u, sizeof(h));
  return h;
}

// four 8 x 8 bf16 matrices from shared memory, transposed: lane i gives
// the address of row i % 8 of matrix i / 8 (16 bytes), and r[m] receives
// matrix m's elements (2 (lane % 4), lane / 4) and (2 (lane % 4) + 1,
// lane / 4), the first in the low half
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime (nullptr if
// it is missing)
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map over a contiguous bf16 tensor (outer, rows, cols) whose
// boxes are (1, box_rows, 64) with the 128-byte swizzle: one box is a
// 64-column panel of box_rows rows, 128 bytes a row.  Rows past `rows`
// read as zeros and never from the next `outer` index.  cols must be a
// multiple of 64.  Returns false if the encoding fails.
inline bool encode_bf16_panels(CUtensorMap* map, const void* base, int outer,
                               int rows, int cols, int box_rows) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90

// flash_attention — the forward pass of causal / sliding-window softmax
// attention with an online softmax and float32 accumulation, its products
// on the tensor cores (mma.sync): float32 through a three-term TF32 split,
// bf16 as bf16 with the softmax weights split hi/lo.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// _flash_kernel (:27, wrapper flash_attention_fwd :70) and keeps its
// semantics where they differ from the oracle repro/kernels/ref.py:
// attention_ref: the layout is (B, H, S, D); the causal mask is
// left-aligned, k <= q, also when Sq != Sk; the window keeps k > q - window;
// a row that no key may attend gives 0 (the max(l, 1e-30) guard).  Unlike
// the Pallas wrapper it takes any Sq and Sk (the ragged tiles are masked
// here).  q (BH, Sq, D), k (BH, Sk, D), v (BH, Sk, Dv) and o (BH, Sq, Dv)
// in T (float or bf16), D and Dv <= 256.  Per row, with s_j = scale q.k_j
// on the pairs the masks keep:
//   o = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-30),
// m the running max, rescaled by exp(m_old - m_new) as each k tile lands.
// csrc/flash_attention_sm90.cu takes bf16 with D == Dv in {64, 128, 256};
// this source every other type and head dim.
//
// Bound: operations.  At the float32 case of its entry point, the
// recurrentgemma-9b local-attention shape (B = 4, 16 heads, S = 3072, D =
// 256, window 2048), the 268.5 M kept (q, k) pairs need 4 D = 1024 float
// ops each: 274.9 GFLOP (4.10 ms on the float32 CUDA cores, 67 TFLOP/s);
// q, k, v and o are 805 MB (240 us at 3.35 TB/s).  The three-term split
// does three TF32 products for each float32 one: 824.8 GFLOP, 1.67 ms at
// the 495 TFLOP/s TF32 peak, the bound.  In
// bf16 at D = 32 (S = 3000, window 2048) the 259.1 M pairs need 33.2
// GFLOP: 34 us at the 989 TFLOP/s bf16 peak (50 us for the mix: q k^T
// once and p v twice).
//
// Precision.  One TF32 product keeps 11 bits of each operand (about 2^-11
// of each product), which misses flash_check's allowance (2^-16 of the
// sums over absolute values).  So every float32 operand x is split, hi =
// tf32_rna(x) and lo = tf32_rna(x - hi) (the subtraction is exact), and a
// b = a_hi b_hi + a_hi b_lo + a_lo b_hi, each product exact in the tensor
// core's float32 sum: what is left out, a_lo b_lo and lo's own rounding,
// is about 2^-21 of |a b|.  This for q k^T and for p v.  bf16 q, k and v
// enter bf16 products as they are (each product exact); p is float32, so
// it enters p v as p_hi + p_lo, two bf16 products (as the sm90 source
// does): about 2^-17 of p is left out.  l sums the unsplit float32 p.
//
// Design.  One block of eight warps per (b h, 64-row q tile), the q
// tiles heaviest first (the causal edge makes the last tiles the
// longest).  The block walks the k tiles of 32 keys that its rows may
// attend (tiles that the masks leave empty are never loaded); warp w
// owns q rows 16 (w % 4) .. + 15 and keys 16 (w / 4) .. + 15 of each tile,
// so two warps share each row group, each with its own running max, sum
// and output accumulator, and the second hands its (m, l, o) to the first
// at the end: o = o_a 2^(m_a - m) + o_b 2^(m_b - m), l likewise.  A warp
// skips the arithmetic of a tile that is empty for its rows and keys, and
// applies the masks only where the causal edge, the window or Sk cut its
// 16 x 16.  Shared memory holds the q tile and a two-stage ring of k and
// v tiles, filled by cp.async (16 bytes a thread where rows are 16-byte
// aligned, else plain loads) so that tile i + 1 lands during tile i's
// products; rows past Sq or Sk arrive as zeros, and D and Dv are padded
// with zeros to the MMA depth (32 bytes: 8 floats or 16 bf16) and to the
// NV n8 tiles of the output.  Each q / k row is 32 bytes longer than its
// padded data and each v row 16 bytes longer, so the fragment loads below
// hit 32 different banks.  At D = Dv = 256 in float32 that is 64 x 1056 +
// 2 x 32 x (1056 + 1040) bytes = 197 KB (one block an SM).  Per k tile a warp computes its 16 x 16 scores as two m16n8
// accumulators (mma.sync m16n8k8 TF32, the cross terms of the split in
// accumulators of their own, or m16n8k16 bf16), the online softmax in
// registers (a row's scores lie in the 4 threads of a quad: max and sum
// by shuffles in a fixed order), rescales its 16 x 8 NV output
// accumulator and adds p v.  mma.sync (not wgmma, whose TF32 form takes
// only K-major operands from shared memory, so p v would need v
// transposed and p split into shared memory) loads its fragments from any
// layout, and this kernel uses that freedom: the depth order inside one
// MMA does not change its sum, so a thread's two TF32 k-slots t and t + 4
// hold the neighbouring depths 2t and 2t + 1 (one 8-byte load of q or k;
// for bf16 the four depths 4t..4t+3), and in p v the two keys 2t, 2t + 1
// that the score accumulator already gives each thread: p needs no
// shuffle, and v's two values come from rows 2t and 2t + 1 (bf16 v by
// ldmatrix.trans).  No atomics: a launch repeats bitwise.  exp2f (the
// accurate one, never --use_fast_math) with log2(e) folded into the
// scale.  The epilogue divides by max(l, 1e-30), rounds to T (nearest
// even) and stores the rows below Sq.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;   // the Pallas kernel's NEG
constexpr int kBq = 64;          // q rows per block: 4 row groups of 16
constexpr int kBk = 32;          // keys per tile: 2 halves of 16
constexpr int kThreads = 256;    // 8 warps: a row group and a key half each
constexpr int kStages = 2;       // k / v ring
constexpr int kMaxD = 256;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// whether query position qp may attend key position kp
__device__ __forceinline__ bool attend(int qp, int kp, int Sk, int causal,
                                       int window) {
  bool ok = kp < Sk;
  if (causal) ok = ok && kp <= qp;
  if (window) ok = ok && kp > qp - window;
  return ok;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global memory into shared memory, or 16 zero bytes when
// !valid (nothing is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + (about 2^-22 |x|), hi and lo TF32 (float32 bit patterns
// whose low 13 bits are zero)
__device__ __forceinline__ void split_tf32(uint32_t xbits, uint32_t& hi,
                                           uint32_t& lo) {
  const float x = __uint_as_float(xbits);
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// the pair (a, b) as bf16 hi and lo halves: a = hi.x + lo.x + ..., the
// lower k slot in the low half
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - __low2float(h),
                                                 b - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// d (16 x 8) += a (16 x 8) b (8 x 8), TF32 in, float32 sums.  Thread
// (g = lane / 4, t = lane % 4) holds a = {(g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4)}, b = {(t, g), (t + 4, g)} and d = {(g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1)} (row, column).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (16 x 8) += a (16 x 16) b (16 x 8), bf16 in, float32 sums: as
// mma_tf32 with each register a pair of neighbouring k slots, a = {(g,
// 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..)}, b = {(2t.., g),
// (2t + 8.., g)}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four transposed 8 x 8 bf16 matrices: lane i addresses row i % 8 of
// matrix i / 8
__device__ __forceinline__ void ldsm_x4_t(const void* p, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p)));
}

// the shared-memory geometry: q / k rows of the depth padded to 32 bytes
// plus 32, v rows of NV n8 tiles plus 16 bytes; after the k loop the same
// bytes hold the partial results of the warps that took the second half
// of each k tile
template <typename T, int NV>
struct Geometry {
  int dbytes, ldq, ldv;
  __host__ __device__ explicit Geometry(int D) {
    dbytes = (D * static_cast<int>(sizeof(T)) + 31) / 32 * 32;
    ldq = dbytes + 32;
    ldv = NV * 8 * static_cast<int>(sizeof(T)) + 16;
  }
  __host__ __device__ int tiles() const {
    return kBq * ldq + kStages * kBk * (ldq + ldv);
  }
  __host__ __device__ static int merge() {
    return static_cast<int>(sizeof(float)) * (4 * NV + 4) * kThreads / 2;
  }
  __host__ __device__ int bytes() const {
    return tiles() > merge() ? tiles() : merge();
  }
};

// rows [row0, row0 + nrows) of a (rows, cols) row-major matrix into
// shared memory at dst with row stride ld bytes; rows at or past `rows`
// as zeros.  vec: 16-byte cp.async (cols * sizeof(T) a multiple of 16 and
// src 16-byte aligned), else plain loads.
template <typename T>
__device__ __forceinline__ void load_rows(uint8_t* dst, int ld,
                                          const T* src, int row0, int nrows,
                                          int rows, int cols, int vec) {
  if (vec) {
    const int chunks = cols * static_cast<int>(sizeof(T)) / 16;
    for (int i = threadIdx.x; i < nrows * chunks; i += kThreads) {
      const int r = i / chunks, c = i - r * chunks;
      const bool ok = row0 + r < rows;
      const uint8_t* s = reinterpret_cast<const uint8_t*>(src) +
          (ok ? (static_cast<size_t>(row0 + r) * cols * sizeof(T) + 16 * c)
              : 0);
      cp_async16(dst + r * ld + 16 * c, s, ok);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      T x = from_f32<T>(0.f);
      if (row0 + r < rows) x = src[static_cast<size_t>(row0 + r) * cols + c];
      reinterpret_cast<T*>(dst + r * ld)[c] = x;
    }
  }
}

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int D, int Dv, float scale_log2, int causal, int window,
                 int vec_qk, int vec_v) {
  constexpr bool kF32 = sizeof(T) == 4;
  extern __shared__ __align__(16) uint8_t smem[];
  const Geometry<T, NV> geo(D);
  const int ldq = geo.ldq, ldv = geo.ldv;
  uint8_t* qs = smem;                          // [kBq][ldq]
  uint8_t* ks = qs + kBq * ldq;                // [kStages][kBk][ldq]
  uint8_t* vs = ks + kStages * kBk * ldq;      // [kStages][kBk][ldv]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int half = warp / 4;                   // which 16 keys of a tile
  const int nqt = (Sq + kBq - 1) / kBq;
  const int q0 = (nqt - 1 - static_cast<int>(blockIdx.x)) * kBq;
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * Sq * D;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * Dv;
  T* ob = o + bh * Sq * Dv;

  // zeros everywhere first: the padding of D and Dv stays zero
  for (int i = 16 * tid; i < geo.tiles(); i += 16 * kThreads)
    *reinterpret_cast<uint4*>(smem + i) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // the k tiles that hold a key some row of this q tile may attend
  const int qlast = min(q0 + kBq, Sq) - 1;
  const int kbeg = window ? max(0, q0 - window + 1) : 0;
  const int kend = causal ? min(Sk, qlast + 1) : Sk;
  const int kt0 = kbeg / kBk, kt1 = (kend + kBk - 1) / kBk;

  load_rows<T>(qs, ldq, qb, q0, kBq, Sq, D, vec_qk);
  if (kt0 < kt1) {
    load_rows<T>(ks, ldq, kb, kt0 * kBk, kBk, Sk, D, vec_qk);
    load_rows<T>(vs, ldv, vb, kt0 * kBk, kBk, Sk, Dv, vec_v);
  }
  cp_async_commit();

  float acc[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // running max (in log2 units) and denominator of this thread's rows
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  const int qa = q0 + 16 * (warp % 4);    // the warp's first row
  const int qp0 = qa + g, qp1 = qp0 + 8;  // this thread's two rows
  const uint8_t* qr = qs + (16 * (warp % 4) + g) * ldq + 8 * t;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) % kStages;
    if (kt + 1 < kt1) {
      const int nx = (kt + 1 - kt0) % kStages;
      load_rows<T>(ks + nx * kBk * ldq, ldq, kb, (kt + 1) * kBk, kBk, Sk, D,
                   vec_qk);
      load_rows<T>(vs + nx * kBk * ldv, ldv, vb, (kt + 1) * kBk, kBk, Sk, Dv,
                   vec_v);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();  // tile kt (and the q tile) have landed for all

    const int k0 = kt * kBk + 16 * half;  // this warp's 16 keys
    // this warp's rows against its keys: no pair kept, or every pair
    const bool none = qa >= Sq || k0 >= Sk || (causal && k0 > qa + 15) ||
                      (window && k0 + 15 <= qa - window);
    const bool full = k0 + 16 <= Sk && (!causal || k0 + 15 <= qa) &&
                      (!window || k0 > qa + 15 - window);
    if (!none) {
      const uint8_t* kr = ks + st * kBk * ldq + (16 * half + g) * ldq + 8 * t;
      // s: a_hi b_hi; c and c2, the split's cross terms, each its own
      // chain of MMAs
      float s[2][4], c[2][4], c2[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = c[j][e] = c2[j][e] = 0.f;
#pragma unroll 4
      for (int off = 0; off < geo.dbytes; off += 32) {
        const uint2 x0 = *reinterpret_cast<const uint2*>(qr + off);
        const uint2 x1 = *reinterpret_cast<const uint2*>(qr + 8 * ldq + off);
        const uint32_t a[4] = {x0.x, x1.x, x0.y, x1.y};
        if constexpr (kF32) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint2 y =
                *reinterpret_cast<const uint2*>(kr + 8 * j * ldq + off);
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(y.x, bh0, bl0);
            split_tf32(y.y, bh1, bl1);
            mma_tf32(s[j], ah, bh0, bh1);
            mma_tf32(c[j], ah, bl0, bl1);
            mma_tf32(c2[j], al, bh0, bh1);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint2 y =
                *reinterpret_cast<const uint2*>(kr + 8 * j * ldq + off);
            mma_bf16(s[j], a, y.x, y.y);
          }
        }
      }

      // scale and mask: element e of tile j is row e < 2 ? qp0 : qp1, key
      // k0 + 8 j + 2 t + e % 2
      uint32_t kept = 0xffu;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = (s[j][e] + (c[j][e] + c2[j][e])) * scale_log2;
          if (!full && !attend(e < 2 ? qp0 : qp1, k0 + 8 * j + 2 * t + e % 2,
                               Sk, causal, window)) {
            x = kNeg;
            kept &= ~(1u << (4 * j + e));
          }
          s[j][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = (kept >> (4 * j + e)) & 1u
                              ? exp2f(s[j][e] - (e < 2 ? mx0 : mx1)) : 0.f;
          s[j][e] = p;
          if (e < 2) sum0 += p;
          else sum1 += p;
        }
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
      const float al0 = exp2f(m0 - mx0), al1 = exp2f(m1 - mx1);
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
      m0 = mx0;
      m1 = mx1;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        acc[n][0] *= al0; acc[n][1] *= al0; acc[n][2] *= al1; acc[n][3] *= al1;
      }

      // o += p v over the warp's 16 keys
      const uint8_t* vt = vs + st * kBk * ldv + 16 * half * ldv;
      if constexpr (kF32) {
        // k step j is score tile j: k slot t holds key 8 j + 2 t, slot
        // t + 4 key 8 j + 2 t + 1
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t pa[4] = {__float_as_uint(s[j][0]),
                                  __float_as_uint(s[j][2]),
                                  __float_as_uint(s[j][1]),
                                  __float_as_uint(s[j][3])};
          uint32_t ph[4], pl[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(pa[i], ph[i], pl[i]);
          const float* v0 = reinterpret_cast<const float*>(
              vt + (8 * j + 2 * t) * ldv) + g;
          const float* v1 = reinterpret_cast<const float*>(
              vt + (8 * j + 2 * t + 1) * ldv) + g;
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(__float_as_uint(v0[8 * n]), bh0, bl0);
            split_tf32(__float_as_uint(v1[8 * n]), bh1, bl1);
            mma_tf32(acc[n], ph, bh0, bh1);
            mma_tf32(acc[n], ph, bl0, bl1);
            mma_tf32(acc[n], pl, bh0, bh1);
          }
        }
      } else {
        // one k step: score tiles 0 and 1 (keys 2 t.., 8 + 2 t..), the
        // accumulator layout of the scores; v's fragments by
        // ldmatrix.trans, two n8 tiles a load
        const int mat = lane / 8, r = lane % 8;
        uint32_t ph[4], pl[4];
        split_bf16x2(s[0][0], s[0][1], ph[0], pl[0]);
        split_bf16x2(s[0][2], s[0][3], ph[1], pl[1]);
        split_bf16x2(s[1][0], s[1][1], ph[2], pl[2]);
        split_bf16x2(s[1][2], s[1][3], ph[3], pl[3]);
        const uint8_t* vrow = vt + (8 * (mat % 2) + r) * ldv + 16 * (mat / 2);
#pragma unroll
        for (int n = 0; n < NV; n += 2) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_t(vrow + 16 * n, b0, b1, b2, b3);
          mma_bf16(acc[n], ph, b0, b1);
          mma_bf16(acc[n], pl, b0, b1);
          mma_bf16(acc[n + 1], ph, b2, b3);
          mma_bf16(acc[n + 1], pl, b2, b3);
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before its refill
  }

  // the second half's warps hand (m, l, o) to the first half's: o = o_a
  // 2^(m_a - m) + o_b 2^(m_b - m), l likewise, m = max(m_a, m_b)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // no copy is left in flight over the bytes reused
  float* part = reinterpret_cast<float*>(smem);
  const int slot = tid % (kThreads / 2);
  constexpr int kPart = kThreads / 2;
  if (half) {
    part[0 * kPart + slot] = m0;
    part[1 * kPart + slot] = m1;
    part[2 * kPart + slot] = l0;
    part[3 * kPart + slot] = l1;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(4 + 4 * n + e) * kPart + slot] = acc[n][e];
  }
  __syncthreads();
  if (half) return;
  const float mb0 = part[0 * kPart + slot], mb1 = part[1 * kPart + slot];
  const float m0n = fmaxf(m0, mb0), m1n = fmaxf(m1, mb1);
  const float a0 = exp2f(m0 - m0n), b0 = exp2f(mb0 - m0n);
  const float a1 = exp2f(m1 - m1n), b1 = exp2f(mb1 - m1n);
  l0 = l0 * a0 + part[2 * kPart + slot] * b0;
  l1 = l1 * a1 + part[3 * kPart + slot] * b1;
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    const int col = 8 * n + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qp = e < 2 ? qp0 : qp1, cc = col + e % 2;
      const float x = acc[n][e] * (e < 2 ? a0 : a1) +
                      part[(4 + 4 * n + e) * kPart + slot] * (e < 2 ? b0 : b1);
      if (qp < Sq && cc < Dv)
        ob[static_cast<size_t>(qp) * Dv + cc] =
            from_f32<T>(x / (e < 2 ? den0 : den1));
    }
  }
}

template <typename T, int NV>
cudaError_t launch_nv(const void* q, const void* k, const void* v, void* o,
                      int BH, int Sq, int Sk, int D, int Dv, float scale,
                      int causal, int window, cudaStream_t st) {
  const size_t smem = Geometry<T, NV>(D).bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_qk = (D * sizeof(T)) % 16 == 0 && aligned(q) && aligned(k);
  const int vec_v = (Dv * sizeof(T)) % 16 == 0 && aligned(v);
  const dim3 grid((Sq + kBq - 1) / kBq, BH);
  flash_fwd_kernel<T, NV><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, D, Dv,
      scale * 1.4426950408889634f, causal, window, vec_qk, vec_v);
  return cudaGetLastError();
}

// NV, the output's n8 tiles: 4 for Dv <= 32 (the D = 32 case of the
// entry point), else 32 (two instantiations a type keep the build short;
// a Dv between pays for the zero columns)
template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int Sq, int Sk, int D, int Dv, float scale,
                   int causal, int window, cudaStream_t st) {
  if (Dv <= 32)
    return launch_nv<T, 4>(q, k, v, o, BH, Sq, Sk, D, Dv, scale, causal,
                           window, st);
  return launch_nv<T, 32>(q, k, v, o, BH, Sq, Sk, D, Dv, scale, causal,
                          window, st);
}

}  // namespace

extern "C" {

// q (BH, Sq, D), k (BH, Sk, D), v (BH, Sk, Dv), o (BH, Sq, Dv),
// contiguous, all float32 (bf16 = 0) or all bfloat16 (bf16 = 1); D and
// Dv in [1, 256].  window = 0 means no window.  Returns the cudaError_t of
// the launch.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int BH, int Sq, int Sk, int D, int Dv,
                           float scale, int causal, int window, int bf16,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > kMaxD || Dv < 1 || Dv > kMaxD)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return (int)launch<__nv_bfloat16>(q, k, v, o, BH, Sq, Sk, D, Dv, scale,
                                      causal, window, st);
  return (int)launch<float>(q, k, v, o, BH, Sq, Sk, D, Dv, scale, causal,
                            window, st);
}

}  // extern "C"

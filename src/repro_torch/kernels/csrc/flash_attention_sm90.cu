// flash_attention_sm90 — the forward pass of causal / sliding-window
// softmax attention for Hopper: bf16 wgmma on TMA-fed tiles, with the
// softmax weights kept in float32 through a hi/lo split.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// _flash_kernel (:27, wrapper flash_attention_fwd :70) for bf16 q, k, v
// with D == Dv in {64, 128, 256}; csrc/flash_attention.cu takes every other
// type and head dim.  The function is the Pallas kernel's, as
// flash_attention_plain states it: layout (B, H, S, D); the causal mask is
// left-aligned, k <= q, also when Sq != Sk; the window keeps k > q -
// window; a row that no key may attend gives 0 (max(l, 1e-30)); any Sq and
// Sk, the ragged tiles masked.  Per row, with s_j = scale q.k_j on the kept
// pairs:  o = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-30).
//
// Bound: operations.  At the recurrentgemma-9b local-attention shape
// (B = 4, 16 heads, S = 3072, D = 256, window 2048) the 268.5 M kept pairs
// need 4 D float ops each: 274.9 GFLOP, 278 us at the 989 TFLOP/s bf16
// tensor-core peak (q, k, v and o are 403 MB, 120 us at 3.35 TB/s).
//
// Precision.  The Pallas kernel upcasts q, k, v to float32 and forms p and
// p v in float32.  On the tensor cores q k^T is exact per product (bf16 x
// bf16 fits float32) and sums in float32.  p must enter p v as bf16, and p
// rounded to bf16 misses the check the port holds this kernel to
// (flash_check: 2^-16 of the sums over absolute values plus 2^-7 |o|) by
// about 10x.  So p = p_hi + p_lo, p_hi = bf16_rn(p), p_lo = bf16_rn(p -
// p_hi) (the subtraction is exact in float32), and o += p_hi v + p_lo v:
// two bf16 products into one float32 accumulator, as close to float32 p as
// the check can see.  The tensor-core work is then 412 GFLOP at that shape
// (q k^T 137.4, p v twice 137.4): 417 us at the peak.  l sums the unsplit
// float32 p.  exp2f (accurate, never --use_fast_math) with log2(e) folded
// into the scale.
//
// Design.  One block per (b h, 128-row q tile), the q tiles heaviest first
// (the causal edge makes the last tiles the longest).  256 threads: two
// warpgroups own 64 q rows each, and thread 0 also issues every TMA load.
// (A producer warp or warpgroup beside them costs registers the consumers
// need: at D = 256 a consumer thread holds the 128-float O accumulator,
// the 32-float score tile and the 32 registers of p_hi and p_lo.  With a
// producer warpgroup and setmaxnreg 240 for the consumers (384 threads)
// ptxas kept the consumer code within 184 registers, and with a producer
// warp (288 threads) within 224; both spilled and serialized every wgmma.
// With 256 threads it takes 206 and does neither.)  Shared memory: the q
// tile (64 KB at D = 256) and a 2-stage ring of k and v tiles of 64 keys
// (2 x (32 + 32) KB), all 128-byte swizzled, D/64 panels of 64 columns
// each (a box of the 128-byte swizzle is 128 bytes wide), 193 KB in all.
// TMA reads them through 3-D tensor maps over (B H, S, D), so rows past S
// arrive as zeros and never from the next head; mbarriers count the bytes (full) and the 256 threads that
// are done with a stage (empty).  Thread 0 refills the stage of tile i - 1
// at the top of iteration i, once both warpgroups released it, so one
// warpgroup runs at most a tile ahead of the other and each one's softmax
// overlaps the other's wgmma.  Per k tile a warpgroup computes S = Q K^T
// as D/16 wgmma.m64n64k16 (A and B from shared memory, float32
// accumulators in registers), the online softmax in registers (each row's
// 64 scores lie in the 4 threads of a quad: max and sum by shuffles in a
// fixed order), rescales the 64 x D accumulator O (D/2 registers a
// thread), and adds p_hi V + p_lo V as wgmma.m64nDk16 with A from
// registers (the accumulator layout of S is the A-fragment layout, so the
// conversion needs no shuffle) and V read MN-major (the transpose bit).
// Masks are applied only on tiles that the causal edge, the window or Sk
// cut; tiles masked for all rows of the block are never loaded, and a
// warpgroup skips the arithmetic of a tile masked for all its rows.  No
// atomics: a launch repeats bitwise.  The epilogue divides by max(l,
// 1e-30), rounds to bf16 (nearest even) and stores the rows below Sq.

#include "sm90.cuh"

namespace {

using sm90::smem_u32;

constexpr float kNeg = -1e30f;  // the Pallas kernel's NEG
constexpr int kBq = 128;        // q rows per block
constexpr int kBk = 64;         // keys per tile
constexpr int kStages = 2;      // k/v ring
constexpr int kThreads = 256;   // two warpgroups
static_assert(kBk == 64, "S is one wgmma.m64n64k16 per step of 16, and "
              "a 32-bit mask holds a thread's kept scores");
// V's descriptor (MN-major, 128-byte swizzle): the leading byte offset is
// the stride of its 64-column panels, the stride byte offset that of its
// 8-key atoms (the other way round from a K-major operand)
constexpr uint32_t kVLbo = kBk * 128, kVSbo = 1024;

template <int D>
struct Layout {
  static constexpr int kPanels = D / 64;     // 64-column panels a row
  static constexpr int kQPanel = kBq * 128;  // bytes of one q panel
  static constexpr int kKPanel = kBk * 128;  // bytes of one k / v panel
  static constexpr int kQBytes = kPanels * kQPanel;
  static constexpr int kKBytes = kPanels * kKPanel;  // one k (or v) tile
  static constexpr int kK = kQBytes;                 // the k stages
  static constexpr int kV = kK + kStages * kKBytes;  // the v stages
  static constexpr int kBytes = kV + kStages * kKBytes;
  // 1024 bytes of slack to align the 128-byte-swizzled tiles to 1024
  static constexpr size_t kSmem = kBytes + 1024;
};

// whether query position qp may attend key position kp
__device__ __forceinline__ bool attend(int qp, int kp, int Sk, int causal,
                                       int window) {
  bool ok = kp < Sk;
  if (causal) ok = ok && kp <= qp;
  if (window) ok = ok && kp > qp - window;
  return ok;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ o, int BH, int Sq, int Sk,
                  float scale_log2, int causal, int window) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  // full q; full k and v per stage; empty per stage
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + L::kK, sv = base + L::kV;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_k = smem_u32(&bars[1]);               // + 8 s
  const uint32_t bar_v = smem_u32(&bars[1 + kStages]);     // + 8 s
  const uint32_t bar_e = smem_u32(&bars[1 + 2 * kStages]); // + 8 s

  const int nqt = (Sq + kBq - 1) / kBq;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int q0 = qt * kBq;

  // the k tiles that hold a key some row of this q tile may attend
  const int qlast = min(q0 + kBq, Sq) - 1;
  const int kbeg = window ? max(0, q0 - window + 1) : 0;
  const int kend = causal ? min(Sk, qlast + 1) : Sk;
  const int kt0 = kbeg / kBk, kt1 = (kend + kBk - 1) / kBk;
  const int nt = kt1 - kt0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(bar_k + 8 * s, 1);
      sm90::mbar_init(bar_v + 8 * s, 1);
      sm90::mbar_init(bar_e + 8 * s, kThreads);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // thread 0 issues every TMA load: tile i of the ring into stage i %
  // kStages, k and v on their own barriers
  auto load_tile = [&](int i) {
    const int s = i % kStages, k0 = (kt0 + i) * kBk;
    sm90::mbar_expect_tx(bar_k + 8 * s, L::kKBytes);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
      sm90::tma_load_3d(sk + s * L::kKBytes + p * L::kKPanel, &tk,
                        bar_k + 8 * s, 64 * p, k0, bh);
    sm90::mbar_expect_tx(bar_v + 8 * s, L::kKBytes);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
      sm90::tma_load_3d(sv + s * L::kKBytes + p * L::kKPanel, &tv,
                        bar_v + 8 * s, 64 * p, k0, bh);
  };
  if (threadIdx.x == 0) {
    sm90::mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
      sm90::tma_load_3d(sq + p * L::kQPanel, &tq, bar_q, 64 * p, q0, bh);
    for (int i = 0; i < min(nt, kStages); ++i) load_tile(i);
  }

  // warpgroup wg owns q rows q0 + 64 wg .. + 63; wg is made warp-uniform to
  // the compiler (a broadcast), so that the descriptor arithmetic stays in
  // uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  {
    const int t = threadIdx.x % 128, lane = t % 32;
    const int r0 = 64 * wg + 16 * (t / 32) + lane / 4;  // and r0 + 8
    const int qp0 = q0 + r0, qp1 = qp0 + 8;
    const int ra = q0 + 64 * wg;                 // this warpgroup's rows
    const int rb = min(q0 + 64 * wg + 63, Sq - 1);  // below Sq

    // O: acc[4 j + 2 h + e] is row r0 + 8 h, column 8 j + 2 (lane % 4) + e
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
    const uint32_t qa = sq + wg * 64 * 128;  // this warpgroup's q rows

    sm90::mbar_wait(bar_q, 0);
    for (int i = 0; i < nt; ++i) {
      // refill the stage of tile i - 1 once both warpgroups are done with
      // it (so one warpgroup runs at most a tile ahead of the other)
      if (threadIdx.x == 0 && i >= 1 && i - 1 + kStages < nt) {
        sm90::mbar_wait(bar_e + 8 * ((i - 1) % kStages),
                        ((i - 1) / kStages) & 1);
        load_tile(i - 1 + kStages);
      }
      const int s = i % kStages;
      const uint32_t phase = (i / kStages) & 1;
      const int k0 = (kt0 + i) * kBk;
      const int kmax = min(k0 + kBk, Sk) - 1;
      // some pair of this warpgroup's rows and this tile is kept ...
      const bool any = rb >= ra && k0 < Sk && (!causal || k0 <= rb) &&
                       (!window || kmax > ra - window);
      // ... or every pair is
      const bool full = k0 + kBk <= Sk && (!causal || k0 + kBk - 1 <= ra) &&
                        (!window || k0 > rb - window);
      uint32_t phi[kBk / 4], plo[kBk / 4];

      sm90::mbar_wait(bar_k + 8 * s, phase);
      if (any) {
        // S = Q K^T over D / 16 steps of 16; a step's descriptors are the
        // base's plus its byte offset / 16 (the address field)
        float sc[kBk / 2];
#pragma unroll
        for (int j = 0; j < kBk / 2; ++j) sc[j] = 0.f;
        const uint64_t dq = sm90::desc_sw128(qa, 16, 1024);
        const uint64_t dk = sm90::desc_sw128(sk + s * L::kKBytes, 16, 1024);
        sm90::fence_regs(sc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int p = kk / 4, c = (kk % 4) * 32;
          sm90::wgmma_m64n64k16_ss(sc, dq + ((p * L::kQPanel + c) >> 4),
                                   dk + ((p * L::kKPanel + c) >> 4), kk > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_regs(sc);

        // online softmax in the log2 domain; sc[j] is row r0 + 8 ((j >> 1)
        // & 1), key k0 + 8 (j >> 2) + 2 (lane % 4) + (j & 1)
        uint32_t keep = 0xffffffffu;  // bit j: sc[j] is a kept pair
#pragma unroll
        for (int j = 0; j < kBk / 2; ++j) sc[j] *= scale_log2;
        if (!full) {
#pragma unroll
          for (int j = 0; j < kBk / 2; ++j) {
            const int qp = (j & 2) ? qp1 : qp0;
            const int kp = k0 + 8 * (j >> 2) + 2 * (lane % 4) + (j & 1);
            if (!attend(qp, kp, Sk, causal, window)) {
              sc[j] = kNeg;
              keep &= ~(1u << j);
            }
          }
        }
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < kBk / 2; ++j) {
          if (j & 2)
            mx1 = fmaxf(mx1, sc[j]);
          else
            mx0 = fmaxf(mx0, sc[j]);
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float al0 = exp2f(m0 - mx0), al1 = exp2f(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int j = 0; j < kBk / 2; j += 2) {
          const float mx = (j & 2) ? mx1 : mx0;
          const float pa = (keep >> j) & 1 ? exp2f(sc[j] - mx) : 0.f;
          const float pb =
              (keep >> (j + 1)) & 1 ? exp2f(sc[j + 1] - mx) : 0.f;
          if (j & 2)
            sum1 += pa + pb;
          else
            sum0 += pa + pb;
          // p = p_hi + p_lo, each rounded to bf16 (nearest even)
          const __nv_bfloat162 hi = __floats2bfloat162_rn(pa, pb);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(
              pa - __low2float(hi), pb - __high2float(hi));
          phi[j / 2] = sm90::bf16x2_bits(hi);
          plo[j / 2] = sm90::bf16x2_bits(lo);
        }
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
        l0 = l0 * al0 + sum0;
        l1 = l1 * al1 + sum1;
#pragma unroll
        for (int j = 0; j < D / 2; ++j) acc[j] *= (j & 2) ? al1 : al0;
      }

      sm90::mbar_wait(bar_v + 8 * s, phase);
      if (any) {
        // O += P_hi V + P_lo V over the tile's steps of 16 keys, one
        // wgmma.m64nDk16 each: V's 16 keys are two 8-row atoms (kVSbo
        // apart) and its D columns D / 64 panels (kVLbo apart)
        const uint64_t dv =
            sm90::desc_sw128(sv + s * L::kKBytes, kVLbo, kVSbo);
        sm90::fence_regs(acc);
        sm90::fence_regs(phi);
        sm90::fence_regs(plo);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBk / 16; ++kk) {
          sm90::wgmma_m64k16_rs_tb<D>(acc, phi + 4 * kk, dv + kk * 128);
          sm90::wgmma_m64k16_rs_tb<D>(acc, plo + 4 * kk, dv + kk * 128);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_regs(acc);
        sm90::fence_regs(phi);
        sm90::fence_regs(plo);
      }
      sm90::mbar_arrive(bar_e + 8 * s);
    }

    // epilogue: o = acc / max(l, 1e-30) in bf16, rows below Sq.  One
    // division a row, then products (a float32 ulp beside bf16's 2^-8).
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    __nv_bfloat16* ob = o + static_cast<size_t>(bh) * Sq * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (qp0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)qp0 * D + col) =
            __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (qp1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)qp1 * D + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] * inv1,
                                  acc[4 * j + 3] * inv1);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int Sq, int Sk, float scale, int causal,
                   int window, cudaStream_t st) {
  using L = Layout<D>;
  CUtensorMap tq, tk, tv;
  if (!sm90::encode_bf16_panels(&tq, q, BH, Sq, D, kBq) ||
      !sm90::encode_bf16_panels(&tk, k, BH, Sk, D, kBk) ||
      !sm90::encode_bf16_panels(&tv, v, BH, Sk, D, kBk))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kSmem);
  if (err != cudaSuccess) return err;
  const float scale_log2 =
      static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  const unsigned nqt = (Sq + kBq - 1) / kBq;
  flash_sm90_kernel<D><<<nqt * BH, kThreads, L::kSmem, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), BH, Sq, Sk, scale_log2,
      causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (BH, Sq, D), k (BH, Sk, D), v (BH, Sk, D), o (BH, Sq, D), contiguous
// bfloat16 with 16-byte aligned bases; D in {64, 128, 256}; window = 0
// means no window.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for another D or a tensor map that cannot be
// encoded).
int flash_attention_sm90_launch(const void* q, const void* k, const void* v,
                                void* o, int BH, int Sq, int Sk, int D,
                                float scale, int causal, int window,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch<64>(q, k, v, o, BH, Sq, Sk, scale, causal, window,
                             st);
    case 128:
      return (int)launch<128>(q, k, v, o, BH, Sq, Sk, scale, causal, window,
                              st);
    case 256:
      return (int)launch<256>(q, k, v, o, BH, Sq, Sk, scale, causal, window,
                              st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

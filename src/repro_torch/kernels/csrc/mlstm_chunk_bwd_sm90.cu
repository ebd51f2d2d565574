// mlstm_chunk_bwd_sm90 — the gradient of the chunkwise mLSTM forward from a
// zero state (csrc/mlstm_chunk_bwd.cu's function) for Hopper: bf16 wgmma on
// TMA-fed 128-byte-swizzled tiles, every float32 operand split hi/lo.
//
// Replaces no TPU kernel: the reference trains by jax.value_and_grad
// through the oracle repro/kernels/ref.py: mlstm_chunkwise.  Taken for bf16
// q, k, v with Dq and Dv multiples of 64 up to 512 and a chunk L that is a
// multiple of 64 (kernels/mlstm_chunk.py: bwd_route); csrc/mlstm_chunk_bwd.cu
// takes float32 and every other shape.  The math is
// mlstm_chunkwise_bwd_plain's and csrc/mlstm_chunk_bwd.cu's: per (b, h) and
// chunk c, S_ts = q_t.k_s and dP_ts = dh_t.v_s (s <= t), D_ts = exp(g_s -
// M_t), w_t = exp(m_c - M_t), wv_s = exp(g_s - M_L), scale = 1/sqrt(Dq):
//   den_t = w_t scale q_t.n_c + sum_s D_ts scale S_ts,
//   dh_t.num_t = w_t scale q_t.(C_c dh_t) + sum_s D_ts scale S_ts dP_ts,
//   inv_t = 1 / max(|den_t|, e^{-m_t}), dd_t (den's gradient, 0 at the clamp),
//   Wk_ts = D_ts scale (dP_ts inv_t + dd_t),  Wv_ts = D_ts scale S_ts inv_t,
//   dq_t = sum_s Wk_ts k_s + w_t scale (inv_t (C_c dh_t) + dd_t n_c),
//   dk_s = sum_t Wk_ts q_t + wv_s (G_{c+1} v_s + dn_{c+1}),
//   dv_s = sum_t Wv_ts dh_t + wv_s G_{c+1}^T k_s,
//   G_c = decay_c G_{c+1} + sum_t (w_t scale inv_t) q_t dh_t^T (dn: dd_t),
//   dlog_i_s = k_s.dk_s, dlog_f_r = sum_{t >= r} (q_t.dq_t - k_t.dk_t).
// The row scalars are hoisted out of the products: C_c delta_t = inv_t
// (C_c dh_t), and G's update weights q_t by one scalar a row.
//
// Bound: operations.  At the xlstm-350m train shape (B = 4, H = 4, S =
// 1024, Dq = Dv = 512, L = 256) the function needs 43 GFLOP
// (chip_smoke.py: mlstm_bwd_flops), 43 us at the bf16 tensor-core peak;
// its 118 MB of inputs and outputs take 35 us.
//
// Precision.  q, k, v and dh are bf16 and enter the tensor cores exactly.
// Every float32 operand of a product (the chunk-start states C_c, the
// state gradients G, the weights Wk and Wv, a_t q_t in G's update) is split
// x = x_hi + x_lo (x_hi = bf16_rn(x), x_lo = bf16_rn(x - x_hi), |x - x_hi -
// x_lo| <= 2^-18 |x|) and enters as two bf16 products into one float32
// accumulator, the forward's design (csrc/mlstm_chunk_sm90.cu).  S and dP
// are formed once (exact products, float32 sums) and both weight sets
// derive from them.  expf is the accurate one (never --use_fast_math).
//
// Design: twelve launches on the stream.
//   1. bwd90_gates_kernel (a warp a (b, h), scans over the lanes): g, M_t,
//      m_t, M_L, the chunk m chain and wv_s, as the forward computes them.
//   2. bwd90_walk_kernel<NV, false> (fstates): the stabilized chunk-start
//      states C_c, n_c in the wgmma accumulators of two warpgroups, one
//      block per (b h, 128 rows of Dq, NV columns of Dv) walking the chunks
//      in order: before chunk c, C_c out as bf16 hi and lo and n_c in
//      float32; then C <- decay C + (wv k)^T v, the csrc/mlstm_chunk_sm90.cu
//      states kernel's loop (k^T by ldmatrix.trans, scaled and split in
//      registers, v MN-major through a 4-slot TMA ring).
//   3-5. bwd90_abt_kernel (S = q k^T, dP = dh v^T, Y = dh C_c^T with C_c hi
//      and lo): out = A B^T over 64-deep steps, both operands K-major
//      tiles by TMA, 128 rows x NT columns a block (two warpgroups), a
//      2-slot ring; tiles wholly above the diagonal are skipped.
//   6. bwd90_rows_kernel (a warp a row): den, dh.num from S, dP, q.n_c and
//      q.Y; inv, dd, and the dstates walk's row weights.
//   7. bwd90_weights_kernel (a block a 64 x 64 tile): Wk and Wv from S and
//      dP, split hi/lo in bf16: Wk row-major (for dq), Wk^T and Wv^T (for
//      dk and dv) through a shared-memory transpose; zero above the
//      diagonal and past the sequence.
//   8. bwd90_apply_kernel<0> (dq): Wk_hi k + Wk_lo k (k MN-major), then the
//      carry from Y and n_c; q.dq per row and column tile.
//   9. bwd90_walk_kernel<NV, true> (dstates): G and dn in the accumulators
//      over the chunks in reverse (q scaled by w scale inv, dh MN-major):
//      before chunk c, G_{c+1} out as bf16 hi and lo and dn_{c+1}.
//   10, 11. bwd90_apply_kernel<1> (dk), <2> (dv): the carried gradient first
//      (v G^T with G K-major, or k G with G MN-major, hi and lo), scaled by
//      wv_s, then Wk^T q or Wv^T dh (hi and lo; q, dh MN-major); k.dk per
//      row and column tile.
//   12. bwd90_dgates_kernel (a warp a (b, h)): q.dq and k.dk summed over
//      the column tiles in order, and dlog_f's suffix sums.
// Every output element is written by one thread in a fixed order: no
// atomics, so a launch repeats bitwise.

#include "sm90.cuh"

#include <math.h>

namespace {

using sm90::smem_u32;

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;       // two warpgroups
constexpr int kPanel = 64 * 128;    // 64 rows of 64 bf16 columns
constexpr int kTile = 128 * 128;    // 128 rows of 64 bf16 columns
// descriptor of an MN-major operand: the leading byte offset is the
// stride of its 64-column panels, the stride byte offset that of its
// 8-row atoms
constexpr uint32_t kMnLbo = kPanel, kMnSbo = 1024;
constexpr int kStages = 2;          // the GEMM kernels' ring
constexpr int kWStages = 4;         // the walks' ring

struct Dims {
  int BH, S, Dq, Dv, L, nC, Sp;
  float scale;
};

__device__ __forceinline__ int chunk_len(const Dims& d, int c) {
  return min(d.L, d.S - c * d.L);
}

// a 4 x 4 exchange within a quad (csrc/mlstm_chunk_sm90.cu's): lane c4
// holds v[j], its two columns of 8-column group j of a row; afterwards
// v[x] is lane x's pair of group c4
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int c4) {
  const bool o1 = c4 & 1, o2 = c4 & 2;
  uint32_t s0 = o1 ? v[0] : v[1], s1 = o1 ? v[2] : v[3];
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  if (o1) {
    v[0] = r0;
    v[2] = r1;
  } else {
    v[1] = r0;
    v[3] = r1;
  }
  s0 = o2 ? v[0] : v[2];
  s1 = o2 ? v[1] : v[3];
  r0 = __shfl_xor_sync(0xffffffffu, s0, 2);
  r1 = __shfl_xor_sync(0xffffffffu, s1, 2);
  if (o2) {
    v[0] = r0;
    v[1] = r1;
  } else {
    v[2] = r0;
    v[3] = r1;
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// 1. the stabilizer chain: one warp per (b, h), csrc/mlstm_chunk_sm90.cu's
// mlstm_gates_kernel with M_L and wv besides
// ---------------------------------------------------------------------------

__global__ void bwd90_gates_kernel(const float* __restrict__ log_f,
                                   const float* __restrict__ log_i,
                                   float* __restrict__ g,
                                   float* __restrict__ Mt,
                                   float* __restrict__ mt,
                                   float* __restrict__ ML,
                                   float* __restrict__ mchain,
                                   float* __restrict__ wv, Dims d) {
  const int bh = blockIdx.x, lane = threadIdx.x, L = d.L, nC = d.nC;
  const int per = (L + 31) / 32;          // consecutive positions per lane
  const float* lf = log_f + static_cast<size_t>(bh) * d.S;
  const float* li = log_i + static_cast<size_t>(bh) * d.S;
  const size_t row = static_cast<size_t>(bh) * d.Sp;
  const int owner = (L - 1) / per;        // lane holding position L - 1
  float m = kNeg;
  for (int c = 0; c < nC; ++c) {
    if (lane == 0) mchain[bh * (nC + 1) + c] = m;
    const int base = c * L;
    // lane sums of log_f (padding: f = 1), then an exclusive scan
    float s = 0.f;
    for (int i = 0; i < per; ++i) {
      const int t = lane * per + i, p = base + t;
      if (t < L && p < d.S) s += lf[p];
    }
    float incl = s;
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    // g (padding: i = 0), lane maxima, then an exclusive max-scan; g is
    // formed again below in the same order, so both passes agree bitwise
    float F = excl, gmax = -INFINITY;
    for (int i = 0; i < per; ++i) {
      const int t = lane * per + i, p = base + t;
      if (t < L) {
        F += p < d.S ? lf[p] : 0.f;
        gmax = fmaxf(gmax, (p < d.S ? li[p] : kNeg) - F);
      }
    }
    float imax = gmax;
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, imax, off);
      if (lane >= off) imax = fmaxf(imax, y);
    }
    float xmax = __shfl_up_sync(0xffffffffu, imax, 1);
    if (lane == 0) xmax = -INFINITY;
    // per position: g, Mt = max(m, cummax g), m_t = F + Mt
    F = excl;
    float run = fmaxf(m, xmax);
    for (int i = 0; i < per; ++i) {
      const int t = lane * per + i, p = base + t;
      if (t < L) {
        F += p < d.S ? lf[p] : 0.f;
        const float gi = (p < d.S ? li[p] : kNeg) - F;
        run = fmaxf(run, gi);
        g[row + base + t] = gi;
        Mt[row + base + t] = run;
        mt[row + base + t] = F + run;
      }
    }
    const float FL = __shfl_sync(0xffffffffu, F, owner);
    const float MLc = __shfl_sync(0xffffffffu, run, owner);
    if (lane == 0) ML[bh * nC + c] = MLc;
    // wv from the g this lane has just written
    for (int i = 0; i < per; ++i) {
      const int t = lane * per + i;
      if (t < L) wv[row + base + t] = expf(g[row + base + t] - MLc);
    }
    m = FL + MLc;
  }
  if (lane == 0) mchain[bh * (nC + 1) + nC] = m;
}

// ---------------------------------------------------------------------------
// 2, 9. the chunk-state walks: one block per (b h, 128 rows of Dq, NV
// columns of Dv), the state in two warpgroups' accumulators
// ---------------------------------------------------------------------------

constexpr int kWalkX = 2 * kPanel;  // an X slab: 64 positions x 128 d

template <int NV>
struct WalkLayout {
  static constexpr int kVP = NV / 64;                 // Y panels
  static constexpr int kSlot = kWalkX + kVP * kPanel;  // X and Y slabs
  // the ring, 1024 bytes of slack to align it, two chunks' a and b
  static size_t smem(int L) { return kWStages * kSlot + 1024 + 16 * L; }
};

// a walk's state out at slot `z` (b h nC + c): the accumulators (rows
// dr0, dr1 of Dq, columns dv0 + 8 j + 2 c4 + e) as bf16 hi and lo, one
// 16-byte store a lane, and (`with_n`) n in float32
template <int NV>
__device__ __forceinline__ void write_state(
    const float (&acc)[NV / 2], float n0, float n1, __nv_bfloat16* Shi,
    __nv_bfloat16* Slo, float* nvec, int z, int Dq, int Dv, int dr0,
    int dr1, int dv0, int c4, bool with_n) {
  const size_t cb0 = static_cast<size_t>(z) * Dq * Dv;
#pragma unroll
  for (int J = 0; J < NV / 32; ++J)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t vhi[4], vlo[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * J + jj;
        const float a = acc[4 * j + 2 * h], b = acc[4 * j + 2 * h + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            a - __low2float(hi), b - __high2float(hi));
        vhi[jj] = sm90::bf16x2_bits(hi);
        vlo[jj] = sm90::bf16x2_bits(lo);
      }
      quad_transpose(vhi, c4);
      quad_transpose(vlo, c4);
      const int r = h ? dr1 : dr0, col = dv0 + 8 * (4 * J + c4);
      if (r < Dq) {
        const size_t i = cb0 + static_cast<size_t>(r) * Dv + col;
        *reinterpret_cast<uint4*>(Shi + i) =
            make_uint4(vhi[0], vhi[1], vhi[2], vhi[3]);
        *reinterpret_cast<uint4*>(Slo + i) =
            make_uint4(vlo[0], vlo[1], vlo[2], vlo[3]);
      }
    }
  if (with_n && c4 == 0) {
    float* nrow = nvec + static_cast<size_t>(z) * Dq;
    if (dr0 < Dq) nrow[dr0] = n0;
    if (dr1 < Dq) nrow[dr1] = n1;
  }
}

// REV false (fstates): X = k, Y = v, a = b = wv, the chunks 0 .. nC-2 in
// order, state slot c = C_c before chunk c and slot nC-1 at the end.
// REV true (dstates): X = q, Y = dh, a = w scale inv, b = w scale dd, the
// chunks nC-1 .. 1 in reverse, slot c = G_{c+1} before chunk c and slot 0
// at the end.  Each processed chunk c: state <- decay_c state + sum over
// its positions of (a_t X_t) Y_t^T, n <- decay_c n + sum of b_t X_t.
template <int NV, bool REV>
__global__ void __launch_bounds__(kThreads, 1)
bwd90_walk_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap ty,
                  const float* __restrict__ ca, const float* __restrict__ cb,
                  const float* __restrict__ ML,
                  const float* __restrict__ mchain,
                  __nv_bfloat16* __restrict__ Shi,
                  __nv_bfloat16* __restrict__ Slo, float* __restrict__ nvec,
                  Dims d) {
  using Lt = WalkLayout<NV>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kWStages];  // full, empty

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar_f = smem_u32(&bars[0]);
  const uint32_t bar_e = smem_u32(&bars[kWStages]);
  // chunk j's a at coef[(j % 2) 2 L ..], its b L further
  float* coef = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                         kWStages * Lt::kSlot);

  const int Dq = d.Dq, Dv = d.Dv, L = d.L, nC = d.nC;
  const int nDq = (Dq + 127) / 128, nDv = Dv / NV;
  const int dvb = static_cast<int>(blockIdx.x % nDv);
  const int dqb = static_cast<int>(blockIdx.x / nDv) % nDq;
  const int bh = static_cast<int>(blockIdx.x / nDv) / nDq;
  const int dq0 = 128 * dqb, dv0 = NV * dvb;
  const int spc = L / 64, np = nC - 1, nslab = np * spc;

  auto chunk_of = [&](int j) { return REV ? nC - 1 - j : j; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      sm90::mbar_init(bar_f + 8 * s, 1);
      sm90::mbar_init(bar_e + 8 * s, kThreads);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // slab i (positions 64 (i % spc) .. of processed chunk i / spc) into
  // slot i % kWStages: X's two panels of this block's 128 rows of Dq, then
  // Y's NV / 64 panels
  auto load_slab = [&](int i) {
    const int s = i % kWStages;
    const uint32_t slot = base + s * Lt::kSlot, bar = bar_f + 8 * s;
    const int pos = chunk_of(i / spc) * L + 64 * (i % spc);
    sm90::mbar_expect_tx(bar, Lt::kSlot);
#pragma unroll
    for (int p = 0; p < 2 + Lt::kVP; ++p)
      sm90::tma_load_3d(slot + p * kPanel, p < 2 ? &tx : &ty, bar,
                        p < 2 ? dq0 + 64 * p : dv0 + 64 * (p - 2), pos, bh);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < min(nslab, kWStages); ++i) load_slab(i);

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x % 32, wi = (threadIdx.x % 128) / 32;
  const int c4 = lane % 4;
  // acc[4 j + 2 h + e] is the state's row dr[h] (of Dq), column dv0 + 8 j
  // + 2 c4 + e
  const int dr0 = dq0 + 64 * wg + 16 * wi + lane / 4, dr1 = dr0 + 8;
  // ldmatrix: lane i addresses row (position) 8 (i / 16) + i % 8 of a
  // 16-position step, 16-byte chunk 2 wi + (i / 8) % 2 of the panel
  const int lrow = ((lane >> 4) << 3) + (lane & 7);
  const int lchunk = 2 * wi + ((lane >> 3) & 1);
  const size_t grow = static_cast<size_t>(bh) * d.Sp;

  float acc[NV / 2];
#pragma unroll
  for (int j = 0; j < NV / 2; ++j) acc[j] = 0.f;
  float nreg0 = 0.f, nreg1 = 0.f;

  // processed chunk j's a and b into coef, and its decay exp(m_c - M_L)
  auto chunk_coef = [&](int j) {
    const int c = chunk_of(j);
    float* cj = coef + (j & 1) * 2 * L;
    for (int t = threadIdx.x; t < L; t += kThreads) {
      const float a = ca[grow + static_cast<size_t>(c) * L + t];
      cj[t] = a;
      cj[L + t] = REV ? cb[grow + static_cast<size_t>(c) * L + t] : a;
    }
    return expf(mchain[bh * (nC + 1) + c] - ML[bh * nC + c]);
  };

  float decay = np > 0 ? chunk_coef(0) : 1.f;
  __syncthreads();

  float np0 = 0.f, np1 = 0.f;  // the chunk's n sums
  for (int i = 0; i < nslab; ++i) {
    // refill the slot of slab i - 1 once both warpgroups are done with it
    if (threadIdx.x == 0 && i >= 1 && i - 1 + kWStages < nslab) {
      sm90::mbar_wait(bar_e + 8 * ((i - 1) % kWStages),
                      ((i - 1) / kWStages) & 1);
      load_slab(i - 1 + kWStages);
    }
    const int j = i / spc, sl = i % spc;
    if (sl == 0) {
      // processed chunk j starts: the state before it out, then its decay.
      // Its coefficients, written during chunk j - 1, are visible past the
      // barrier.
      if (j > 0) __syncthreads();
      write_state<NV>(acc, nreg0, nreg1, Shi, Slo, nvec,
                      bh * nC + chunk_of(j), Dq, Dv, dr0, dr1, dv0, c4,
                      dvb == 0);
#pragma unroll
      for (int jj = 0; jj < NV / 2; ++jj) acc[jj] *= decay;
      nreg0 *= decay;
      nreg1 *= decay;
    }

    const int s = i % kWStages;
    const uint32_t slot = base + s * Lt::kSlot;
    // A = (a X)^T, this warpgroup's 64 rows of Dq (X panel wg) by the
    // slab's 64 positions, four steps of 16: a[4 kk + m] holds the pair of
    // positions 16 kk + 8 (m / 2) + 2 c4 + {0, 1} at row dr[m % 2]
    uint32_t xhi_r[16], xlo_r[16];
    sm90::mbar_wait(bar_f + 8 * s, (i / kWStages) & 1);
    const uint32_t xpanel = slot + wg * kPanel;
    const float* ws = coef + (j & 1) * 2 * L + 64 * sl + 2 * c4;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t r[4];
      const int row = 16 * kk + lrow;
      sm90::ldsm_x4_trans(r, xpanel + row * 128 + ((lchunk ^ (row & 7)) << 4));
      const float2 wa = *reinterpret_cast<const float2*>(ws + 16 * kk);
      const float2 wb = *reinterpret_cast<const float2*>(ws + 16 * kk + 8);
      const float2 ba = *reinterpret_cast<const float2*>(ws + L + 16 * kk);
      const float2 bb =
          *reinterpret_cast<const float2*>(ws + L + 16 * kk + 8);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const __nv_bfloat162 xv = sm90::bits_bf16x2(r[m]);
        const float x0 = __low2float(xv), x1 = __high2float(xv);
        const float xa = x0 * (m < 2 ? wa.x : wb.x);
        const float xb = x1 * (m < 2 ? wa.y : wb.y);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(xa, xb);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            xa - __low2float(hi), xb - __high2float(hi));
        xhi_r[4 * kk + m] = sm90::bf16x2_bits(hi);
        xlo_r[4 * kk + m] = sm90::bf16x2_bits(lo);
        const float nv = REV ? x0 * (m < 2 ? ba.x : bb.x) +
                                   x1 * (m < 2 ? ba.y : bb.y)
                             : xa + xb;
        if (m & 1)
          np1 += nv;
        else
          np0 += nv;
      }
    }
    // state += (a X)_hi^T Y + (a X)_lo^T Y, Y read MN-major
    const uint64_t dy = sm90::desc_sw128(slot + kWalkX, kMnLbo, kMnSbo);
    sm90::fence_regs(acc);
    sm90::fence_regs(xhi_r);
    sm90::fence_regs(xlo_r);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::wgmma_m64k16_rs_tb<NV>(acc, xhi_r + 4 * kk, dy + kk * 128);
      sm90::wgmma_m64k16_rs_tb<NV>(acc, xlo_r + 4 * kk, dy + kk * 128);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(acc);
    sm90::fence_regs(xhi_r);
    sm90::fence_regs(xlo_r);
    sm90::mbar_arrive(bar_e + 8 * s);
    // the next chunk's coefficients (read after the barrier that starts it)
    if (sl == 0 && j + 1 < np) decay = chunk_coef(j + 1);

    if (sl == spc - 1) {
      // chunk end: n += the chunk's sums (a row's terms lie in one quad)
      nreg0 += quad_sum(np0);
      nreg1 += quad_sum(np1);
      np0 = np1 = 0.f;
    }
  }
  write_state<NV>(acc, nreg0, nreg1, Shi, Slo, nvec,
                  bh * nC + (REV ? 0 : nC - 1), Dq, Dv, dr0, dr1, dv0, c4,
                  dvb == 0);
}

// ---------------------------------------------------------------------------
// the GEMM kernels' ring: thread 0 issues item i's TMA loads into slot
// i % kStages; every thread waits for an item and releases it, and thread
// 0 refills the slot once all 256 have
// ---------------------------------------------------------------------------

struct Ring {
  uint32_t base, bar_f, bar_e;
  int slot;

  __device__ void init(uint8_t* smem_raw, uint64_t* bars, int slot_bytes) {
    const uint32_t raw = smem_u32(smem_raw);
    base = (raw + 1023u) & ~1023u;
    bar_f = smem_u32(&bars[0]);
    bar_e = smem_u32(&bars[kStages]);
    slot = slot_bytes;
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        sm90::mbar_init(bar_f + 8 * s, 1);
        sm90::mbar_init(bar_e + 8 * s, kThreads);
      }
      sm90::fence_barrier_init();
    }
    __syncthreads();
  }
  __device__ uint32_t at(int i) const { return base + (i % kStages) * slot; }
  __device__ uint32_t full(int i) const { return bar_f + 8 * (i % kStages); }
  __device__ uint32_t acquire(int i) const {
    sm90::mbar_wait(full(i), (i / kStages) & 1);
    return at(i);
  }
  template <typename Load>
  __device__ void release(int i, int n, Load load) const {
    const uint32_t e = bar_e + 8 * (i % kStages);
    sm90::mbar_arrive(e);
    if (threadIdx.x == 0 && i + kStages < n) {
      sm90::mbar_wait(e, (i / kStages) & 1);
      load(i + kStages);
    }
  }
};

// ---------------------------------------------------------------------------
// 3-5. out (BH nC, L, N) float32 = A B^T (+ A Blo^T): A (positions of chunk
// c, K) K-major from `ta` (boxes of 128 rows), B (N, K) K-major from `tb`
// (boxes of NT rows): rows c L + n0 of batch bh when `b_by_chunk`, else
// rows n0 of batch bh nC + c.  A block: 128 rows t0 .. by NT columns n0 ..
// ---------------------------------------------------------------------------

template <int NT, bool LO>
__global__ void __launch_bounds__(kThreads, 1)
bwd90_abt_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tbl,
                 float* __restrict__ out, int K, int N, int b_by_chunk,
                 int causal, int first_chunk, Dims d) {
  constexpr int kB = NT * 128;  // a B box
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  const int nM = (d.L + 127) / 128, nN = N / NT;
  int b = static_cast<int>(blockIdx.x % (nM * nN));
  const int t0 = 128 * (b % nM);
  b /= nM;
  const int n0 = NT * (b % nN);
  const int z = static_cast<int>(blockIdx.x / (nM * nN)), bh = z / d.nC,
            c = z % d.nC;
  if (c < first_chunk || t0 >= chunk_len(d, c) ||
      (causal && n0 > t0 + 127))
    return;
  Ring ring;
  ring.init(smem_raw, bars, kTile + (LO ? 2 : 1) * kB);
  const int n = K / 64;
  auto load = [&](int i) {
    const uint32_t slot = ring.at(i), bar = ring.full(i);
    sm90::mbar_expect_tx(bar, ring.slot);
    sm90::tma_load_3d(slot, &ta, bar, 64 * i, c * d.L + t0, bh);
    const int brow = b_by_chunk ? c * d.L + n0 : n0;
    const int bz = b_by_chunk ? bh : z;
    sm90::tma_load_3d(slot + kTile, &tb, bar, 64 * i, brow, bz);
    if (LO) sm90::tma_load_3d(slot + kTile + kB, &tbl, bar, 64 * i, brow, bz);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < min(n, kStages); ++i) load(i);

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  float acc[NT / 2];
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) acc[j] = 0.f;
  for (int i = 0; i < n; ++i) {
    const uint32_t slot = ring.acquire(i);
    const uint64_t da = sm90::desc_sw128(slot + wg * kPanel, 16, 1024);
    const uint64_t db = sm90::desc_sw128(slot + kTile, 16, 1024);
    const uint64_t dbl = sm90::desc_sw128(slot + kTile + kB, 16, 1024);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::wgmma_m64k16_ss_kb<NT>(acc, da + 2 * kk, db + 2 * kk);
      if (LO) sm90::wgmma_m64k16_ss_kb<NT>(acc, da + 2 * kk, dbl + 2 * kk);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(acc);
    ring.release(i, n, load);
  }

  const int lane = threadIdx.x % 32, wi = (threadIdx.x % 128) / 32;
  const int c4 = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = t0 + 64 * wg + 16 * wi + lane / 4 + 8 * h;
    if (r >= d.L) continue;
    float* orow = out + (static_cast<size_t>(z) * d.L + r) * N + n0 + 2 * c4;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// 6. the row scalars, a warp a row
// ---------------------------------------------------------------------------

__global__ void bwd90_rows_kernel(const __nv_bfloat16* __restrict__ q,
                                  const float* __restrict__ Sb,
                                  const float* __restrict__ Pb,
                                  const float* __restrict__ Yb,
                                  const float* __restrict__ nc,
                                  const float* __restrict__ g,
                                  const float* __restrict__ Mt,
                                  const float* __restrict__ mt,
                                  const float* __restrict__ mchain,
                                  float* __restrict__ inv,
                                  float* __restrict__ dd,
                                  float* __restrict__ ga,
                                  float* __restrict__ gb, Dims d) {
  const int w = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= d.BH * d.nC * d.L) return;
  const int z = w / d.L, t = w % d.L, bh = z / d.nC, c = z % d.nC;
  const size_t pos = static_cast<size_t>(bh) * d.Sp + c * d.L + t;
  if (t >= chunk_len(d, c)) {
    if (lane == 0) inv[pos] = dd[pos] = ga[pos] = gb[pos] = 0.f;
    return;
  }
  const float Mrow = Mt[pos];
  const float* grow = g + pos - t;
  const float* Srow = Sb + (static_cast<size_t>(z) * d.L + t) * d.L;
  const float* Prow = Pb + (static_cast<size_t>(z) * d.L + t) * d.L;
  float den = 0.f, num = 0.f;
  for (int s = lane; s <= t; s += 32) {
    const float ds = expf(grow[s] - Mrow) * d.scale * Srow[s];
    den += ds;
    num += ds * Prow[s];
  }
  // the carry: q.n_c and q.(C_c dh)
  const bool carry = c > 0;
  float qn = 0.f, qy = 0.f;
  if (carry) {
    const __nv_bfloat16* qr =
        q + (static_cast<size_t>(bh) * d.S + c * d.L + t) * d.Dq;
    const float* nr = nc + static_cast<size_t>(z) * d.Dq;
    const float* yr = Yb + (static_cast<size_t>(z) * d.L + t) * d.Dq;
    for (int e = lane; e < d.Dq; e += 32) {
      const float qv = __bfloat162float(qr[e]);
      qn += qv * nr[e];
      qy += qv * yr[e];
    }
  }
  den = warp_sum(den);
  num = warp_sum(num);
  qn = warp_sum(qn);
  qy = warp_sum(qy);
  if (lane != 0) return;
  const float wc = c > 0 ? expf(mchain[bh * (d.nC + 1) + c] - Mrow) * d.scale
                         : 0.f;
  if (carry) {
    den += wc * qn;
    num += wc * qy;
  }
  const float clamp = expf(-mt[pos]);
  const bool active = fabsf(den) > clamp;
  const float iv = 1.f / fmaxf(fabsf(den), clamp);
  const float ddv = active ? -copysignf(1.f, den) * num * iv * iv : 0.f;
  inv[pos] = iv;
  dd[pos] = ddv;
  ga[pos] = wc * iv;
  gb[pos] = wc * ddv;
}

// ---------------------------------------------------------------------------
// 7. the weights, a block a 64 x 64 tile (rows t, columns s) of a chunk
// ---------------------------------------------------------------------------

__device__ __forceinline__ void split_store(__nv_bfloat16* hi,
                                            __nv_bfloat16* lo, size_t i,
                                            float x) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  hi[i] = h;
  lo[i] = __float2bfloat16_rn(x - __bfloat162float(h));
}

__global__ void __launch_bounds__(kThreads)
bwd90_weights_kernel(const float* __restrict__ Sb, const float* __restrict__ Pb,
                     const float* __restrict__ g, const float* __restrict__ Mt,
                     const float* __restrict__ inv,
                     const float* __restrict__ dd,
                     __nv_bfloat16* __restrict__ wk_hi,
                     __nv_bfloat16* __restrict__ wk_lo,
                     __nv_bfloat16* __restrict__ wkt_hi,
                     __nv_bfloat16* __restrict__ wkt_lo,
                     __nv_bfloat16* __restrict__ wvt_hi,
                     __nv_bfloat16* __restrict__ wvt_lo, Dims d) {
  __shared__ float tk[64][65], tv[64][65];  // [s][t]
  const int nT = d.L / 64;
  const int tile = static_cast<int>(blockIdx.x % (nT * nT));
  const int ti = tile / nT, sj = tile % nT;
  const int z = static_cast<int>(blockIdx.x / (nT * nT)), bh = z / d.nC,
            c = z % d.nC;
  const int lim = chunk_len(d, c);
  const size_t pos0 = static_cast<size_t>(bh) * d.Sp + c * d.L;
  const size_t m0 = static_cast<size_t>(z) * d.L * d.L;
  for (int e = threadIdx.x; e < 64 * 64; e += kThreads) {
    const int r = e / 64, cc = e % 64;
    const int t = 64 * ti + r, s = 64 * sj + cc;
    float wk = 0.f, wvv = 0.f;
    if (s <= t && t < lim) {
      const size_t ts = m0 + static_cast<size_t>(t) * d.L + s;
      const float D = expf(g[pos0 + s] - Mt[pos0 + t]) * d.scale;
      wk = D * (Pb[ts] * inv[pos0 + t] + dd[pos0 + t]);
      wvv = D * Sb[ts] * inv[pos0 + t];
    }
    split_store(wk_hi, wk_lo, m0 + static_cast<size_t>(t) * d.L + s, wk);
    tk[cc][r] = wk;
    tv[cc][r] = wvv;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 64 * 64; e += kThreads) {
    const int r = e / 64, cc = e % 64;  // row s, column t
    const size_t i =
        m0 + static_cast<size_t>(64 * sj + r) * d.L + 64 * ti + cc;
    split_store(wkt_hi, wkt_lo, i, tk[r][cc]);
    split_store(wvt_hi, wvt_lo, i, tv[r][cc]);
  }
}

// ---------------------------------------------------------------------------
// 8, 10, 11. the products with the weights: out rows (positions of chunk
// c) by NT columns, a block 128 rows by NT
//   MODE 0 (dq, rows t, columns of Dq): Wk_hi k + Wk_lo k over s < t0 + 128
//     (k MN-major), then + ga_t Y_t + gb_t n_c; q.dq per row and tile.
//   MODE 1 (dk, rows s, columns of Dq): with a later chunk, v G^T (G hi and
//     lo K-major: rows of Dq) over Dv, then wv_s (that + dn); then + Wk^T q
//     over t >= s0 (Wk^T hi and lo, q MN-major); k.dk per row and tile.
//   MODE 2 (dv, rows s, columns of Dv): with a later chunk, k G (G hi and
//     lo MN-major) over Dq, times wv_s; then + Wv^T dh over t >= s0.
// ---------------------------------------------------------------------------

template <int MODE, int NT>
__global__ void __launch_bounds__(kThreads, 1)
bwd90_apply_kernel(const __grid_constant__ CUtensorMap ta1,
                   const __grid_constant__ CUtensorMap tb1,
                   const __grid_constant__ CUtensorMap tb1l,
                   const __grid_constant__ CUtensorMap ta2,
                   const __grid_constant__ CUtensorMap ta2l,
                   const __grid_constant__ CUtensorMap tb2,
                   const __nv_bfloat16* __restrict__ X,
                   const float* __restrict__ Yb, const float* __restrict__ nv,
                   const float* __restrict__ ga, const float* __restrict__ gb,
                   const float* __restrict__ wv,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                   Dims d) {
  constexpr int kB = NT * 128;  // B's bytes a 64-deep step
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  const int N = MODE == 2 ? d.Dv : d.Dq, nN = N / NT;
  const int nM = (d.L + 127) / 128;
  int b = static_cast<int>(blockIdx.x % (nM * nN));
  const int r0 = 128 * (b % nM);
  b /= nM;
  const int nt = b % nN, n0 = NT * nt;
  const int z = static_cast<int>(blockIdx.x / (nM * nN)), bh = z / d.nC,
            c = z % d.nC;
  const int lim = chunk_len(d, c);
  if (r0 >= lim) return;
  const int end = (min(MODE == 0 ? r0 + 128 : d.L, lim) + 63) / 64 * 64;
  const int k0 = MODE == 0 ? 0 : r0;       // phase 2's first position
  const bool carry_in = c + 1 < d.nC;
  const int n1 = MODE == 0 || !carry_in ? 0 : (MODE == 1 ? d.Dv : d.Dq) / 64;
  const int n = n1 + (end - k0) / 64;

  Ring ring;
  ring.init(smem_raw, bars, max(kTile + 2 * kB, 2 * kTile + kB));
  auto load = [&](int i) {
    const uint32_t slot = ring.at(i), bar = ring.full(i);
    if (i < n1) {
      // phase 1: A (v or k rows r0 ..) and G hi, lo
      sm90::mbar_expect_tx(bar, kTile + 2 * kB);
      sm90::tma_load_3d(slot, &ta1, bar, 64 * i, c * d.L + r0, bh);
      if (MODE == 1) {
        sm90::tma_load_3d(slot + kTile, &tb1, bar, 64 * i, n0, z);
        sm90::tma_load_3d(slot + kTile + kB, &tb1l, bar, 64 * i, n0, z);
      } else {
        for (int p = 0; p < NT / 64; ++p) {
          sm90::tma_load_3d(slot + kTile + p * kPanel, &tb1, bar,
                            n0 + 64 * p, 64 * i, z);
          sm90::tma_load_3d(slot + kTile + kB + p * kPanel, &tb1l, bar,
                            n0 + 64 * p, 64 * i, z);
        }
      }
      return;
    }
    // phase 2: the weights' hi and lo (rows r0 .., columns kp ..) and B
    const int kp = k0 + 64 * (i - n1);
    sm90::mbar_expect_tx(bar, 2 * kTile + kB);
    sm90::tma_load_3d(slot, &ta2, bar, kp, r0, z);
    sm90::tma_load_3d(slot + kTile, &ta2l, bar, kp, r0, z);
    for (int p = 0; p < NT / 64; ++p)
      sm90::tma_load_3d(slot + 2 * kTile + p * kPanel, &tb2, bar, n0 + 64 * p,
                        c * d.L + kp, bh);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < min(n, kStages); ++i) load(i);

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x % 32, wi = (threadIdx.x % 128) / 32;
  const int c4 = lane % 4;
  // this thread's rows (chunk-local) and their positions
  int rr[2];
  size_t pp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rr[h] = r0 + 64 * wg + 16 * wi + lane / 4 + 8 * h;
    pp[h] = static_cast<size_t>(bh) * d.Sp + c * d.L + rr[h];
  }
  const size_t zc = static_cast<size_t>(z) * N;  // the carry vector's row

  float acc[NT / 2];
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) acc[j] = 0.f;
  // phase 1: the carried gradient
  for (int i = 0; i < n1; ++i) {
    const uint32_t slot = ring.acquire(i);
    const uint64_t da = sm90::desc_sw128(slot + wg * kPanel, 16, 1024);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    if (MODE == 1) {
      const uint64_t db = sm90::desc_sw128(slot + kTile, 16, 1024);
      const uint64_t dbl = sm90::desc_sw128(slot + kTile + kB, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_m64k16_ss_kb<NT>(acc, da + 2 * kk, db + 2 * kk);
        sm90::wgmma_m64k16_ss_kb<NT>(acc, da + 2 * kk, dbl + 2 * kk);
      }
    } else {
      const uint64_t db = sm90::desc_sw128(slot + kTile, kMnLbo, kMnSbo);
      const uint64_t dbl = sm90::desc_sw128(slot + kTile + kB, kMnLbo, kMnSbo);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_m64k16_ss_tb<NT>(acc, da + 2 * kk, db + 128 * kk);
        sm90::wgmma_m64k16_ss_tb<NT>(acc, da + 2 * kk, dbl + 128 * kk);
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(acc);
    ring.release(i, n, load);
  }
  if (n1 > 0) {
    // scale each row by wv_s (dk: after adding dn)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float w = rr[h] < lim ? wv[pp[h]] : 0.f;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = acc[4 * j + 2 * h + e];
          if (MODE == 1) x += nv[zc + n0 + 8 * j + 2 * c4 + e];
          x *= w;
        }
    }
  }
  // phase 2: the weights, hi and lo, against B MN-major
  for (int i = n1; i < n; ++i) {
    const uint32_t slot = ring.acquire(i);
    const uint64_t da = sm90::desc_sw128(slot + wg * kPanel, 16, 1024);
    const uint64_t dal = sm90::desc_sw128(slot + kTile + wg * kPanel, 16, 1024);
    const uint64_t db = sm90::desc_sw128(slot + 2 * kTile, kMnLbo, kMnSbo);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::wgmma_m64k16_ss_tb<NT>(acc, da + 2 * kk, db + 128 * kk);
      sm90::wgmma_m64k16_ss_tb<NT>(acc, dal + 2 * kk, db + 128 * kk);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(acc);
    ring.release(i, n, load);
  }

  // epilogue: dq's carry; the row dots with X; the bf16 stores
  const bool state_carry = c > 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rr[h] >= lim) continue;
    const size_t orow =
        (static_cast<size_t>(bh) * d.S + c * d.L + rr[h]) * N + n0 + 2 * c4;
    float a = 0.f, bcoef = 0.f;
    const float* yrow = nullptr;
    if (MODE == 0 && state_carry) {
      a = ga[pp[h]];
      bcoef = gb[pp[h]];
      yrow = Yb + (static_cast<size_t>(z) * d.L + rr[h]) * N + n0 + 2 * c4;
    }
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
      if (MODE == 0 && state_carry) {
        const float2 y = *reinterpret_cast<const float2*>(yrow + 8 * j);
        const float2 nn =
            *reinterpret_cast<const float2*>(nv + zc + n0 + 8 * j + 2 * c4);
        x0 += a * y.x + bcoef * nn.x;
        x1 += a * y.y + bcoef * nn.y;
      }
      if (MODE != 2) {
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(X + orow + 8 * j));
        dot += x0 * xv.x + x1 * xv.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(out + orow + 8 * j) =
          __floats2bfloat162_rn(x0, x1);
    }
    if (MODE != 2) {
      dot = quad_sum(dot);
      if (c4 == 0) part[pp[h] * nN + nt] = dot;
    }
  }
}

// ---------------------------------------------------------------------------
// 12. dlog_f_r = sum_{t >= r} (R_t - Li_t), dlog_i = Li, one warp per
// (b, h), a lane a run of consecutive positions: R = q.dq and Li = k.dk
// summed over their column tiles in order, the lanes' sums, a suffix scan
// over the lanes, then each lane's run from its end
// ---------------------------------------------------------------------------

__global__ void bwd90_dgates_kernel(const float* __restrict__ Rp,
                                    const float* __restrict__ Lp, int nN,
                                    float* __restrict__ dlf,
                                    float* __restrict__ dli, Dims d) {
  const int bh = blockIdx.x, lane = threadIdx.x;
  const size_t row = static_cast<size_t>(bh) * d.Sp;
  const size_t out = static_cast<size_t>(bh) * d.S;
  const int per = (d.S + 31) / 32;
  const int t0 = min(lane * per, d.S), t1 = min(t0 + per, d.S);
  float seg = 0.f;
  for (int t = t0; t < t1; ++t)
    for (int j = 0; j < nN; ++j)
      seg += Rp[(row + t) * nN + j] - Lp[(row + t) * nN + j];
  // the sum over the lanes after this one
  float incl = seg;
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += y;
  }
  float run = incl - seg;
  for (int t = t1 - 1; t >= t0; --t) {
    float r_t = 0.f, li_t = 0.f;
    for (int j = 0; j < nN; ++j) {
      r_t += Rp[(row + t) * nN + j];
      li_t += Lp[(row + t) * nN + j];
    }
    run += r_t - li_t;
    dlf[out + t] = run;
    dli[out + t] = li_t;
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// the N tile of a product with n columns: 256 where it divides n, else 64
// (fewer instantiations to build; S and dP also take 128)
inline int tile_of(int n) { return n % 256 == 0 ? 256 : 64; }

// the workspace, carved in this order (each region 256-byte aligned):
// float32 (BH, Sp): g, Mt, mt, wv, ga, gb, inv, dd; (BH, nC): ML;
// (BH, nC + 1): mchain; bf16 (BH nC, Dq, Dv): Chi, Clo, Ghi, Glo; float32
// (BH nC, Dq): nc, dn; (BH nC, L, L): S, dP; (BH nC, L, Dq): Y; bf16
// (BH nC, L, L): Wk hi, lo, Wk^T hi, lo, Wv^T hi, lo; float32 (BH Sp,
// Dq / NT): the row dots q.dq, k.dk (kernels/mlstm_chunk.py:
// bwd_sm90_workspace_bytes mirrors it)
struct Work {
  float *g, *Mt, *mt, *wv, *ga, *gb, *inv, *dd, *ML, *mchain;
  __nv_bfloat16 *Chi, *Clo, *Ghi, *Glo;
  float *nc, *dn, *S, *P, *Y;
  __nv_bfloat16 *wkh, *wkl, *wkth, *wktl, *wvth, *wvtl;
  float *Rp, *Lp;
};

inline size_t carve(const Dims& d, uint8_t* base, Work* w) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    uint8_t* p = base + off;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  const size_t BH = d.BH, nC = d.nC, Sp = d.Sp, L = d.L, Dq = d.Dq,
               Dv = d.Dv, Z = BH * nC;
  float** pos[] = {&w->g, &w->Mt, &w->mt, &w->wv, &w->ga, &w->gb, &w->inv,
                   &w->dd};
  for (float** p : pos) *p = reinterpret_cast<float*>(take(4 * BH * Sp));
  w->ML = reinterpret_cast<float*>(take(4 * BH * nC));
  w->mchain = reinterpret_cast<float*>(take(4 * BH * (nC + 1)));
  __nv_bfloat16** st[] = {&w->Chi, &w->Clo, &w->Ghi, &w->Glo};
  for (auto p : st)
    *p = reinterpret_cast<__nv_bfloat16*>(take(2 * Z * Dq * Dv));
  w->nc = reinterpret_cast<float*>(take(4 * Z * Dq));
  w->dn = reinterpret_cast<float*>(take(4 * Z * Dq));
  w->S = reinterpret_cast<float*>(take(4 * Z * L * L));
  w->P = reinterpret_cast<float*>(take(4 * Z * L * L));
  w->Y = reinterpret_cast<float*>(take(4 * Z * L * Dq));
  __nv_bfloat16** ws[] = {&w->wkh, &w->wkl, &w->wkth, &w->wktl, &w->wvth,
                          &w->wvtl};
  for (auto p : ws) *p = reinterpret_cast<__nv_bfloat16*>(take(2 * Z * L * L));
  const size_t nN = Dq / tile_of(d.Dq);
  w->Rp = reinterpret_cast<float*>(take(4 * BH * Sp * nN));
  w->Lp = reinterpret_cast<float*>(take(4 * BH * Sp * nN));
  return off;
}

template <typename Kernel>
cudaError_t smem_attr(Kernel k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline size_t gemm_smem(int slot) { return kStages * slot + 1024; }

template <int NT, bool LO>
cudaError_t abt(const CUtensorMap& ta, const CUtensorMap& tb,
                const CUtensorMap& tbl, float* out, int K, int N,
                int b_by_chunk, int causal, int first_chunk, const Dims& d,
                cudaStream_t st) {
  const size_t smem = gemm_smem(kTile + (LO ? 2 : 1) * NT * 128);
  cudaError_t err = smem_attr(bwd90_abt_kernel<NT, LO>, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = ((d.L + 127) / 128) * (N / NT) * d.BH * d.nC;
  bwd90_abt_kernel<NT, LO><<<grid, kThreads, smem, st>>>(
      ta, tb, tbl, out, K, N, b_by_chunk, causal, first_chunk, d);
  return cudaGetLastError();
}

template <bool LO>
cudaError_t abt_n(int nt, const CUtensorMap& ta, const CUtensorMap& tb,
                  const CUtensorMap& tbl, float* out, int K, int N,
                  int b_by_chunk, int causal, int first_chunk, const Dims& d,
                  cudaStream_t st) {
  if (nt == 256)
    return abt<256, LO>(ta, tb, tbl, out, K, N, b_by_chunk, causal,
                        first_chunk, d, st);
  if constexpr (!LO) {
    if (nt == 128)
      return abt<128, false>(ta, tb, tbl, out, K, N, b_by_chunk, causal,
                             first_chunk, d, st);
  }
  return abt<64, LO>(ta, tb, tbl, out, K, N, b_by_chunk, causal, first_chunk,
                     d, st);
}

template <int MODE, int NT>
cudaError_t apply(const CUtensorMap* maps, const __nv_bfloat16* X,
                  const float* Y, const float* nv, const float* ga,
                  const float* gb, const float* wv, __nv_bfloat16* out,
                  float* part, const Dims& d, cudaStream_t st) {
  const int slot = kTile + 2 * NT * 128, slot2 = 2 * kTile + NT * 128;
  const size_t smem = gemm_smem(slot > slot2 ? slot : slot2);
  cudaError_t err = smem_attr(bwd90_apply_kernel<MODE, NT>, smem);
  if (err != cudaSuccess) return err;
  const int N = MODE == 2 ? d.Dv : d.Dq;
  const unsigned grid = ((d.L + 127) / 128) * (N / NT) * d.BH * d.nC;
  bwd90_apply_kernel<MODE, NT><<<grid, kThreads, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], X, Y, nv, ga, gb,
      wv, out, part, d);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t apply_n(int nt, const CUtensorMap* maps, const __nv_bfloat16* X,
                    const float* Y, const float* nv, const float* ga,
                    const float* gb, const float* wv, __nv_bfloat16* out,
                    float* part, const Dims& d, cudaStream_t st) {
  if (nt == 256)
    return apply<MODE, 256>(maps, X, Y, nv, ga, gb, wv, out, part, d, st);
  return apply<MODE, 64>(maps, X, Y, nv, ga, gb, wv, out, part, d, st);
}

template <int NV, bool REV>
cudaError_t walk(const CUtensorMap& tx, const CUtensorMap& ty,
                 const float* ca, const float* cb, const Work& w,
                 __nv_bfloat16* hi, __nv_bfloat16* lo, float* nvec,
                 const Dims& d, cudaStream_t st) {
  const size_t smem = WalkLayout<NV>::smem(d.L);
  cudaError_t err = smem_attr(bwd90_walk_kernel<NV, REV>, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = d.BH * ((d.Dq + 127) / 128) * (d.Dv / NV);
  bwd90_walk_kernel<NV, REV><<<grid, kThreads, smem, st>>>(
      tx, ty, ca, cb, w.ML, w.mchain, hi, lo, nvec, d);
  return cudaGetLastError();
}

template <bool REV>
cudaError_t walk_n(const CUtensorMap& tx, const CUtensorMap& ty,
                   const float* ca, const float* cb, const Work& w,
                   __nv_bfloat16* hi, __nv_bfloat16* lo, float* nvec,
                   const Dims& d, cudaStream_t st) {
  if (tile_of(d.Dv) == 256)
    return walk<256, REV>(tx, ty, ca, cb, w, hi, lo, nvec, d, st);
  return walk<64, REV>(tx, ty, ca, cb, w, hi, lo, nvec, d, st);
}

}  // namespace

extern "C" {

// q, k (BH, S, Dq), v, dh (BH, S, Dv) contiguous bfloat16 with 16-byte
// aligned bases; log_f, log_i (BH, S) float32.  Outputs dq, dk, dv
// bfloat16, dlog_f, dlog_i (BH, S) float32.  `work` holds `work_bytes`
// bytes of scratch (kernels/mlstm_chunk.py: bwd_sm90_workspace_bytes,
// the carve above).  Dq and Dv multiples of 64 in [64, 512], L a
// positive multiple of 64, B H ceil(S / L) L below 2^31.  Returns the
// cudaError_t of the launches (cudaErrorInvalidValue for another shape, a
// workspace too small or a tensor map that cannot be encoded).
int mlstm_chunk_bwd_sm90_launch(const void* q, const void* k, const void* v,
                                const float* log_f, const float* log_i,
                                const void* dh, void* dq, void* dk, void* dv,
                                float* dlog_f, float* dlog_i, void* work,
                                long long work_bytes, int BH, int S, int Dq,
                                int Dv, int L, void* stream) {
  if (Dq % 64 || Dv % 64 || Dq < 64 || Dv < 64 || Dq > 512 || Dv > 512 ||
      L % 64 || L < 64 || S < 1 || BH < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Dims d{BH, S, Dq, Dv, L, (S + L - 1) / L, 0, 1.f / sqrtf((float)Dq)};
  d.Sp = d.nC * L;
  // every grid is one dimension of at most Z (L / 64) (L / 64 + 8) blocks,
  // and the rows kernel numbers Z L warps in an int
  const long long zl = static_cast<long long>(BH) * d.nC * L;
  if (zl >= (1LL << 31) || zl / 64 * (L / 64 + 8) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Work w;
  if (carve(d, static_cast<uint8_t*>(work), &w) >
      static_cast<size_t>(work_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Z = BH * d.nC, ntS = L % 128 == 0 ? 128 : 64;
  const int ntQ = tile_of(Dq), ntV = tile_of(Dv);

  // tensor maps: (outer, rows, columns) bf16, boxes of 64 columns
  CUtensorMap q128, dh128, k128, v128, kS, vS, q64, k64, v64, dh64, chiQ,
      cloQ, ghiQ, gloQ, ghi64, glo64, wkh, wkl, wkth, wktl, wvth, wvtl;
  const bool ok =
      sm90::encode_bf16_panels(&q128, q, BH, S, Dq, 128) &&
      sm90::encode_bf16_panels(&dh128, dh, BH, S, Dv, 128) &&
      sm90::encode_bf16_panels(&k128, k, BH, S, Dq, 128) &&
      sm90::encode_bf16_panels(&v128, v, BH, S, Dv, 128) &&
      sm90::encode_bf16_panels(&kS, k, BH, S, Dq, ntS) &&
      sm90::encode_bf16_panels(&vS, v, BH, S, Dv, ntS) &&
      sm90::encode_bf16_panels(&q64, q, BH, S, Dq, 64) &&
      sm90::encode_bf16_panels(&k64, k, BH, S, Dq, 64) &&
      sm90::encode_bf16_panels(&v64, v, BH, S, Dv, 64) &&
      sm90::encode_bf16_panels(&dh64, dh, BH, S, Dv, 64) &&
      sm90::encode_bf16_panels(&chiQ, w.Chi, Z, Dq, Dv, ntQ) &&
      sm90::encode_bf16_panels(&cloQ, w.Clo, Z, Dq, Dv, ntQ) &&
      sm90::encode_bf16_panels(&ghiQ, w.Ghi, Z, Dq, Dv, ntQ) &&
      sm90::encode_bf16_panels(&gloQ, w.Glo, Z, Dq, Dv, ntQ) &&
      sm90::encode_bf16_panels(&ghi64, w.Ghi, Z, Dq, Dv, 64) &&
      sm90::encode_bf16_panels(&glo64, w.Glo, Z, Dq, Dv, 64) &&
      sm90::encode_bf16_panels(&wkh, w.wkh, Z, L, L, 128) &&
      sm90::encode_bf16_panels(&wkl, w.wkl, Z, L, L, 128) &&
      sm90::encode_bf16_panels(&wkth, w.wkth, Z, L, L, 128) &&
      sm90::encode_bf16_panels(&wktl, w.wktl, Z, L, L, 128) &&
      sm90::encode_bf16_panels(&wvth, w.wvth, Z, L, L, 128) &&
      sm90::encode_bf16_panels(&wvtl, w.wvtl, Z, L, L, 128);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  cudaError_t err;
#define MLSTM_BWD_STEP(call)            \
  err = (call);                         \
  if (err != cudaSuccess) return static_cast<int>(err);

  bwd90_gates_kernel<<<BH, 32, 0, st>>>(
      log_f, log_i, w.g, w.Mt, w.mt, w.ML, w.mchain, w.wv, d);
  MLSTM_BWD_STEP(cudaGetLastError());
  // C_c, n_c
  MLSTM_BWD_STEP(walk_n<false>(k64, v64, w.wv, w.wv, w, w.Chi, w.Clo, w.nc,
                               d, st));
  // S = q k^T, dP = dh v^T, Y = dh C_c^T
  MLSTM_BWD_STEP(abt_n<false>(ntS, q128, kS, kS, w.S, Dq, L, 1, 1, 0, d, st));
  MLSTM_BWD_STEP(abt_n<false>(ntS, dh128, vS, vS, w.P, Dv, L, 1, 1, 0, d, st));
  MLSTM_BWD_STEP(abt_n<true>(ntQ, dh128, chiQ, cloQ, w.Y, Dv, Dq, 0, 0, 1, d,
                             st));
  bwd90_rows_kernel<<<(Z * L + 7) / 8, 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), w.S, w.P, w.Y, w.nc, w.g, w.Mt,
      w.mt, w.mchain, w.inv, w.dd, w.ga, w.gb, d);
  MLSTM_BWD_STEP(cudaGetLastError());
  bwd90_weights_kernel<<<(L / 64) * (L / 64) * Z, kThreads, 0, st>>>(
      w.S, w.P, w.g, w.Mt, w.inv, w.dd, w.wkh, w.wkl, w.wkth, w.wktl, w.wvth,
      w.wvtl, d);
  MLSTM_BWD_STEP(cudaGetLastError());
  // dq
  const CUtensorMap mq[6] = {q128, q128, q128, wkh, wkl, k64};
  MLSTM_BWD_STEP(apply_n<0>(ntQ, mq, static_cast<const __nv_bfloat16*>(q),
                            w.Y, w.nc, w.ga, w.gb, w.wv,
                            static_cast<__nv_bfloat16*>(dq), w.Rp, d, st));
  // G_{c+1}, dn_{c+1}
  MLSTM_BWD_STEP(walk_n<true>(q64, dh64, w.ga, w.gb, w, w.Ghi, w.Glo, w.dn,
                              d, st));
  // dk, dv
  const CUtensorMap mk[6] = {v128, ghiQ, gloQ, wkth, wktl, q64};
  MLSTM_BWD_STEP(apply_n<1>(ntQ, mk, static_cast<const __nv_bfloat16*>(k),
                            nullptr, w.dn, nullptr, nullptr, w.wv,
                            static_cast<__nv_bfloat16*>(dk), w.Lp, d, st));
  const CUtensorMap mv[6] = {k128, ghi64, glo64, wvth, wvtl, dh64};
  MLSTM_BWD_STEP(apply_n<2>(ntV, mv, nullptr, nullptr, nullptr, nullptr,
                            nullptr, w.wv, static_cast<__nv_bfloat16*>(dv),
                            nullptr, d, st));
  bwd90_dgates_kernel<<<BH, 32, 0, st>>>(w.Rp, w.Lp, Dq / ntQ, dlog_f, dlog_i,
                                       d);
  MLSTM_BWD_STEP(cudaGetLastError());
#undef MLSTM_BWD_STEP
  return 0;
}

}  // extern "C"

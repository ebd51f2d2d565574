// mlstm_chunk_sm90 — the chunkwise mLSTM forward (xLSTM matrix memory) for
// Hopper: bf16 wgmma on TMA-fed tiles, with the gated keys, the chunk-start
// states C_c and the gated scores W kept in float32 through hi/lo splits.
//
// Replaces the Pallas TPU kernel repro/kernels/mlstm_chunk.py:
// _mlstm_kernel (:22, wrapper mlstm_chunkwise, pallas_call at :97) for
// bf16 q, k, v with Dq and Dv multiples of 64 up to 512 and a chunk that is
// a multiple of 64; csrc/mlstm_chunk.cu takes float32 and every other
// shape.  The function is that of csrc/mlstm_chunk.cu and of
// mlstm_chunkwise_plain: per (b, h) and chunk of L positions, with F the
// inclusive cumsum of log_f inside the chunk, g = log_i - F, Mt = max(m,
// cummax g), m_t = F + Mt, scale = 1/sqrt(Dq):
//   W[t, s] = scale (q_t . k_s) exp(g_s - Mt_t)          (s <= t, else 0)
//   num_t   = exp(m - Mt_t) scale (q_t C) + sum_s W[t, s] v_s
//   den_t   = exp(m - Mt_t) scale (q_t . n) + sum_s W[t, s]
//   h_t     = num_t / max(|den_t|, exp(-m_t))
//   C <- exp(m - ML) C + sum_s exp(g_s - ML) k_s v_s^T,  n likewise with
//   v = 1,  m <- F_L + ML  (ML = Mt at the chunk's last position);
// any S (positions >= S act as padding with log_f = 0, log_i = -1e30), an
// optional initial (C, n, m), the final state from the kernel's own carry.
//
// Bound: bytes.  At the xlstm-350m serve shape (B = 4, H = 4, S = 1024,
// Dq = Dv = 512, L = 256) a call moves 84 MB (25 us at 3.35 TB/s) and the
// function needs 21.5 GFLOP (22 us at the bf16 tensor-core peak).
//
// Precision.  q, k and v are bf16 and enter the tensor cores exactly; each
// product is exact in float32 and the sums are float32.  Three operands are
// float32 in the function and must enter as bf16: the gated keys wv k
// (wv = exp(g - ML)), the chunk-start state C_c and the gated scores W.
// Each rounded to bf16 fails the check the port holds this kernel to
// (mlstm_check: 2^-16 of the sums over absolute values plus 2^-7 |h|) by
// 3-17x.  So each is split, x = x_hi + x_lo with x_hi = bf16_rn(x), x_lo =
// bf16_rn(x - x_hi) (the subtraction is exact), and enters as two bf16
// products into one float32 accumulator.  n and den sum the unsplit
// float32 values on the CUDA cores.  The tensor-core work is then ~47
// GFLOP at the serve shape.  expf is the accurate one (no fast math).
//
// Design.  The stabilizer chain depends on the gates alone, and given it the
// carry and the outputs separate; three kernels on one stream:
//   1. mlstm_gates_kernel (csrc/mlstm_chunk.cu's, one warp per (b, h)):
//      g, Mt, m_t per position, m at every chunk boundary, the final m.
//   2. mlstm_states_kernel, one block per (b h, 128 rows of Dq, NV columns
//      of Dv): C's block in the float32 wgmma accumulators of two
//      warpgroups (64 rows each, NV / 2 floats a thread), walking the
//      chunks in order, 64 positions at a time.  Before a chunk it writes
//      C_c as bf16 hi and lo (for chunk 0 only with an initial state; one
//      16-byte store a lane after a quad exchange) and n_c in float32;
//      then C <- decay C + (wv k)^T v: k and v slabs arrive by TMA, each
//      thread reads its A fragment of k^T with ldmatrix.trans, scales it by
//      wv (the chunk's, computed into shared memory during the chunk
//      before), splits it and issues it from registers (RS) against v read
//      MN-major.  n sums the same float32 wv k values.  At the end the
//      final C and n in float32.
//   3. mlstm_output_kernel, one block per (b h, chunk, 128 rows, NV
//      columns of Dv), flash-shaped: the q rows stay in shared memory (128
//      KB at Dq = 512); acc = q C_c as two products (SS, C_c hi and lo
//      streamed MN-major), then acc *= exp(m - Mt_t) scale and den = that
//      weight times q . n_c (CUDA cores); then per key tile s0 <= t: S = q
//      k^T (SS), W = S scale exp(g_s - Mt_t) under the causal mask (Mt is
//      known, so no running max; g staged in shared memory), den += row
//      sums of W, acc += W_hi v + W_lo v (RS, v MN-major); h = acc /
//      max(|den|, exp(-m_t)) in bf16.  A key tile's k items are all
//      resident before S's wgmma, so that S is complete within one loop
//      iteration.
// Both tensor-core kernels: 256 threads, two warpgroups, thread 0 also
// issues every TMA load into a ring of slots (mbarriers count the bytes, and
// the 256 threads that are done with a slot), 128-byte-swizzled 64-column
// panels through 3-D tensor maps (rows past a tensor's extent arrive as
// zeros, never from the next head).  No atomics: a launch repeats bitwise.

#include "sm90.cuh"

#include <math.h>

namespace {

using sm90::smem_u32;

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;       // two warpgroups
constexpr int kPanel = 64 * 128;    // a 64-row panel of 64 bf16 columns
// descriptor of an MN-major operand (v, C_c): the leading byte offset is
// the stride of its 64-column panels, the stride byte offset that of its
// 8-row atoms (the other way round from a K-major operand)
constexpr uint32_t kMnLbo = kPanel, kMnSbo = 1024;

// ---------------------------------------------------------------------------
// 1. the stabilizer chain: one warp per (b, h) (csrc/mlstm_chunk.cu's)
// ---------------------------------------------------------------------------

__global__ void mlstm_gates_kernel(const float* __restrict__ log_f,
                                   const float* __restrict__ log_i,
                                   const float* __restrict__ m0,
                                   float* __restrict__ g_out,
                                   float* __restrict__ Mt_out,
                                   float* __restrict__ mt_out,
                                   float* __restrict__ mchain,
                                   float* __restrict__ m_out,
                                   int S, int L, int nC) {
  const int bh = blockIdx.x;
  const int lane = threadIdx.x;
  const int per = (L + 31) / 32;          // consecutive positions per lane
  const float* lf = log_f + (size_t)bh * S;
  const float* li = log_i + (size_t)bh * S;
  const size_t row = (size_t)bh * nC * L;
  const int owner = (L - 1) / per;        // lane holding position L - 1
  float m = m0 ? m0[bh] : kNeg;
  for (int c = 0; c < nC; ++c) {
    if (lane == 0) mchain[(size_t)bh * (nC + 1) + c] = m;
    const int base = c * L;
    // lane sums of log_f, then an exclusive scan of them across the warp
    float s = 0.f;
    for (int i = 0; i < per; ++i) {
      const int t = lane * per + i, p = base + t;
      if (t < L && p < S) s += lf[p];
    }
    float incl = s;
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    // lane maxima of g, then an exclusive max-scan
    float F = excl, gmax = -INFINITY;
    for (int i = 0; i < per; ++i) {
      const int t = lane * per + i, p = base + t;
      if (t < L) {
        F += p < S ? lf[p] : 0.f;
        gmax = fmaxf(gmax, (p < S ? li[p] : kNeg) - F);
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
        F += p < S ? lf[p] : 0.f;
        const float g = (p < S ? li[p] : kNeg) - F;
        run = fmaxf(run, g);
        g_out[row + base + t] = g;
        Mt_out[row + base + t] = run;
        mt_out[row + base + t] = F + run;
      }
    }
    const float FL = __shfl_sync(0xffffffffu, F, owner);
    const float ML = __shfl_sync(0xffffffffu, run, owner);
    m = FL + ML;
  }
  if (lane == 0) {
    mchain[(size_t)bh * (nC + 1) + nC] = m;
    m_out[bh] = m;
  }
}

// ---------------------------------------------------------------------------
// 2. the chunk-start states: one block per (b h, 128 rows of Dq, NV columns)
// ---------------------------------------------------------------------------

constexpr int kStStages = 4;

// a 4 x 4 exchange within a quad: lane c4 holds v[j], its two columns of
// 8-column group j of a row; afterwards v[x] is lane x's pair of group c4,
// so that the lane holds that group's 8 columns in order
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
constexpr int kStK = 2 * kPanel;  // a k slab: 64 positions x 128 d

template <int NV>
struct StLayout {
  static constexpr int kVP = NV / 64;              // v panels
  static constexpr int kSlot = kStK + kVP * kPanel;  // k and v slabs
  // the ring, 1024 bytes of slack to align it to 1024, and two chunks'
  // wv (L floats each) behind it
  static size_t smem(int L) { return kStStages * kSlot + 1024 + 8 * L; }
};

template <int NV>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_states_kernel(const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const float* __restrict__ g, const float* __restrict__ Mt,
                    const float* __restrict__ mchain,
                    const float* __restrict__ C0,
                    const float* __restrict__ n0,
                    __nv_bfloat16* __restrict__ Chi,
                    __nv_bfloat16* __restrict__ Clo,
                    float* __restrict__ nc, float* __restrict__ C_out,
                    float* __restrict__ n_out, int L, int nC, int Dq, int Dv) {
  using Lt = StLayout<NV>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStStages];  // full, empty

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar_f = smem_u32(&bars[0]);            // + 8 s
  const uint32_t bar_e = smem_u32(&bars[kStStages]);    // + 8 s
  // wv = exp(g - ML) of chunk c at wvs[(c % 2) L ..]
  float* wvs = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                        kStStages * Lt::kSlot);

  const int nDq = (Dq + 127) / 128, nDv = Dv / NV;
  const int dvb = static_cast<int>(blockIdx.x % nDv);
  const int dqb = static_cast<int>(blockIdx.x / nDv) % nDq;
  const int bh = static_cast<int>(blockIdx.x / nDv) / nDq;
  const int dq0 = 128 * dqb, dv0 = NV * dvb;
  const int spc = L / 64, nslab = nC * spc;  // 64-position slabs
  const bool has_init = C0 != nullptr;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStStages; ++s) {
      sm90::mbar_init(bar_f + 8 * s, 1);
      sm90::mbar_init(bar_e + 8 * s, kThreads);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // slab i (positions 64 i .. + 63) into slot i % kStStages: k's two
  // panels of this block's 128 rows of Dq, then v's NV / 64 panels
  auto load_slab = [&](int i) {
    const int s = i % kStStages;
    const uint32_t slot = base + s * Lt::kSlot, bar = bar_f + 8 * s;
    sm90::mbar_expect_tx(bar, Lt::kSlot);
#pragma unroll
    for (int p = 0; p < 2 + Lt::kVP; ++p)
      sm90::tma_load_3d(slot + p * kPanel, p < 2 ? &tk : &tv, bar,
                        p < 2 ? dq0 + 64 * p : dv0 + 64 * (p - 2), 64 * i,
                        bh);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < min(nslab, kStStages); ++i) load_slab(i);

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x % 32, wi = (threadIdx.x % 128) / 32;
  const int c4 = lane % 4;
  // acc[4 j + 2 h + e] is C's row dr[h] (of Dq), column dv0 + 8 j + 2 c4 + e
  const int dr0 = dq0 + 64 * wg + 16 * wi + lane / 4, dr1 = dr0 + 8;
  // ldmatrix: lane i addresses row (position) 8 (i / 16) + i % 8 of a
  // 16-position step, 16-byte chunk 2 wi + (i / 8) % 2 of the panel
  const int lrow = ((lane >> 4) << 3) + (lane & 7);
  const int lchunk = 2 * wi + ((lane >> 3) & 1);
  const size_t grow = (size_t)bh * nC * L;  // gate row of this (b, h)

  float acc[NV / 2];
  float nreg0 = 0.f, nreg1 = 0.f;  // n at rows dr0, dr1
#pragma unroll
  for (int j = 0; j < NV / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = h ? dr1 : dr0, col = dv0 + 8 * j + 2 * c4;
      float2 x = make_float2(0.f, 0.f);
      if (has_init && d < Dq)
        x = *reinterpret_cast<const float2*>(C0 + ((size_t)bh * Dq + d) * Dv +
                                             col);
      acc[4 * j + 2 * h] = x.x;
      acc[4 * j + 2 * h + 1] = x.y;
    }
  if (has_init) {
    if (dr0 < Dq) nreg0 = n0[(size_t)bh * Dq + dr0];
    if (dr1 < Dq) nreg1 = n0[(size_t)bh * Dq + dr1];
  }

  // chunk c's wv into wvs, and its carry decay exp(m - ML)
  auto chunk_gates = [&](int c) {
    const float mprev = mchain[(size_t)bh * (nC + 1) + c];
    const float ML = Mt[grow + (size_t)c * L + L - 1];
    for (int t = threadIdx.x; t < L; t += kThreads)
      wvs[(c & 1) * L + t] = expf(g[grow + (size_t)c * L + t] - ML);
    const float decay = expf(mprev - ML);
    return decay;
  };
  float decay = chunk_gates(0);
  __syncthreads();

  float np0 = 0.f, np1 = 0.f;  // the chunk's n sums
  for (int i = 0; i < nslab; ++i) {
    // refill the slot of slab i - 1 once both warpgroups are done with it
    if (threadIdx.x == 0 && i >= 1 && i - 1 + kStStages < nslab) {
      sm90::mbar_wait(bar_e + 8 * ((i - 1) % kStStages),
                      ((i - 1) / kStStages) & 1);
      load_slab(i - 1 + kStStages);
    }
    const int c = i / spc, sl = i % spc;
    if (sl == 0) {
      // chunk c starts: C_c (hi and lo, for the output kernel) and n_c,
      // then the decay of the carry.  Its wv, written during chunk c - 1,
      // are visible past the barrier.
      if (c > 0) __syncthreads();
      if (c > 0 || has_init) {
        const size_t cb = (size_t)(bh * nC + c) * Dq * Dv;
#pragma unroll
        for (int J = 0; J < NV / 32; ++J)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t vhi[4], vlo[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int j = 4 * J + jj;
              const float a = acc[4 * j + 2 * h], b = acc[4 * j + 2 * h + 1];
              const __nv_bfloat162 chi = __floats2bfloat162_rn(a, b);
              const __nv_bfloat162 clo = __floats2bfloat162_rn(
                  a - __low2float(chi), b - __high2float(chi));
              vhi[jj] = sm90::bf16x2_bits(chi);
              vlo[jj] = sm90::bf16x2_bits(clo);
            }
            // one 16-byte store a lane: the 8 columns of group 4 J + c4
            quad_transpose(vhi, c4);
            quad_transpose(vlo, c4);
            const int d = h ? dr1 : dr0, col = dv0 + 8 * (4 * J + c4);
            if (d < Dq) {
              *reinterpret_cast<uint4*>(Chi + cb + (size_t)d * Dv + col) =
                  make_uint4(vhi[0], vhi[1], vhi[2], vhi[3]);
              *reinterpret_cast<uint4*>(Clo + cb + (size_t)d * Dv + col) =
                  make_uint4(vlo[0], vlo[1], vlo[2], vlo[3]);
            }
          }
      }
      if (dvb == 0 && c4 == 0) {
        float* nrow = nc + (size_t)(bh * nC + c) * Dq;
        if (dr0 < Dq) nrow[dr0] = nreg0;
        if (dr1 < Dq) nrow[dr1] = nreg1;
      }
#pragma unroll
      for (int j = 0; j < NV / 2; ++j) acc[j] *= decay;
      nreg0 *= decay;
      nreg1 *= decay;
    }

    const int s = i % kStStages;
    const uint32_t slot = base + s * Lt::kSlot;
    // A = (wv k)^T, this warpgroup's 64 rows of Dq (k panel wg) by the
    // slab's 64 positions, four steps of 16: a[4 kk + m] holds the pair of
    // positions 16 kk + 8 (m / 2) + 2 c4 + {0, 1} at row dr[m % 2]
    uint32_t khi_r[16], klo_r[16];
    sm90::mbar_wait(bar_f + 8 * s, (i / kStStages) & 1);
    const uint32_t kpanel = slot + wg * kPanel;
    const float* ws = wvs + (c & 1) * L + 64 * sl + 2 * c4;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t r[4];
      const int row = 16 * kk + lrow;
      sm90::ldsm_x4_trans(r, kpanel + row * 128 + ((lchunk ^ (row & 7)) << 4));
      const float2 wa = *reinterpret_cast<const float2*>(ws + 16 * kk);
      const float2 wb = *reinterpret_cast<const float2*>(ws + 16 * kk + 8);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const __nv_bfloat162 kv = sm90::bits_bf16x2(r[m]);
        const float xa = __low2float(kv) * (m < 2 ? wa.x : wb.x);
        const float xb = __high2float(kv) * (m < 2 ? wa.y : wb.y);
        const __nv_bfloat162 khi = __floats2bfloat162_rn(xa, xb);
        const __nv_bfloat162 klo = __floats2bfloat162_rn(
            xa - __low2float(khi), xb - __high2float(khi));
        khi_r[4 * kk + m] = sm90::bf16x2_bits(khi);
        klo_r[4 * kk + m] = sm90::bf16x2_bits(klo);
        if (m & 1)
          np1 += xa + xb;
        else
          np0 += xa + xb;
      }
    }
    // C += (wv k)_hi^T v + (wv k)_lo^T v, v read MN-major
    const uint64_t dv = sm90::desc_sw128(slot + kStK, kMnLbo, kMnSbo);
    sm90::fence_regs(acc);
    sm90::fence_regs(khi_r);
    sm90::fence_regs(klo_r);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::wgmma_m64k16_rs_tb<NV>(acc, khi_r + 4 * kk, dv + kk * 128);
      sm90::wgmma_m64k16_rs_tb<NV>(acc, klo_r + 4 * kk, dv + kk * 128);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(acc);
    sm90::fence_regs(khi_r);
    sm90::fence_regs(klo_r);
    sm90::mbar_arrive(bar_e + 8 * s);
    // the next chunk's gates (read after the barrier that starts it)
    if (sl == 0 && c + 1 < nC) decay = chunk_gates(c + 1);

    if (sl == spc - 1) {
      // chunk end: n += the chunk's sums (a row's terms lie in one quad)
      np0 += __shfl_xor_sync(0xffffffffu, np0, 1);
      np0 += __shfl_xor_sync(0xffffffffu, np0, 2);
      np1 += __shfl_xor_sync(0xffffffffu, np1, 1);
      np1 += __shfl_xor_sync(0xffffffffu, np1, 2);
      nreg0 += np0;
      nreg1 += np1;
      np0 = np1 = 0.f;
    }
  }

  // the final state in float32
#pragma unroll
  for (int j = 0; j < NV / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = h ? dr1 : dr0, col = dv0 + 8 * j + 2 * c4;
      if (d < Dq)
        *reinterpret_cast<float2*>(C_out + ((size_t)bh * Dq + d) * Dv + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  if (dvb == 0 && c4 == 0) {
    if (dr0 < Dq) n_out[(size_t)bh * Dq + dr0] = nreg0;
    if (dr1 < Dq) n_out[(size_t)bh * Dq + dr1] = nreg1;
  }
}

// ---------------------------------------------------------------------------
// 3. h: one block per (b h, chunk, 128 rows, NV columns of Dv)
// ---------------------------------------------------------------------------

constexpr int kOutStages = 3;
constexpr int kOutSlot = 4 * kPanel;  // 32 KB: a C_c slab (64 d x 256
                                      // columns), four k panels (64 keys x
                                      // 256 d) or a v tile (64 keys x 256)
constexpr int kQPanel = 128 * 128;    // a 128-row q panel

// dynamic shared memory of the output kernel: the q rows, the ring, the
// chunk's g (L floats) and 1024 bytes of slack to align the
// 128-byte-swizzled tiles to 1024
inline size_t out_smem(int Dq, int L) {
  return (size_t)(Dq / 64) * kQPanel + kOutStages * kOutSlot + 4 * L + 1024;
}

template <int NV>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_output_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tch,
                    const __grid_constant__ CUtensorMap tcl,
                    const float* __restrict__ g, const float* __restrict__ Mt,
                    const float* __restrict__ mt,
                    const float* __restrict__ mchain,
                    const float* __restrict__ nc,
                    __nv_bfloat16* __restrict__ hout, int S, int L,
                    int nC, int Dq, int Dv, float scale, int has_init) {
  constexpr int kVP = NV / 64;
  extern __shared__ uint8_t smem_raw[];
  // full q; full per slot; empty per slot
  __shared__ __align__(8) uint64_t bars[1 + 2 * kOutStages];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* sq_ptr = smem_raw + (base - raw);  // q, for the CUDA cores
  const int DP = Dq / 64, nK = (DP + 3) / 4;  // q panels, k items a tile
  const uint32_t sq = base, ring = base + DP * kQPanel;
  float* gsm = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                        DP * kQPanel + kOutStages * kOutSlot);
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_f = smem_u32(&bars[1]);               // + 8 s
  const uint32_t bar_e = smem_u32(&bars[1 + kOutStages]);  // + 8 s

  // the blocks that read one C_c (its row blocks, then its Dv blocks) are
  // neighbours, so that the second read finds C_c in L2; the chunks run
  // last to first (chunk 0 has no carry without an initial state), the
  // row blocks of a chunk's end first (the causal edge makes them longest)
  const int nRB = (L + 127) / 128, nDv = Dv / NV;
  int b = static_cast<int>(blockIdx.x);
  const int rb = nRB - 1 - b % nRB;
  b /= nRB;
  const int dvb = b % nDv;
  b /= nDv;
  const int c = nC - 1 - b % nC;
  const int bh = b / nC;
  const int dv0 = NV * dvb, t0 = 128 * rb, p0 = c * L;
  // chunk-local end of the rows this block writes
  const int rows_end = min(min(t0 + 128, L), S - p0);
  if (rows_end <= t0) return;
  const int ntiles = (rows_end - 1) / 64 + 1;  // key tiles 0 .. ntiles - 1
  const bool carry = c > 0 || has_init;
  const int nCi = carry ? 2 * DP : 0;  // C_c hi and lo slabs
  const int nitems = nCi + ntiles * (nK + 1);
  const int cslot = bh * nC + c;  // C_c's and n_c's slot

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < kOutStages; ++s) {
      sm90::mbar_init(bar_f + 8 * s, 1);
      sm90::mbar_init(bar_e + 8 * s, kThreads);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // item i into slot i % kOutStages: first the C_c slabs of 64 rows of Dq,
  // hi then lo; then per key tile its k panels, four a slot, and its v tile
  auto load_item = [&](int i) {
    const int s = i % kOutStages;
    const uint32_t slot = ring + s * kOutSlot, bar = bar_f + 8 * s;
    if (i < nCi) {
      sm90::mbar_expect_tx(bar, kVP * kPanel);
      for (int p = 0; p < kVP; ++p)
        sm90::tma_load_3d(slot + p * kPanel, (i & 1) ? &tcl : &tch, bar,
                          dv0 + 64 * p, 64 * (i >> 1), cslot);
      return;
    }
    const int j = (i - nCi) / (nK + 1), r = (i - nCi) % (nK + 1);
    if (r < nK) {
      const int np = min(4, DP - 4 * r);
      sm90::mbar_expect_tx(bar, np * kPanel);
      for (int p = 0; p < np; ++p)
        sm90::tma_load_3d(slot + p * kPanel, &tk, bar, 64 * (4 * r + p),
                          p0 + 64 * j, bh);
    } else {
      sm90::mbar_expect_tx(bar, kVP * kPanel);
      for (int p = 0; p < kVP; ++p)
        sm90::tma_load_3d(slot + p * kPanel, &tv, bar, dv0 + 64 * p,
                          p0 + 64 * j, bh);
    }
  };
  if (threadIdx.x == 0) {
    sm90::mbar_expect_tx(bar_q, DP * kQPanel);
    for (int p = 0; p < DP; ++p)
      sm90::tma_load_3d(sq + p * kQPanel, &tq, bar_q, 64 * p, p0 + t0, bh);
    for (int i = 0; i < min(nitems, kOutStages); ++i) load_item(i);
  }

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x % 32, wi = (threadIdx.x % 128) / 32;
  const int c4 = lane % 4;
  const int t0w = t0 + 64 * wg;        // this warpgroup's first row
  const bool active = t0w < rows_end;  // it has a row to write
  const int jdiag = t0w / 64;          // its diagonal key tile
  // this thread's rows: lr (of the warpgroup's 64) and chunk-local r
  const int lr0 = 16 * wi + lane / 4, lr1 = lr0 + 8;
  const int r0 = t0w + lr0, r1 = t0w + lr1;
  const size_t grow = (size_t)bh * nC * L + p0;  // gate of the chunk's start
  const float mprev = mchain[(size_t)bh * (nC + 1) + c];
  float Mt0 = 0.f, Mt1 = 0.f, mt0 = 0.f, mt1 = 0.f;
  if (active) {
    Mt0 = Mt[grow + r0];
    Mt1 = Mt[grow + r1];
    mt0 = mt[grow + r0];
    mt1 = mt[grow + r1];
  }
  // the chunk's g, read by every key tile's W
  for (int t = threadIdx.x; t < L; t += kThreads) gsm[t] = g[grow + t];
  __syncthreads();

  // h's numerator: acc[4 j + 2 h + e] is row r[h], column dv0 + 8 j +
  // 2 c4 + e
  float acc[NV / 2];
#pragma unroll
  for (int j = 0; j < NV / 2; ++j) acc[j] = 0.f;
  float dcar0 = 0.f, dcar1 = 0.f, dsum0 = 0.f, dsum1 = 0.f;
  const uint32_t qa = sq + wg * 64 * 128;  // this warpgroup's q rows

  // wait for item i; the slot it lies in
  auto acquire = [&](int i) {
    sm90::mbar_wait(bar_f + 8 * (i % kOutStages), (i / kOutStages) & 1);
    return ring + (i % kOutStages) * kOutSlot;
  };
  // every thread is done with item i: each arrives, and thread 0 refills
  // its slot with item i + kOutStages once all 256 have
  auto release = [&](int i) {
    sm90::mbar_arrive(bar_e + 8 * (i % kOutStages));
    if (threadIdx.x == 0 && i + kOutStages < nitems) {
      sm90::mbar_wait(bar_e + 8 * (i % kOutStages), (i / kOutStages) & 1);
      load_item(i + kOutStages);
    }
  };

  sm90::mbar_wait(bar_q, 0);
  for (int i = 0; i < nCi; ++i) {
    // acc += q C_c (hi or lo) over 64 rows of Dq: q's panel i / 2
    const uint32_t slot = acquire(i);
    if (active) {
      const uint64_t dq = sm90::desc_sw128(qa + (i >> 1) * kQPanel, 16,
                                           1024);
      const uint64_t dc = sm90::desc_sw128(slot, kMnLbo, kMnSbo);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_m64k16_ss_tb<NV>(acc, dq + kk * 2, dc + kk * 128);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(acc);
    }
    release(i);
    if (i == nCi - 1 && active) {
      // the carry's weight exp(m - Mt_t) scale, on acc and on q . n_c
      // (CUDA cores: a quad's four lanes split each row's Dq / 8 chunks
      // of 8, then add)
      const float* nv = nc + (size_t)cslot * Dq;
      float qn0 = 0.f, qn1 = 0.f;
#pragma unroll 4
      for (int idx = c4; idx < Dq / 8; idx += 4) {
        const float4 na = *reinterpret_cast<const float4*>(nv + 8 * idx);
        const float4 nb =
            *reinterpret_cast<const float4*>(nv + 8 * idx + 4);
        const float nn[8] = {na.x, na.y, na.z, na.w, nb.x, nb.y, nb.z, nb.w};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 64 * wg + (h ? lr1 : lr0);
          const uint4 u = *reinterpret_cast<const uint4*>(
              sq_ptr + (idx >> 3) * kQPanel + row * 128 +
              (((idx & 7) ^ (row & 7)) << 4));
          const uint32_t w[4] = {u.x, u.y, u.z, u.w};
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const __nv_bfloat162 qv = sm90::bits_bf16x2(w[e]);
            dot += __low2float(qv) * nn[2 * e] +
                   __high2float(qv) * nn[2 * e + 1];
          }
          if (h)
            qn1 += dot;
          else
            qn0 += dot;
        }
      }
      qn0 += __shfl_xor_sync(0xffffffffu, qn0, 1);
      qn0 += __shfl_xor_sync(0xffffffffu, qn0, 2);
      qn1 += __shfl_xor_sync(0xffffffffu, qn1, 1);
      qn1 += __shfl_xor_sync(0xffffffffu, qn1, 2);
      const float wc0 = expf(mprev - Mt0), wc1 = expf(mprev - Mt1);
      const float f0 = wc0 * scale, f1 = wc1 * scale;
      dcar0 = wc0 * (qn0 * scale);
      dcar1 = wc1 * (qn1 * scale);
#pragma unroll
      for (int jj = 0; jj < NV / 2; ++jj) acc[jj] *= (jj & 2) ? f1 : f0;
    }
  }

  // the key tiles: S = q k^T over the tile's k items (all resident at
  // once, so that the scores are one wgmma accumulator within one
  // iteration: an accumulator carried across the loop's branches made
  // ptxas serialize every wgmma), then W and acc += W v over its v item
  for (int j = 0; j < ntiles; ++j) {
    const int i0 = nCi + j * (nK + 1);
    const bool need = active && j <= jdiag;
    float sc[32];
    for (int r = 0; r < nK; ++r) acquire(i0 + r);
    if (need) {
      sm90::fence_regs(sc);
      sm90::wgmma_fence();
      for (int r = 0; r < nK; ++r) {
        const uint64_t dk = sm90::desc_sw128(
            ring + ((i0 + r) % kOutStages) * kOutSlot, 16, 1024);
        for (int p = 0; p < min(4, DP - 4 * r); ++p) {
          const uint64_t dq = sm90::desc_sw128(qa + (4 * r + p) * kQPanel, 16,
                                               1024);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            sm90::wgmma_m64n64k16_ss(sc, dq + kk * 2,
                                     dk + ((p * kPanel + kk * 32) >> 4),
                                     r > 0 || p > 0 || kk > 0);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(sc);
    }
    for (int r = 0; r < nK; ++r) release(i0 + r);

    // W = S scale exp(g_s - Mt_t) for s <= t, its row sums, and acc +=
    // W_hi v + W_lo v
    const uint32_t slot = acquire(i0 + nK);
    if (need) {
      const bool diag = j == jdiag;
      uint32_t phi[16], plo[16];
      // sc[jj] is row r[(jj >> 1) & 1], key 64 j + 8 (jj >> 2) + 2 c4 +
      // (jj & 1)
#pragma unroll
      for (int q8 = 0; q8 < 8; ++q8) {
        const int k0 = 64 * j + 8 * q8 + 2 * c4;
        const float2 gk = *reinterpret_cast<const float2*>(gsm + k0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = h ? r1 : r0;
          const float mrow = h ? Mt1 : Mt0;
          float wab[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + e;
            wab[e] = 0.f;
            if (!diag || key <= row)
              wab[e] = sc[4 * q8 + 2 * h + e] * scale *
                       expf((e ? gk.y : gk.x) - mrow);
          }
          const float wa = wab[0], wb = wab[1];
          if (h)
            dsum1 += wa + wb;
          else
            dsum0 += wa + wb;
          const __nv_bfloat162 whi = __floats2bfloat162_rn(wa, wb);
          const __nv_bfloat162 wlo = __floats2bfloat162_rn(
              wa - __low2float(whi), wb - __high2float(whi));
          phi[2 * q8 + h] = sm90::bf16x2_bits(whi);
          plo[2 * q8 + h] = sm90::bf16x2_bits(wlo);
        }
      }
      const uint64_t dv = sm90::desc_sw128(slot, kMnLbo, kMnSbo);
      sm90::fence_regs(acc);
      sm90::fence_regs(phi);
      sm90::fence_regs(plo);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        sm90::wgmma_m64k16_rs_tb<NV>(acc, phi + 4 * kk, dv + kk * 128);
        sm90::wgmma_m64k16_rs_tb<NV>(acc, plo + 4 * kk, dv + kk * 128);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(acc);
      sm90::fence_regs(phi);
      sm90::fence_regs(plo);
    }
    release(i0 + nK);
  }

  // epilogue: h = acc / max(|den|, exp(-m_t)) in bf16, rows below S
  dsum0 += __shfl_xor_sync(0xffffffffu, dsum0, 1);
  dsum0 += __shfl_xor_sync(0xffffffffu, dsum0, 2);
  dsum1 += __shfl_xor_sync(0xffffffffu, dsum1, 1);
  dsum1 += __shfl_xor_sync(0xffffffffu, dsum1, 2);
  if (!active) return;
  const float div0 = fmaxf(fabsf(dcar0 + dsum0), expf(-mt0));
  const float div1 = fmaxf(fabsf(dcar1 + dsum1), expf(-mt1));
  __nv_bfloat16* hb = hout + ((size_t)bh * S + p0) * Dv + dv0;
#pragma unroll
  for (int J = 0; J < NV / 32; ++J)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float div = h ? div1 : div0;
      uint32_t hv[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * J + jj;
        hv[jj] = sm90::bf16x2_bits(__floats2bfloat162_rn(
            acc[4 * j + 2 * h] / div, acc[4 * j + 2 * h + 1] / div));
      }
      // one 16-byte store a lane: the 8 columns of group 4 J + c4
      quad_transpose(hv, c4);
      const int row = h ? r1 : r0;
      if (row < rows_end)
        *reinterpret_cast<uint4*>(hb + (size_t)row * Dv + 8 * (4 * J + c4)) =
            make_uint4(hv[0], hv[1], hv[2], hv[3]);
    }
}

template <int NV>
cudaError_t launch_all(const void* q, const void* k, const void* v,
                       const float* lf, const float* li, const float* C0,
                       const float* n0, const float* m0, void* h, float* C,
                       float* n, float* m, float* g, float* Mt, float* mt,
                       float* mchain, void* Chi, void* Clo, float* nc, int BH,
                       int S, int Dq, int Dv, int L, int parts,
                       cudaStream_t st) {
  const int nC = (S + L - 1) / L;
  const float scale = 1.0f / sqrtf((float)Dq);
  cudaError_t err;
  if (parts & 1) {
    mlstm_gates_kernel<<<BH, 32, 0, st>>>(lf, li, m0, g, Mt, mt, mchain, m, S,
                                          L, nC);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  CUtensorMap tq, tk, tv, tch, tcl;
  if (!sm90::encode_bf16_panels(&tq, q, BH, S, Dq, 128) ||
      !sm90::encode_bf16_panels(&tk, k, BH, S, Dq, 64) ||
      !sm90::encode_bf16_panels(&tv, v, BH, S, Dv, 64) ||
      !sm90::encode_bf16_panels(&tch, Chi, BH * nC, Dq, Dv, 64) ||
      !sm90::encode_bf16_panels(&tcl, Clo, BH * nC, Dq, Dv, 64))
    return cudaErrorInvalidValue;
  const int nDv = Dv / NV;
  if (parts & 2) {
    using Lt = StLayout<NV>;
    err = cudaFuncSetAttribute(mlstm_states_kernel<NV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Lt::smem(L));
    if (err != cudaSuccess) return err;
    const unsigned grid = BH * ((Dq + 127) / 128) * nDv;
    mlstm_states_kernel<NV><<<grid, kThreads, Lt::smem(L), st>>>(
        tk, tv, g, Mt, mchain, C0, n0, static_cast<__nv_bfloat16*>(Chi),
        static_cast<__nv_bfloat16*>(Clo), nc, C, n, L, nC, Dq, Dv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (parts & 4) {
    const size_t smem = out_smem(Dq, L);
    err = cudaFuncSetAttribute(mlstm_output_kernel<NV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    const unsigned grid = BH * nC * ((L + 127) / 128) * nDv;
    mlstm_output_kernel<NV><<<grid, kThreads, smem, st>>>(
        tq, tk, tv, tch, tcl, g, Mt, mt, mchain, nc,
        static_cast<__nv_bfloat16*>(h), S, L, nC, Dq, Dv, scale,
        C0 != nullptr);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

extern "C" {

// q, k (BH, S, Dq), v and h (BH, S, Dv) contiguous bfloat16 with 16-byte
// aligned bases; log_f, log_i (BH, S), C (BH, Dq, Dv), n (BH, Dq), m (BH)
// float32, C0 / n0 / m0 the same or all null; scratch g, Mt, mt (BH, nC L),
// mchain (BH, nC + 1), nc (BH, nC, Dq) float32 and Chi, Clo (BH, nC, Dq,
// Dv) bfloat16, nC = ceil(S / L).  Dq and Dv multiples of 64 in [64, 512],
// L a positive multiple of 64.  `parts` picks the kernels (1 gates, 2
// states, 4 output; 7 is the function).  Returns the cudaError_t of the
// launches (cudaErrorInvalidValue for another shape or a tensor map that
// cannot be encoded).
int mlstm_chunk_sm90_launch(const void* q, const void* k, const void* v,
                            const void* log_f, const void* log_i,
                            const void* C0, const void* n0, const void* m0,
                            void* h, void* C, void* n, void* m, void* g,
                            void* Mt, void* mt, void* mchain, void* Chi,
                            void* Clo, void* nc, int BH, int S, int Dq,
                            int Dv, int L, int parts, void* stream) {
  if (Dq % 64 || Dv % 64 || Dq < 64 || Dv < 64 || Dq > 512 || Dv > 512 ||
      L % 64 || L < 64 || S < 1 || BH < 1)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dv % 256 == 0)
    return (int)launch_all<256>(q, k, v, f(log_f), f(log_i), f(C0), f(n0),
                                f(m0), h, w(C), w(n), w(m), w(g), w(Mt),
                                w(mt), w(mchain), Chi, Clo, w(nc), BH, S, Dq,
                                Dv, L, parts, st);
  if (Dv % 128 == 0)
    return (int)launch_all<128>(q, k, v, f(log_f), f(log_i), f(C0), f(n0),
                                f(m0), h, w(C), w(n), w(m), w(g), w(Mt),
                                w(mt), w(mchain), Chi, Clo, w(nc), BH, S, Dq,
                                Dv, L, parts, st);
  return (int)launch_all<64>(q, k, v, f(log_f), f(log_i), f(C0), f(n0),
                             f(m0), h, w(C), w(n), w(m), w(g), w(Mt), w(mt),
                             w(mchain), Chi, Clo, w(nc), BH, S, Dq, Dv, L,
                             parts, st);
}

}  // extern "C"

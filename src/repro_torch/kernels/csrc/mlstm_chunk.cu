// mlstm_chunk — chunkwise-parallel mLSTM forward (xLSTM matrix memory) with
// stabilized log-space gates, carrying C (Dq x Dv), n (Dq) and m across
// chunks; its products on the tensor cores (mma.sync) through a three-term
// TF32 split.
//
// Replaces the Pallas TPU kernel repro/kernels/mlstm_chunk.py:
// _mlstm_kernel (:22, wrapper mlstm_chunkwise, pallas_call at :96) and
// follows the oracle repro/kernels/ref.py: mlstm_chunkwise where the Pallas
// wrapper falls short: any S (positions >= S act as padding with
// log_f = 0, log_i = -1e30), an optional initial (C, n, m), and the final
// state from the kernel's own carry.  Per (b, h) and chunk of L positions,
// with F the inclusive cumsum of log_f inside the chunk, g = log_i - F,
// Mt = max(m, cummax g), m_t = F + Mt, scale = 1/sqrt(Dq):
//   W[t, s] = scale (q_t . k_s) exp(g_s - Mt_t)          (s <= t, else 0)
//   num_t   = exp(m - Mt_t) scale (q_t C) + sum_s W[t, s] v_s
//   den_t   = exp(m - Mt_t) scale (q_t . n) + sum_s W[t, s]
//   h_t     = num_t / max(|den_t|, exp(-m_t))
//   C <- exp(m - ML) C + sum_s exp(g_s - ML) k_s v_s^T,  n likewise with
//   v = 1,  m <- F_L + ML  (ML = Mt at the chunk's last position).
// q, k (B, H, S, Dq), v (B, H, S, Dv), h (B, H, S, Dv) in T (float or
// bf16); log_f, log_i (B, H, S), C (B, H, Dq, Dv), n (B, H, Dq), m (B, H)
// float32.  csrc/mlstm_chunk_sm90.cu takes bf16 with Dq, Dv multiples of
// 64 up to 512 and a chunk that is a multiple of 64; this source every
// other shape, float32 among them.
//
// Bound: bytes.  At the reduced xlstm's shape (B = 2, H = 4, S = 300,
// Dq = Dv = 32, L = 256, float32: serve_cpu's prefill and train_cpu's
// forward) a call needs 44.5 MFLOP (q C and the C update, 2 l Dq Dv
// each, and the causal half of q k^T and W v): the split's TF32 products
// take 0.27 us at the 495 TFLOP/s TF32 peak (0.66 us on the float32 CUDA
// cores), less than its 1.28 MB of inputs and outputs (0.38 us).  At
// that size a call is latency: few launches, each spread over enough
// blocks, with short serial chains inside them.
//
// Precision.  All arithmetic outside the products is float32.  Each
// product takes its float32 operands (q, k, v, C, the gated keys wv k and
// the gated scores W) as a three-term TF32 split: hi = tf32_rna(x), lo =
// tf32_rna(x - hi), a b = a_hi b_hi + a_hi b_lo + a_lo b_hi, each product
// exact in the tensor core's float32 sum, about 2^-21 of |a b| left out.
// One TF32 product (about 2^-11) misses mlstm_check's allowance for h
// (2^-16 of the sums over absolute values).  bf16 inputs are staged as
// float32 and split the same way (their lo is zero).  den and n sum the
// unsplit float32 values on the CUDA cores.  expf is the accurate one
// (never --use_fast_math); no atomics, so a launch repeats bitwise.
//
// Design: two launches.  The stabilizer chain depends on the gates alone,
// and given each chunk's start state every chunk's rows are independent:
//   1. mlstm_states_kernel, one block of four warps per (b, h, TS x TS
//      tile of C), walks the chunks in order.  At each chunk's start the
//      four warps scan its gates (cumsum and cummax, a quarter of the
//      chunk each, joined through shared memory), so the gates need no
//      launch of their own; block (0, 0) of each (b, h) writes g, Mt, m_t
//      per position and m at every chunk boundary.  Then (wv k)^T v over
//      the chunk in rounds of four pieces of 32 positions, one piece a
//      warp (its own copy of the tile in m16n8k8 accumulators), and at
//      the chunk's end warp 0 sums the four in order into C_tile <- decay
//      C_tile + ...  It writes C_c and n_c (the state at the start of
//      chunk c) to scratch for every c >= 1 (and the initial state as
//      C_0), and the final C, n, m.  TS is 32, or 16 where Dq and Dv
//      are at most 32 (the reduced shape: 32 blocks, not 8).
//   2. mlstm_output_kernel, one block per (b, h, chunk, 16 RG rows, 32 or
//      64 columns of Dv) of RG row groups x P parities of warps: the
//      rows' q stays in shared memory; parity p takes the chunk-start
//      state's depth pieces and the key tiles at or below the diagonal
//      numbered p mod P, q C_c on the former, and on each key tile the
//      scores q k^T (16 x 32 in four m16n8 accumulators), W in registers
//      (its row sums into den by quad shuffles in a fixed order) and W v;
//      parities 1..P-1 then hand their sums to parity 0 in order, and h =
//      num / max(|den|, e^{-m_t}).  RG x P is 4 x 2 (64 rows, 64
//      columns), or 1 x 4 (16 rows, 32 columns) where Dv is at most 32,
//      so that a chunk's key tiles spread over more SMs.
// Every piece that a block multiplies (32 rows of k and v, of C_c, or of
// k over 32 depths) streams through a ring filled by cp.async (16 bytes a
// thread for float32 rows that are 16-byte aligned, else plain loads that
// convert to float32), the next rounds or items landing during this one's
// products; rows and columns past the data arrive as zeros.  mma.sync
// takes its fragments from any layout: the two k slots t and t + 4 of a
// thread hold the neighbouring positions (or depths) 2t and 2t + 1, so
// W's accumulator layout is already the A operand of W v, and q and k
// fragments are one 8-byte load each.  Row strides are padded so that
// those loads hit 32 different banks.  The cross terms of the split
// accumulate apart from a_hi b_hi, a chain of MMAs of their own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;  // four warps
constexpr int kRingMin = 2;    // the output kernel's ring, at the least
constexpr int kRingMax = 8;    //                            and the most
constexpr int kPiece = 32;     // rows of a piece: positions, keys or depths
constexpr int kLdK = kPiece + 8;  // row stride of a k piece (32 depths)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most n (0..7) committed groups are still in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo + (about 2^-22 |x|), hi and lo TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
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

// an A fragment split once for the products it enters
struct SplitA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ explicit SplitA(const float (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], hi[i], lo[i]);
  }
};

// d += a b through the split: a_hi b_hi + a_hi b_lo + a_lo b_hi
__device__ __forceinline__ void mma_split(float (&d)[4], const SplitA& a,
                                          float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, a.hi, bh0, bh1);
  mma_tf32(d, a.hi, bl0, bl1);
  mma_tf32(d, a.lo, bh0, bh1);
}

// d += a b through the split with b split already: a_hi b_hi, and the
// two cross terms into their own accumulator x (a chain of its own)
__device__ __forceinline__ void mma_split2(float (&d)[4], float (&x)[4],
                                           const SplitA& a, uint32_t bh0,
                                           uint32_t bl0, uint32_t bh1,
                                           uint32_t bl1) {
  mma_tf32(d, a.hi, bh0, bh1);
  mma_tf32(x, a.hi, bl0, bl1);
  mma_tf32(x, a.lo, bh0, bh1);
}

// rows [r0, r0 + kPiece) and columns [c0, c0 + ncols) of a row-major
// matrix (row stride ld elements) into dst (row stride ldd floats) as
// float32, by the block's NT threads; rows at or past r_end and columns
// at or past c_end as zeros.  vec: 16-byte cp.async (float32 only; ld, c0
// and c_end multiples of 4 and src 16-byte aligned), else plain loads.
template <int NT, typename T>
__device__ __forceinline__ void load_piece(float* dst, int ldd, const T* src,
                                           size_t ld, int r0, int nrows,
                                           int r_end, int c0, int ncols,
                                           int c_end, bool vec) {
  if (vec) {
    const int chunks = ncols / 4;
    for (int i = threadIdx.x; i < nrows * chunks; i += NT) {
      const int r = i / chunks, c = 4 * (i - r * chunks);
      const bool ok = r0 + r < r_end && c0 + c < c_end;
      const T* s = ok ? src + (r0 + r) * ld + c0 + c : src;
      cp_async16(dst + r * ldd + c, s, ok);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * ncols; i += NT) {
      const int r = i / ncols, c = i - r * ncols;
      float x = 0.f;
      if (r0 + r < r_end && c0 + c < c_end)
        x = to_f32(src[(r0 + r) * ld + c0 + c]);
      dst[r * ldd + c] = x;
    }
  }
}

// ---------------------------------------------------------------------------
// 1. the gates and the chunk-start states: one block per (b, h, C tile)
// ---------------------------------------------------------------------------

// a round: the pieces of 32 positions that the four warps take at once,
// one each
constexpr int kRound = 4;

// the states kernel's shared memory at TS x TS tiles: two rounds of k and
// v pieces (row stride TS + 4), the chunk's gated-key weights, log_f and
// log_i, and three warps' shares of the tile and of n
template <int TS>
struct StatesSmem {
  static constexpr int kLd = TS + 4;
  static constexpr int kPieceF = 2 * kPiece * kLd;  // a k and a v piece
  static constexpr int kRoundF = kRound * kPieceF;
  static constexpr int kPartF = TS * TS + 32;       // one warp's share
  static size_t bytes(int L) {
    const int PL = (L + kPiece - 1) / kPiece;
    return sizeof(float) * (static_cast<size_t>(2) * kRoundF +
                            3 * PL * kPiece + 3 * kPartF);
  }
};

template <typename T, int TS>
__global__ void __launch_bounds__(kThreads)
mlstm_states_kernel(const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ log_f,
                    const float* __restrict__ log_i,
                    const float* __restrict__ C0, const float* __restrict__ n0,
                    const float* __restrict__ m0, float* __restrict__ C_out,
                    float* __restrict__ n_out, float* __restrict__ m_out,
                    float* __restrict__ g_out, float* __restrict__ Mt_out,
                    float* __restrict__ mt_out, float* __restrict__ mchain,
                    float* __restrict__ states, int S, int L, int nC, int Dq,
                    int Dv, int vec) {
  using G = StatesSmem<TS>;
  constexpr int kLd = G::kLd;
  constexpr int MT = TS / 16, NT = TS / 8;  // m16 and n8 tiles of the tile
  extern __shared__ __align__(16) float smem[];
  const int PL = (L + kPiece - 1) / kPiece;  // pieces a whole chunk
  float* ring = smem;                        // [2][kRoundF]: two rounds
  float* wv = ring + 2 * G::kRoundF;         // [PL 32], zeros past L
  float* lfs = wv + PL * kPiece;             // [PL 32]: the chunk's log_f
  float* lis = lfs + PL * kPiece;            //          and log_i
  float* part = lis + PL * kPiece;           // [3][kPartF]: warps 1-3's
  __shared__ float wsum[4], wmax[4];
  const int j0 = blockIdx.x * TS, d0 = blockIdx.y * TS, bh = blockIdx.z;
  const bool writer = blockIdx.x == 0 && blockIdx.y == 0;
  const bool with_n = blockIdx.x == 0;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const T* kb = k + static_cast<size_t>(bh) * S * Dq;
  const T* vb = v + static_cast<size_t>(bh) * S * Dv;
  const float* lf = log_f + static_cast<size_t>(bh) * S;
  const float* li = log_i + static_cast<size_t>(bh) * S;
  const size_t grow = static_cast<size_t>(bh) * nC * L;  // gate row
  const size_t slot = static_cast<size_t>(Dq) * Dv;      // one C_c
  float* nstates = states + static_cast<size_t>(gridDim.z) * nC * slot;

  // each warp's share of the tile over its pieces (element e of n8 tile n
  // of m16 tile mt is (d0 + 16 mt + g + 8 (e / 2), j0 + 8 n + 2 t + e % 2)),
  // and warp 0's running state C and, in lane d < TS, n
  float acc[MT][NT][4], Cr[MT][NT][4];
  float nacc = 0.f, nr = 0.f;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = d0 + 16 * mt + g + 8 * (e / 2),
                  j = j0 + 8 * n + 2 * t + e % 2;
        float x = 0.f;
        if (C0 != nullptr && warp == 0 && d < Dq && j < Dv) {
          x = C0[(static_cast<size_t>(bh) * Dq + d) * Dv + j];
          states[(static_cast<size_t>(bh) * nC) * slot +
                 static_cast<size_t>(d) * Dv + j] = x;
        }
        Cr[mt][n][e] = x;
        acc[mt][n][e] = 0.f;
      }
  if (with_n && warp == 0 && lane < TS && d0 + lane < Dq && n0 != nullptr) {
    nr = n0[static_cast<size_t>(bh) * Dq + d0 + lane];
    nstates[static_cast<size_t>(bh) * nC * Dq + d0 + lane] = nr;
  }
  float m = m0 ? m0[bh] : kNeg;

  // the rounds, in order: chunk c's pieces 4 r .. 4 r + 3, RP a chunk
  const int RP = (PL + kRound - 1) / kRound;
  const int last = S - (nC - 1) * L;
  const int np_last = (last + kPiece - 1) / kPiece;
  const int total = (nC - 1) * RP + (np_last + kRound - 1) / kRound;
  auto issue = [&](int i) {
    if (i < total) {
      const int c = min(i / RP, nC - 1), r = i - c * RP;
      const int r_end = min(c * L + L, S);
      const int np = c + 1 < nC ? PL : np_last;
      for (int w = 0; w < kRound && kRound * r + w < np; ++w) {
        const int r0 = c * L + kPiece * (kRound * r + w);
        float* dst = ring + (i % 2) * G::kRoundF + w * G::kPieceF;
        load_piece<kThreads, T>(dst, kLd, kb, Dq, r0, kPiece, r_end, d0, TS,
                                Dq, vec);
        load_piece<kThreads, T>(dst + kPiece * kLd, kLd, vb, Dv, r0, kPiece,
                                r_end, j0, TS, Dv, vec);
      }
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  // the gate scans: warp w takes positions [w Q, w Q + Q) of the chunk,
  // lane l of it per consecutive ones from w Q + l per
  const int Q = (L + 3) / 4, per = (Q + 31) / 32;
  int gr = 0;  // the round in the order above
  for (int c = 0; c < nC; ++c) {
    const int base = c * L;
    // the chunk's gates, padding as f = 1, i = 0
    for (int tt = tid; tt < L; tt += kThreads) {
      const int p = base + tt;
      lfs[tt] = p < S ? lf[p] : 0.f;
      lis[tt] = p < S ? li[p] : kNeg;
    }
    if (writer && tid == 0)
      mchain[static_cast<size_t>(bh) * (nC + 1) + c] = m;
    __syncthreads();
    const int q0 = warp * Q, q1 = min(q0 + Q, L);
    // lane sums of log_f, an exclusive scan across the warp, the warp's sum
    float s = 0.f;
    for (int i = 0; i < per; ++i) {
      const int tt = q0 + lane * per + i;
      if (tt < q1) s += lfs[tt];
    }
    float incl = s;
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    // the warps before this one, in order
    float F0 = 0.f;
    for (int w = 0; w < warp; ++w) F0 += wsum[w];
    // lane maxima of g, an exclusive max-scan, the warp's max
    float F = F0 + excl, gmax = -INFINITY;
    for (int i = 0; i < per; ++i) {
      const int tt = q0 + lane * per + i;
      if (tt < q1) {
        F += lfs[tt];
        gmax = fmaxf(gmax, lis[tt] - F);
      }
    }
    float imax = gmax;
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, imax, off);
      if (lane >= off) imax = fmaxf(imax, y);
    }
    float xmax = __shfl_up_sync(0xffffffffu, imax, 1);
    if (lane == 0) xmax = -INFINITY;
    if (lane == 31) wmax[warp] = imax;
    __syncthreads();
    float run = m, ML = m, FL = 0.f;
    for (int w = 0; w < 4; ++w) {
      if (w < warp) run = fmaxf(run, wmax[w]);
      ML = fmaxf(ML, wmax[w]);
      FL += wsum[w];
    }
    // per position: g, Mt = max(m, cummax g), m_t = F + Mt, and the gated
    // keys' weights exp(g - ML)
    run = fmaxf(run, xmax);
    F = F0 + excl;
    for (int i = 0; i < per; ++i) {
      const int tt = q0 + lane * per + i;
      if (tt < q1) {
        F += lfs[tt];
        const float gv = lis[tt] - F;
        run = fmaxf(run, gv);
        wv[tt] = base + tt < S ? expf(gv - ML) : 0.f;
        if (writer) {
          g_out[grow + base + tt] = gv;
          Mt_out[grow + base + tt] = run;
          mt_out[grow + base + tt] = F + run;
        }
      }
    }
    for (int tt = L + tid; tt < PL * kPiece; tt += kThreads) wv[tt] = 0.f;
    const float decay = expf(m - ML);
    m = FL + ML;

    const int np = c + 1 < nC ? PL : np_last;
    for (int r = 0; r * kRound < np; ++r, ++gr) {
      cp_async_wait(1);
      __syncthreads();  // round gr has landed (and wv is written)
      const int p = kRound * r + warp;
      if (p < np) {
        const float* kp = ring + (gr % 2) * G::kRoundF + warp * G::kPieceF;
        const float* vp = kp + kPiece * kLd;
        const float* w = wv + kPiece * p;
        // k step kk: k slot t is position 8 kk + 2 t, slot t + 4 the next
#pragma unroll
        for (int kk = 0; kk < kPiece / 8; ++kk) {
          const int r8 = 8 * kk + 2 * t;
          const float w0 = w[r8], w1 = w[r8 + 1];
          const float* k0r = kp + r8 * kLd + g;
          const float* k1r = k0r + kLd;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const SplitA a({w0 * k0r[16 * mt], w0 * k0r[16 * mt + 8],
                            w1 * k1r[16 * mt], w1 * k1r[16 * mt + 8]});
#pragma unroll
            for (int n = 0; n < NT; ++n)
              mma_split(acc[mt][n], a, vp[r8 * kLd + 8 * n + g],
                        vp[(r8 + 1) * kLd + 8 * n + g]);
          }
        }
        if (with_n && lane < TS)
#pragma unroll 8
          for (int r8 = 0; r8 < kPiece; ++r8)
            nacc += w[r8] * kp[r8 * kLd + lane];
      }
      __syncthreads();  // every warp is done with the round's slot
      issue(gr + 2);
    }

    // C_{c+1} = decay C_c + the four warps' shares, in order
    if (warp > 0) {
      float* pw = part + (warp - 1) * G::kPartF;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pw[((mt * NT + n) * 4 + e) * 32 + lane] = acc[mt][n][e];
      pw[TS * TS + lane] = nacc;
    }
    __syncthreads();
    if (warp == 0) {
      float* Cd = c + 1 < nC
          ? states + (static_cast<size_t>(bh) * nC + c + 1) * slot
          : C_out + static_cast<size_t>(bh) * slot;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = ((mt * NT + n) * 4 + e) * 32 + lane;
            const float u = acc[mt][n][e] + part[i] + part[G::kPartF + i] +
                            part[2 * G::kPartF + i];
            Cr[mt][n][e] = decay * Cr[mt][n][e] + u;
            const int d = d0 + 16 * mt + g + 8 * (e / 2),
                      j = j0 + 8 * n + 2 * t + e % 2;
            if (d < Dq && j < Dv)
              Cd[static_cast<size_t>(d) * Dv + j] = Cr[mt][n][e];
          }
      if (with_n && lane < TS) {
        const int i = TS * TS + lane;
        nr = decay * nr + (nacc + part[i] + part[G::kPartF + i] +
                           part[2 * G::kPartF + i]);
        if (d0 + lane < Dq) {
          float* nd = c + 1 < nC
              ? nstates + (static_cast<size_t>(bh) * nC + c + 1) * Dq
              : n_out + static_cast<size_t>(bh) * Dq;
          nd[d0 + lane] = nr;
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
    nacc = 0.f;
  }
  if (writer && tid == 0) {
    mchain[static_cast<size_t>(bh) * (nC + 1) + nC] = m;
    m_out[bh] = m;
  }
}

// ---------------------------------------------------------------------------
// 2. h: one block per (b, h, chunk, 16 RG rows, 8 NV columns of Dv)
// ---------------------------------------------------------------------------

// the output kernel's shared memory: the q rows, a ring of nring slots,
// each P parities' k pieces (32 keys x 32 depths, row stride kLdK) and v
// pieces (32 keys x 8 NV columns, row stride 8 NV + 4), the chunk's g and
// n_c
template <int NV, int RG, int P>
struct OutputSmem {
  static constexpr int kLdV = 8 * NV + 4;
  static constexpr int kHalf = kPiece * (kLdK + kLdV);  // one parity's
  static constexpr int kSlot = P * kHalf;
  static size_t bytes(int Dq, int L, int nring) {
    const int DqP = (Dq + kPiece - 1) / kPiece * kPiece;
    return sizeof(float) * (static_cast<size_t>(16 * RG) * (DqP + 8) +
                            static_cast<size_t>(nring) * kSlot + L + DqP);
  }
};

template <typename T, int NV, int RG, int P>
__global__ void __launch_bounds__(32 * RG * P)
mlstm_output_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ g,
                    const float* __restrict__ Mt, const float* __restrict__ mt,
                    const float* __restrict__ mchain,
                    const float* __restrict__ states, T* __restrict__ h,
                    int S, int L, int nC, int Dq, int Dv, int carry0,
                    int vec_q, int vec_v, int vec_c, int nring,
                    float scale) {
  using G = OutputSmem<NV, RG, P>;
  constexpr int NTh = 32 * RG * P;   // threads: RG row groups x P parities
  constexpr int kRowsB = 16 * RG;    // rows a block
  constexpr int kLdV = G::kLdV;
  constexpr int kHalf = G::kHalf;
  extern __shared__ __align__(16) float smem[];
  const int DqP = (Dq + kPiece - 1) / kPiece * kPiece;
  const int ldq = DqP + 8;
  float* qs = smem;                    // [16 RG][ldq]
  float* ring = qs + kRowsB * ldq;     // [nring][kSlot]
  float* gs = ring + nring * G::kSlot; // [L]: the chunk's g
  float* ns = gs + L;                  // [DqP]: n_c

  const int nRT = (L + kRowsB - 1) / kRowsB;
  const int rt = blockIdx.x % nRT, jt = blockIdx.x / nRT;
  const int c = blockIdx.y, bh = blockIdx.z;
  const int t0 = rt * kRowsB, j0 = jt * 8 * NV, cb = c * L;
  const int len = min(L, S - cb);  // the chunk's real positions
  if (t0 >= len) return;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g4 = lane / 4, t = lane % 4;
  const int rg = warp % RG, par = warp / RG;  // row group, parity
  const size_t off = static_cast<size_t>(bh) * S + cb;
  const T* qc = q + off * Dq;
  const T* kc = k + off * Dq;
  const T* vc = v + off * Dv;
  const size_t grow = (static_cast<size_t>(bh) * nC + c) * L;
  const bool carry = c > 0 || carry0;
  const size_t slot = static_cast<size_t>(Dq) * Dv;
  const float* Cc = states + (static_cast<size_t>(bh) * nC + c) * slot;
  const float* nc = states + static_cast<size_t>(gridDim.z) * nC * slot +
                    (static_cast<size_t>(bh) * nC + c) * Dq;

  const int nDS = DqP / kPiece;                 // depth pieces
  const int rows_end = min(t0 + kRowsB, len);
  const int nKT = (rows_end + kPiece - 1) / kPiece;  // key tiles
  const int nKG = (nKT + P - 1) / P;                 // groups of P of them
  const int nCG = carry ? (nDS + P - 1) / P : 0;     // groups of C pieces
  const int total = nCG + nKG * nDS;
  // item i: C_c's depth pieces P i + p (i < nCG), else of key tiles P kg
  // + p the k pieces of depths 32 r, and with the last of them the v
  // pieces; parity p's in half p of the slot
  auto issue = [&](int i) {
    if (i < total) {
      float* dst = ring + (i % nring) * G::kSlot;
      if (i < nCG) {
        for (int p = 0; p < P; ++p)
          load_piece<NTh, float>(dst + p * kHalf, kLdV, Cc, Dv,
                                 kPiece * (P * i + p), kPiece, Dq, j0, 8 * NV,
                                 Dv, vec_c);
      } else {
        const int kg = (i - nCG) / nDS, r = (i - nCG) % nDS;
        for (int p = 0; p < P; ++p) {
          const int kt = P * kg + p;
          load_piece<NTh, T>(dst + p * kHalf, kLdK, kc, Dq, kPiece * kt,
                             kPiece, len, kPiece * r, kPiece, Dq, vec_q);
          if (r + 1 == nDS)
            load_piece<NTh, T>(dst + p * kHalf + kPiece * kLdK, kLdV,
                               vc, Dv, kPiece * kt, kPiece, len, j0,
                               8 * NV, Dv, vec_v);
        }
      }
    }
    cp_async_commit();
  };
  // the q rows (all depths, zeros past Dq) with the first item
  for (int d0 = 0; d0 < DqP; d0 += kPiece)
    load_piece<NTh, T>(qs + d0, ldq, qc, Dq, t0, kRowsB, len, d0, kPiece, Dq,
                       vec_q);
  for (int i = 0; i < nring - 1; ++i) issue(i);
  for (int s = tid; s < rows_end; s += NTh) gs[s] = g[grow + s];
  for (int d = tid; d < DqP; d += NTh) ns[d] = carry && d < Dq ? nc[d] : 0.f;

  // this thread's rows (chunk positions) and their gates
  const int ta = t0 + 16 * rg;  // the warp's first row
  const int tr[2] = {ta + g4, ta + g4 + 8};
  float rM[2], rDiv[2], rWc[2];
  const float mprev = mchain[static_cast<size_t>(bh) * (nC + 1) + c];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const bool real = tr[h2] < len;
    rM[h2] = real ? Mt[grow + tr[h2]] : 0.f;
    rDiv[h2] = real ? expf(-mt[grow + tr[h2]]) : 1.f;
    rWc[h2] = real && carry ? expf(mprev - rM[h2]) : 0.f;
  }

  // num as a_hi b_hi (acc) and the split's cross terms (accx), each its
  // own chain of MMAs; the scores likewise (sc, scx)
  float acc[NV][4], accx[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = accx[n][e] = 0.f;
  float qn[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
  float sc[4][4], scx[4][4];
  const float* qr = qs + (16 * rg + g4) * ldq + 2 * t;

  for (int i = 0; i < total; ++i) {
    issue(i + nring - 1);
    cp_async_wait(nring - 1);
    __syncthreads();
    const float* pc = ring + (i % nring) * G::kSlot + par * kHalf;
    if (i < nCG) {
      // q C_c over this warp's piece of 32 depths (k slots t, t + 4:
      // depths 2t, 2t + 1), and q.n_c on the CUDA cores
      const int d0 = kPiece * (P * i + par);
      if (d0 < DqP) {
#pragma unroll
        for (int kk = 0; kk < kPiece / 8; ++kk) {
          const float2 x0 =
              *reinterpret_cast<const float2*>(qr + d0 + 8 * kk);
          const float2 x1 =
              *reinterpret_cast<const float2*>(qr + 8 * ldq + d0 + 8 * kk);
          const SplitA a({x0.x, x1.x, x0.y, x1.y});
          const int r = 8 * kk + 2 * t;
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(pc[r * kLdV + 8 * n + g4], bh0, bl0);
            split_tf32(pc[(r + 1) * kLdV + 8 * n + g4], bh1, bl1);
            mma_split2(acc[n], accx[n], a, bh0, bl0, bh1, bl1);
          }
          const float n0v = ns[d0 + r], n1v = ns[d0 + r + 1];
          qn[0] += x0.x * n0v + x0.y * n1v;
          qn[1] += x1.x * n0v + x1.y * n1v;
        }
      }
      if (i + 1 == nCG) {
        // the carry's weight exp(m - Mt_t) scale, before W v adds on
        const float w0 = rWc[0] * scale, w1 = rWc[1] * scale;
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          acc[n][0] *= w0; acc[n][1] *= w0; acc[n][2] *= w1; acc[n][3] *= w1;
          accx[n][0] *= w0; accx[n][1] *= w0; accx[n][2] *= w1;
          accx[n][3] *= w1;
        }
      }
    } else {
      const int kg = (i - nCG) / nDS, r = (i - nCG) % nDS;
      const int s0 = kPiece * (P * kg + par);
      // a warp whose rows all lie above its key tile skips it
      if (s0 < rows_end && s0 <= ta + 15 && ta < len) {
        if (r == 0)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[j][e] = scx[j][e] = 0.f;
        // q k^T over this piece's 32 depths
        const float* kr = pc + g4 * kLdK + 2 * t;
#pragma unroll
        for (int kk = 0; kk < kPiece / 8; ++kk) {
          const float2 x0 =
              *reinterpret_cast<const float2*>(qr + kPiece * r + 8 * kk);
          const float2 x1 = *reinterpret_cast<const float2*>(
              qr + 8 * ldq + kPiece * r + 8 * kk);
          const SplitA a({x0.x, x1.x, x0.y, x1.y});
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 y = *reinterpret_cast<const float2*>(
                kr + 8 * j * kLdK + 8 * kk);
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(y.x, bh0, bl0);
            split_tf32(y.y, bh1, bl1);
            mma_split2(sc[j], scx[j], a, bh0, bl0, bh1, bl1);
          }
        }
        if (r + 1 == nDS) {
          // W = scale (q.k) exp(g_s - Mt_t) on s <= t, its row sums
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int s = s0 + 8 * j + 2 * t + e % 2, tt = tr[e / 2];
              float w = 0.f;
              if (s <= tt && tt < len)
                w = (sc[j][e] + scx[j][e]) * scale * expf(gs[s] - rM[e / 2]);
              sc[j][e] = w;
              dsum[e / 2] += w;
            }
          // W v: k step j is score tile j (k slots t, t + 4: keys 2t,
          // 2t + 1 of it)
          const float* vp = pc + kPiece * kLdK;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const SplitA a({sc[j][0], sc[j][2], sc[j][1], sc[j][3]});
            const float* v0 = vp + (8 * j + 2 * t) * kLdV + g4;
#pragma unroll
            for (int n = 0; n < NV; ++n) {
              uint32_t bh0, bl0, bh1, bl1;
              split_tf32(v0[8 * n], bh0, bl0);
              split_tf32(v0[kLdV + 8 * n], bh1, bl1);
              mma_split2(acc[n], accx[n], a, bh0, bl0, bh1, bl1);
            }
          }
        }
      }
    }
    __syncthreads();  // the slot is refilled nring - 1 items on
  }

  // parities 1 .. P - 1 hand their sums to parity 0: num, q.n and W's row
  // sums, each a sum over its own pieces and key tiles, added in order
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // no copy is left in flight over the ring reused
  constexpr int kPart = 32 * RG;      // a parity's threads
  constexpr int kVals = 4 * NV + 4;   // the values a thread hands on
  float* part = ring;
  const int pslot = tid % kPart;
  if (par) {
    float* pp = part + (par - 1) * kVals * kPart;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pp[(4 * n + e) * kPart + pslot] = acc[n][e] + accx[n][e];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      pp[(4 * NV + h2) * kPart + pslot] = qn[h2];
      pp[(4 * NV + 2 + h2) * kPart + pslot] = dsum[h2];
    }
  }
  __syncthreads();
  if (par) return;
  float num[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) num[n][e] = acc[n][e] + accx[n][e];
  for (int p = 1; p < P; ++p) {
    const float* pp = part + (p - 1) * kVals * kPart;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) num[n][e] += pp[(4 * n + e) * kPart + pslot];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      qn[h2] += pp[(4 * NV + h2) * kPart + pslot];
      dsum[h2] += pp[(4 * NV + 2 + h2) * kPart + pslot];
    }
  }

  // den and h: row sums over the quad, in a fixed order
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    qn[h2] += __shfl_xor_sync(0xffffffffu, qn[h2], 1);
    qn[h2] += __shfl_xor_sync(0xffffffffu, qn[h2], 2);
    dsum[h2] += __shfl_xor_sync(0xffffffffu, dsum[h2], 1);
    dsum[h2] += __shfl_xor_sync(0xffffffffu, dsum[h2], 2);
  }
  float div[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const float rden = rWc[h2] * (qn[h2] * scale);
    const float den = rden + dsum[h2];
    div[h2] = fmaxf(fabsf(den), rDiv[h2]);
  }
  T* hc = h + off * Dv;
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tt = tr[e / 2], col = j0 + 8 * n + 2 * t + e % 2;
      if (tt < len && col < Dv)
        hc[static_cast<size_t>(tt) * Dv + col] =
            from_f32<T>(num[n][e] / div[e / 2]);
    }
}

// one wave of blocks: the card's 132 SMs
constexpr int kWave = 132;

template <typename T, int NV, int RG, int P>
cudaError_t launch_output(const T* q, const T* k, const T* v, const float* g,
                          const float* Mt, const float* mt,
                          const float* mchain, const float* states, T* h,
                          int BH, int S, int L, int nC, int Dq, int Dv,
                          int carry0, float scale, cudaStream_t st) {
  using G = OutputSmem<NV, RG, P>;
  // a ring as deep as a block's items (up to kRingMax), but no deeper than
  // Hopper's 227 KB a block hold, and where the grid is more than a wave,
  // than two blocks an SM hold (228 KB an SM)
  const int DqP = (Dq + kPiece - 1) / kPiece * kPiece;
  const int nKT = (min(L, S) + kPiece - 1) / kPiece;
  const int items = ((DqP / kPiece + P - 1) / P) +
                    (nKT + P - 1) / P * (DqP / kPiece);
  const int nRT = (L + 16 * RG - 1) / (16 * RG);
  const int nJ = (Dv + 8 * NV - 1) / (8 * NV);
  const long long blocks = static_cast<long long>(nRT) * nJ * nC * BH;
  int nring = max(kRingMin, min(kRingMax, items));
  while (nring > kRingMin &&
         (G::bytes(Dq, L, nring) > 232448 ||
          (blocks > kWave && 2 * (G::bytes(Dq, L, nring) + 1024) > 233472)))
    --nring;
  const size_t smem = G::bytes(Dq, L, nring);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_output_kernel<T, NV, RG, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool f32 = sizeof(T) == 4;
  const int vec_q = f32 && Dq % 4 == 0 && aligned(q) && aligned(k);
  const int vec_v = f32 && Dv % 4 == 0 && aligned(v);
  const int vec_c = Dv % 4 == 0 && aligned(states);
  mlstm_output_kernel<T, NV, RG, P>
      <<<dim3(nRT * nJ, nC, BH), 32 * RG * P, smem, st>>>(
          q, k, v, g, Mt, mt, mchain, states, h, S, L, nC, Dq, Dv, carry0,
          vec_q, vec_v, vec_c, nring, scale);
  return cudaGetLastError();
}

template <typename T, int TS>
cudaError_t launch_states(const T* k, const T* v, const float* lf,
                          const float* li, const float* C0, const float* n0,
                          const float* m0, float* C, float* n, float* m,
                          float* g, float* Mt, float* mt, float* mchain,
                          float* states, int BH, int S, int L, int nC,
                          int Dq, int Dv, cudaStream_t stream) {
  const size_t ssm = StatesSmem<TS>::bytes(L);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_states_kernel<T, TS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(ssm));
  if (err != cudaSuccess) return err;
  const int vec = sizeof(T) == 4 && Dq % 4 == 0 && Dv % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const dim3 tiles((Dv + TS - 1) / TS, (Dq + TS - 1) / TS, BH);
  mlstm_states_kernel<T, TS><<<tiles, kThreads, ssm, stream>>>(
      k, v, lf, li, C0, n0, m0, C, n, m, g, Mt, mt, mchain, states, S, L, nC,
      Dq, Dv, vec);
  return cudaGetLastError();
}

// two launches, their tiles chosen from the head dims: where Dq and Dv
// are at most 32 (the reduced xlstm's 32) the states kernel takes 16 x 16
// tiles of C and the output kernel 16-row blocks with the key tiles split
// in four and 32 columns of Dv, so that a small (b, h) count still fills
// the card; else 32 x 32 tiles and 64-row blocks (four row groups, key
// tiles split in two) of 64 columns
template <typename T>
cudaError_t launch_all(const void* q, const void* k, const void* v,
                       const float* lf, const float* li, const float* C0,
                       const float* n0, const float* m0, void* h, float* C,
                       float* n, float* m, float* g, float* Mt, float* mt,
                       float* mchain, float* states, int BH, int S, int Dq,
                       int Dv, int L, cudaStream_t stream) {
  const int nC = (S + L - 1) / L;
  const float scale = 1.0f / sqrtf((float)Dq);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);

  const bool small_tiles = Dq <= 32 && Dv <= 32;
  cudaError_t err =
      small_tiles
          ? launch_states<T, 16>(kt, vt, lf, li, C0, n0, m0, C, n, m, g, Mt,
                                 mt, mchain, states, BH, S, L, nC, Dq, Dv,
                                 stream)
          : launch_states<T, 32>(kt, vt, lf, li, C0, n0, m0, C, n, m, g, Mt,
                                 mt, mchain, states, BH, S, L, nC, Dq, Dv,
                                 stream);
  if (err != cudaSuccess) return err;

  T* ht = static_cast<T*>(h);
  const int c0 = C0 != nullptr;
  if (Dv <= 32)
    return launch_output<T, 4, 1, 4>(qt, kt, vt, g, Mt, mt, mchain, states,
                                     ht, BH, S, L, nC, Dq, Dv, c0, scale,
                                     stream);
  return launch_output<T, 8, 4, 2>(qt, kt, vt, g, Mt, mt, mchain, states, ht,
                                   BH, S, L, nC, Dq, Dv, c0, scale, stream);
}

}  // namespace

// q, k (BH, S, Dq), v (BH, S, Dv) contiguous in one type (bf16 != 0:
// bfloat16, else float32); log_f, log_i (BH, S) float32; optional initial
// C0 (BH, Dq, Dv), n0 (BH, Dq), m0 (BH) float32 (all null for none).
// Outputs h (BH, S, Dv) in the inputs' type, C, n, m float32.  Scratch,
// all float32 (nC = ceil(S / L)): g, Mt, mt (BH, nC L); mchain (BH, nC +
// 1); states (BH nC (Dq Dv + Dq)): C_c for every (b h, chunk), then n_c.
// Returns the cudaError_t of the first call that fails, else of the last
// launch.
extern "C" int mlstm_chunk_launch(const void* q, const void* k, const void* v,
                                  const void* log_f, const void* log_i,
                                  const void* C0, const void* n0,
                                  const void* m0, void* h, void* C, void* n,
                                  void* m, void* g, void* Mt, void* mt,
                                  void* mchain, void* states, int BH, int S,
                                  int Dq, int Dv, int L, int bf16,
                                  void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_all<__nv_bfloat16>(
        q, k, v, f(log_f), f(log_i), f(C0), f(n0), f(m0), h, w(C), w(n), w(m),
        w(g), w(Mt), w(mt), w(mchain), w(states), BH, S, Dq, Dv, L, st);
  return (int)launch_all<float>(
      q, k, v, f(log_f), f(log_i), f(C0), f(n0), f(m0), h, w(C), w(n), w(m),
      w(g), w(Mt), w(mt), w(mchain), w(states), BH, S, Dq, Dv, L, st);
}

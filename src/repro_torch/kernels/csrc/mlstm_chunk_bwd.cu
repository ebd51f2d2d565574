// mlstm_chunk_bwd — the gradient of the chunkwise stabilized mLSTM forward
// (csrc/mlstm_chunk.cu, csrc/mlstm_chunk_sm90.cu) from a zero state, with
// respect to q, k, v, log_f and log_i, given dh.
//
// Replaces no TPU kernel: the reference trains by jax.value_and_grad
// through the oracle repro/kernels/ref.py: mlstm_chunkwise (the Pallas
// kernel repro/kernels/mlstm_chunk.py: mlstm_chunkwise has no
// custom_vjp), which the port's card cannot run without running the plain
// version.  kernels/mlstm_chunk.py: mlstm_chunkwise_bwd_plain is its plain
// version, and its docstring the math: the stabilizer cancels out of h,
// so the gradient is that of h_t = num_t / max(|den_t|, 1) in
// unstabilized sums, evaluated on the forward's stabilized quantities
// (every exponential has an argument <= 0).  Per (b, h), chunk c of L
// positions, chunk-start stabilizer m_c, in-chunk g_s = li_s - F_s and
// M_t (the forward's), D_ts = exp(g_s - M_t) (s <= t in the chunk),
// w_carry_t = exp(m_c - M_t), wv_s = exp(g_s - M_L), decay_c =
// exp(m_c - M_L):
//   rows:  den_t, dh_t.num_t from the recomputed sums; inv_t =
//          1 / max(|den_t|, e^{-m_t}); dd_t = -sign(den_t) dh_t.num_t
//          inv_t^2 where |den_t| > e^{-m_t}, else 0 (ties go to the
//          clamp); delta_t = inv_t dh_t;
//   dq_t = scale [sum_s D_ts (v_s.delta_t + dd_t) k_s
//                 + w_carry_t (C_c delta_t + n_c dd_t)],
//   dk_s = scale sum_t D_ts (v_s.delta_t + dd_t) q_t + wv_s (G v_s + dn),
//   dv_s = scale sum_t D_ts (q_t.k_s) delta_t + wv_s G^T k_s,
//   G_c  = decay_c G_{c+1} + scale sum_t w_carry_t q_t delta_t^T (dn the
//          same over dd): the gradient of the stabilized state carried
//          backwards over chunks, G (and dn) of chunk c + 1 feeding
//          chunk c's dk and dv;
//   dlog_i_s = k_s.dk_s and dlog_f_r = sum_{t >= r} (q_t.dq_t - k_t.dk_t)
//          (the per-pair terms P_ts summed over s < r <= t).
// q, k, v, dh: (B, H, S, Dq | Dv) float32 or bfloat16 (the `bf16` flag);
// log_f, log_i (B, H, S) float32; dq, dk, dv in the inputs' type, dlog_f,
// dlog_i (B, H, S) float32.
//
// Bound: operations.  At the xlstm-350m train shape (B = 4, H = 4,
// S = 1024, Dq = Dv = 512, chunk 256) one call needs 43.0 GFLOP
// (chip_smoke.py: mlstm_bwd_flops counts them); the split below takes
// three TF32 products for each, 129 GFLOP, 0.26 ms at the 495 TFLOP/s
// TF32 peak (0.64 ms for the 43.0 GFLOP on the float32 CUDA cores' 67
// TFLOP/s); its 235 MB of float32 inputs and outputs take 70 us.  At the
// reduced xlstm's shape (2, 4, 300, 32, chunk 256, float32: train_cpu's
// backward) a call needs 0.10 GFLOP, 0.61 us as the split's products,
// and 2.19 MB, 0.65 us: there a call is latency, so few launches, each
// spread over enough blocks, with short serial chains inside them.
//
// Precision.  All arithmetic outside the products is float32.  Every
// product runs on the tensor cores (mma.sync.m16n8k8, TF32 in, float32
// sums) through a three-term split of each float32 operand: hi =
// tf32_rna(x), lo = tf32_rna(x - hi), a b = a_hi b_hi + a_hi b_lo +
// a_lo b_hi, each product exact in the tensor core's float32 sum, about
// 2^-21 of |a b| left out; the cross terms accumulate apart from a_hi
// b_hi, a chain of MMAs of their own.  One TF32 product (about 2^-11)
// would miss mlstm_check's allowance (BWD_GAMMA = 2^-16 of the sums over
// absolute values).  The operands that carry a float32 weight (the gated
// keys wv k and queries w_carry q, the weights of dq, dk and dv, inv dh,
// the states C_c and G) are split like the rest; bf16 inputs are staged
// as float32 and split the same way (their lo is zero).  n, dn and the
// row sums den, q.n_c, q.dq, k.dk add unsplit float32 values on the CUDA
// cores.  expf is the accurate one (never --use_fast_math); no atomics on
// values, so a launch repeats bitwise.  mma.sync, not wgmma: mma.sync
// takes its fragments from any layout, so k, q, dh and the states enter
// as they lie in memory, row by row; wgmma takes TF32 only K-major from
// shared memory, which would need v, dh, k and the weights transposed
// there beside their split halves.
//
// Design: four launches on the stream, each needing the one before:
//   1. bwd_fstates_kernel, one block of four warps per (b, h, TS x TS
//      tile of C), walks the chunks in order, as the forward's states
//      kernel does: at each chunk's start the warps scan its gates
//      (cumsum and cummax, a quarter of the chunk each), block (0, 0)
//      writing g, M_t, m_t per position and the chunk-start m; then the
//      gated keys' (wv k)^T v over the chunk in rounds of four pieces of
//      32 positions, one a warp, summed in order into C_{c+1} = decay_c
//      C_c + ...; C_c and n_c go to scratch for every c >= 1 (recomputed
//      rather than saved by the forward: 64 MB of float32 per layer at
//      the train shape).  It also zeroes each (b, h)'s ticket (launch 4).
//   2. bwd_rows_kernel (needs C_c and the gates), one block per (b, h,
//      chunk, 16 RG rows): four warps, RG row groups of 16 rows x P =
//      4 / RG parities.  Parity p takes the key tiles of 32 at or below
//      the diagonal numbered p mod P: q k^T and dh v^T over 32-deep
//      pieces, den and dh.num from them, dh_t.v_s kept in shared memory
//      (RB x chunk); then the carry Y = dh C_c^T (kept in scratch for dq),
//      q.Y and q.n_c; the parities hand their sums to parity 0 in order,
//      which takes the row scalars inv and dd.  Then dq's weights D_ts
//      scale (v_s.delta_t + dd_t) in place, dq over 32-column pieces
//      (key tiles split among parities, handed over in order), and q.dq.
//   3. bwd_dstates_kernel (needs inv and dd of every later chunk), the
//      walk of launch 1 in reverse over the gates it wrote: G_{c+1} and
//      dn_{c+1} for each chunk c, from (w_carry scale q)^T (inv dh).  Each
//      TS x TS tile of G depends only on its own columns of dh and rows
//      of q, so no block needs another's.
//   4. bwd_cols_kernel (needs G_{c+1}), one block per (b, h, chunk, 16
//      keys): the transposed scores k q^T and v dh^T over the row tiles at
//      or after the diagonal, the weights of dk and dv in shared memory
//      (two RB x chunk buffers), then dk (with the carry wv (G v + dn))
//      and dv (with wv G^T k) over 32-column pieces, and k.dk.  Each block
//      takes a ticket per (b, h) when its dlog_i is written; the last one
//      sums dlog_f's suffixes over the whole sequence in a fixed order
//      (segments of consecutive positions a thread, then the segments
//      after each), so the gates need no launch of their own either.
// TS is 16 where Dq and Dv are at most 32 (the reduced xlstm's 32: four
// tiles a (b, h), not one), else 32.  The rows kernel's blocks are 16 rows
// (RG 1, the key tiles split four ways) where Dq and Dv are at most 32,
// else 32 (RG 2, two ways: half the reads of k, v and C_c); the columns
// kernel's are always 16 keys, which measured faster than 32 at the train
// shape (two blocks an SM, not one).  At the reduced shape that is 32
// blocks a walk and 152 a rows or columns launch.  Every piece a block
// multiplies (32 rows of q, k, v, dh, C_c or G) streams through a ring
// of two slots filled by cp.async (16 bytes a thread for float32 rows that
// are 16-byte aligned, else plain loads that convert to float32), the next
// pieces landing during this one's products; rows and columns past the
// data arrive as zeros.
// Row strides are padded (32 + 8 for pieces read along their rows as
// float2 fragments, 32 + 4 for pieces read down their columns) so a warp's
// fragment loads hit 32 different banks.  Two template instantiations a
// kernel (the input types); head dims and tiles are run-time arguments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;  // mlstm_chunk.py NEG
constexpr int kThreads = 128;   // four warps, every kernel
constexpr int kPiece = 32;      // rows of a piece: positions, keys or depths
constexpr int kLdA = kPiece + 8;  // a piece read along its rows
constexpr int kLdB = kPiece + 4;  // a piece read down its columns
constexpr int kRound = 4;       // a walk's round: four pieces, one a warp
constexpr int kSmemMax = 232448;  // a block's shared memory on Hopper

struct Dims {
  int BH, S, Dq, Dv, L, nC, Sp, Lp;  // Lp: L rounded up to kPiece
  float scale;
};

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
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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
// (g + 8, 2t), (g + 8, 2t + 1)} (row, column).  Every product below takes
// its k slots t and t + 4 as the neighbouring depths 2t and 2t + 1.
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

// d += a b through the split: a_hi b_hi into d, the two cross terms into
// their own accumulator x (a chain of its own)
__device__ __forceinline__ void mma_split(float (&d)[4], float (&x)[4],
                                          const SplitA& a, float b0,
                                          float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, a.hi, bh0, bh1);
  mma_tf32(x, a.hi, bl0, bl1);
  mma_tf32(x, a.lo, bh0, bh1);
}

// acc (16 rows x 32 columns: four n8 tiles) += diag(w0 rows 0-7, w1 rows
// 8-15) A B^T over 32 depths: A 16 rows of a row-major piece (row stride
// lda), B^T 32 rows of another (row stride kLdA), both read along their
// rows as float2; x holds the split's cross terms
__device__ __forceinline__ void mma_abt(float (&acc)[4][4], float (&x)[4][4],
                                        const float* A, int lda,
                                        const float* Bt, float w0, float w1) {
  const int lane = threadIdx.x % 32, g4 = lane / 4, t = lane % 4;
  const float* a0 = A + g4 * lda + 2 * t;
  const float* a1 = a0 + 8 * lda;
  const float* b = Bt + g4 * kLdA + 2 * t;
#pragma unroll
  for (int kk = 0; kk < kPiece / 8; ++kk) {
    const float2 x0 = *reinterpret_cast<const float2*>(a0 + 8 * kk);
    const float2 x1 = *reinterpret_cast<const float2*>(a1 + 8 * kk);
    const SplitA a({w0 * x0.x, w1 * x1.x, w0 * x0.y, w1 * x1.y});
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 y =
          *reinterpret_cast<const float2*>(b + 8 * j * kLdA + 8 * kk);
      mma_split(acc[j], x[j], a, y.x, y.y);
    }
  }
}

// the same with B (32 depths x 32 columns, row stride kLdB) read down its
// columns
__device__ __forceinline__ void mma_ab(float (&acc)[4][4], float (&x)[4][4],
                                       const float* A, int lda,
                                       const float* B, float w0, float w1) {
  const int lane = threadIdx.x % 32, g4 = lane / 4, t = lane % 4;
  const float* a0 = A + g4 * lda + 2 * t;
  const float* a1 = a0 + 8 * lda;
#pragma unroll
  for (int kk = 0; kk < kPiece / 8; ++kk) {
    const float2 x0 = *reinterpret_cast<const float2*>(a0 + 8 * kk);
    const float2 x1 = *reinterpret_cast<const float2*>(a1 + 8 * kk);
    const SplitA a({w0 * x0.x, w1 * x1.x, w0 * x0.y, w1 * x1.y});
    const float* b = B + (8 * kk + 2 * t) * kLdB + g4;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      mma_split(acc[j], x[j], a, b[8 * j], b[kLdB + 8 * j]);
  }
}

__device__ __forceinline__ void zero(float (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = 0.f;
}

// acc += x, then acc as the 16 values a thread hands over
__device__ __forceinline__ float (&fold(float (&acc)[4][4],
                                        const float (&x)[4][4]))[16] {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += x[j][e];
  return reinterpret_cast<float (&)[16]>(acc);
}

// rows [r0, r0 + nrows) and columns [c0, c0 + NC) of a row-major matrix
// (row stride ld elements) into dst (row stride ldd floats) as float32, by
// the block's threads; rows at or past r_end and columns at or past c_end
// as zeros.  vec: 16-byte cp.async (float32 only; ld, c0 and c_end
// multiples of 4 and src 16-byte aligned), else plain loads.
template <int NC, typename T>
__device__ __forceinline__ void load_piece(float* dst, int ldd, const T* src,
                                           size_t ld, int r0, int nrows,
                                           int r_end, int c0, int c_end,
                                           int vec) {
  if (vec) {
    constexpr int kCh = NC / 4;  // 16-byte chunks a row
    const T* base = src + r0 * ld + c0;
    for (int i = threadIdx.x; i < nrows * kCh; i += kThreads) {
      const int r = i / kCh, c = 4 * (i % kCh);
      const bool ok = r0 + r < r_end && c0 + c < c_end;
      cp_async16(dst + r * ldd + c, ok ? base + r * ld + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * NC; i += kThreads) {
      const int r = i / NC, c = i % NC;
      float x = 0.f;
      if (r0 + r < r_end && c0 + c < c_end)
        x = to_f32(src[(r0 + r) * ld + c0 + c]);
      dst[r * ldd + c] = x;
    }
  }
}

// a walk's A and B pieces of 32 positions x TS columns: out of line, which
// measured faster there (shorter code) and slower in the rows and columns
// kernels
template <typename T>
__device__ __noinline__ void load_walk_pieces(float* dst, const T* A,
                                              const T* B, int Dq, int Dv,
                                              int r0, int r_end, int d0,
                                              int j0, int TS, int vec) {
  if (TS == 16) {
    load_piece<16, T>(dst, kLdB, A, Dq, r0, kPiece, r_end, d0, Dq, vec);
    load_piece<16, T>(dst + kPiece * kLdB, kLdB, B, Dv, r0, kPiece, r_end,
                      j0, Dv, vec);
  } else {
    load_piece<32, T>(dst, kLdB, A, Dq, r0, kPiece, r_end, d0, Dq, vec);
    load_piece<32, T>(dst + kPiece * kLdB, kLdB, B, Dv, r0, kPiece, r_end,
                      j0, Dv, vec);
  }
}

// n items through a ring of two slots of slotF floats: issue(i, slot)
// starts item i's copies, body(i, slot) uses them after a barrier; item
// i + 1's copies fly during item i's products (and while item i is still
// landing)
template <class Issue, class Body>
__device__ __forceinline__ void pipeline(int n, float* ring, int slotF,
                                         Issue issue, Body body) {
  // i = -1: item 0's copies alone (one call site of issue)
  for (int i = -1; i < n; ++i) {
    if (i + 1 < n) issue(i + 1, ring + ((i + 1) % 2) * slotF);
    cp_async_commit();
    if (i < 0) continue;
    cp_async_wait1();
    __syncthreads();  // item i has landed
    body(i, ring + (i % 2) * slotF);
    __syncthreads();  // every thread is done with item i's slot
  }
}

// parities 1 .. P - 1 hand their N values a thread to parity 0, whose
// thread at the same place in its row group adds them to its own in order
template <int N>
__device__ __forceinline__ void hand_over(float (&v)[N], float* part, int P,
                                          int RG, int par) {
  const int nT = 32 * RG, at = threadIdx.x % nT;
  if (par > 0)
#pragma unroll
    for (int i = 0; i < N; ++i) part[((par - 1) * N + i) * nT + at] = v[i];
  __syncthreads();
  if (par == 0)
    for (int p = 1; p < P; ++p)
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] += part[((p - 1) * N + i) * nT + at];
  __syncthreads();
}

// the sum over the four lanes of a quad (one row of an m16n8 tile), in a
// fixed order
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// ---------------------------------------------------------------------------
// 1, 3. the walks over the chunks: one block per (b, h, TS x TS tile)
// ---------------------------------------------------------------------------

// a walk's shared memory (floats): two rounds of an A and a B piece a warp
// (32 positions x TS columns, row stride kLdB), per position of a chunk
// the weights of A's rows, of B's rows and of n, log_f and log_i, and
// three warps' shares of the tile and of n
constexpr int kWalkPieceF = 2 * kPiece * kLdB;
constexpr int kWalkRoundF = kRound * kWalkPieceF;
constexpr int kWalkPartF = kPiece * kPiece + kPiece;
inline size_t walk_smem_bytes(int Lp) {
  return sizeof(float) *
         (2 * static_cast<size_t>(kWalkRoundF) + 5 * Lp + 3 * kWalkPartF);
}

// forward (REV false): the chunk-start states C_{c+1}, n_{c+1} into St,
// nSt for c = 0 .. nC - 2 from A = k, B = v with row weights wv_s and 1
// (n: wv_s), each chunk's gates scanned first (every chunk's, by block
// (0, 0) alone for the last).  Reverse: G_{c+1}, dn_{c+1} into slot c for
// c = nC - 1 .. 0 (zero for the last) from A = q, B = dh with row weights
// w_carry_t scale and inv_t (dn: w_carry_t scale dd_t), over the gates the
// forward walk wrote.
template <typename T, bool REV>
__device__ __forceinline__ void walk(const T* __restrict__ A,
                                     const T* __restrict__ B,
                                     const float* __restrict__ lf,
                                     const float* __restrict__ li,
                                     float* g_out, float* Mt, float* mt_out,
                                     float* mchain,
                                     const float* __restrict__ inv,
                                     const float* __restrict__ dd,
                                     float* __restrict__ St,
                                     float* __restrict__ nSt,
                                     int* __restrict__ ticket, const Dims& d,
                                     int TS, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                    // [2][kWalkRoundF]
  float* aw = ring + 2 * kWalkRoundF;    // [Lp] per position: A's weight,
  float* bw = aw + d.Lp;                 //      B's,
  float* nw = bw + d.Lp;                 //      n's
  float* lfs = nw + d.Lp;                // [Lp]: the chunk's log_f
  float* lis = lfs + d.Lp;               //       and log_i
  float* part = lis + d.Lp;              // [3][kWalkPartF]: warps 1-3's
  __shared__ float wsum[4], wmax[4];
  const int j0 = blockIdx.x * TS, d0 = blockIdx.y * TS, bh = blockIdx.z;
  const bool writer = blockIdx.x == 0 && blockIdx.y == 0;
  const bool with_n = blockIdx.x == 0;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g4 = lane / 4, t = lane % 4;
  const int MT = TS / 16, NT = TS / 8;  // m16 and n8 tiles of the tile
  const T* Ab = A + static_cast<size_t>(bh) * d.S * d.Dq;
  const T* Bb = B + static_cast<size_t>(bh) * d.S * d.Dv;
  const size_t grow = static_cast<size_t>(bh) * d.Sp;  // gate row
  const size_t slot = static_cast<size_t>(d.Dq) * d.Dv;
  const float* nwp = REV ? nw : aw;      // forward: n's weight is wv

  // the rounds in the walk's order: chunk c's pieces 4 r .. 4 r + 3; every
  // chunk has PL pieces but the last, np_last
  const int PL = d.Lp / kPiece;
  const int np_last = (d.S - (d.nC - 1) * d.L + kPiece - 1) / kPiece;
  const int RP = (PL + kRound - 1) / kRound;
  const int RPl = (np_last + kRound - 1) / kRound;
  const int nW = d.nC - 1;  // chunks whose products a walk takes
  const int total = REV ? (nW > 0 ? RPl + (nW - 1) * RP : 0) : nW * RP;
  auto issue = [&](int i) {
    if (i < total) {
      int c, r;
      if (!REV) {
        c = i / RP;
        r = i - c * RP;
      } else if (i < RPl) {
        c = d.nC - 1;
        r = i;
      } else {
        c = d.nC - 2 - (i - RPl) / RP;
        r = (i - RPl) % RP;
      }
      const int r_end = min(c * d.L + d.L, d.S);
      const int np = c + 1 < d.nC ? PL : np_last;
      for (int u = 0; u < kRound && kRound * r + u < np; ++u) {
        const int r0 = c * d.L + kPiece * (kRound * r + u);
        float* dst = ring + (i % 2) * kWalkRoundF + u * kWalkPieceF;
        load_walk_pieces<T>(dst, Ab, Bb, d.Dq, d.Dv, r0, r_end, d0, j0, TS,
                            vec);
      }
    }
    cp_async_commit();
  };

  // each warp's share of the tile over its pieces (element e of n8 tile n
  // of m16 tile mt is (d0 + 16 mt + g + 8 (e / 2), j0 + 8 n + 2 t + e % 2)),
  // its cross terms, and warp 0's running state and, in lane d < TS, n
  float acc[2][4][4], accx[2][4][4], Cr[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = accx[mt][n][e] =
          Cr[mt][n][e] = 0.f;
  float nacc = 0.f, nr = 0.f;
  if (!REV && writer && tid == 0) ticket[bh] = 0;
  if (REV && warp == 0) {
    // G_{nC} = 0: the last chunk's G_{c+1}
    float* Sd = St + (static_cast<size_t>(bh) * d.nC + d.nC - 1) * slot;
    for (int e = lane; e < TS * TS; e += 32) {
      const int dr = d0 + e / TS, j = j0 + e % TS;
      if (dr < d.Dq && j < d.Dv) Sd[static_cast<size_t>(dr) * d.Dv + j] = 0.f;
    }
    if (with_n && lane < TS && d0 + lane < d.Dq)
      nSt[(static_cast<size_t>(bh) * d.nC + d.nC - 1) * d.Dq + d0 + lane] =
          0.f;
  }
  issue(0);
  issue(1);

  float m = kNeg;  // forward: the chunk-start stabilizer
  const int Q = (d.L + 3) / 4, per = (Q + 31) / 32;
  int gr = 0;      // the round in the order above
  const int nChunks = REV ? nW : d.nC;
  for (int w = 0; w < nChunks; ++w) {
    const int c = REV ? d.nC - 1 - w : w;
    const int base = c * d.L;
    const int len = min(d.L, d.S - base);
    float decay;
    if (!REV) {
      if (c + 1 == d.nC && !writer) break;
      // the chunk's gates, padding as f = 1, i = 0
      for (int tt = tid; tt < d.L; tt += kThreads) {
        const int p = base + tt;
        lfs[tt] = p < d.S ? lf[static_cast<size_t>(bh) * d.S + p] : 0.f;
        lis[tt] = p < d.S ? li[static_cast<size_t>(bh) * d.S + p] : kNeg;
      }
      if (writer && tid == 0)
        mchain[static_cast<size_t>(bh) * (d.nC + 1) + c] = m;
      __syncthreads();
      // warp w takes positions [w Q, w Q + Q), lane l of it per
      // consecutive ones from w Q + l per: lane sums of log_f, an
      // exclusive scan across the warp, the warp's sum
      const int q0 = warp * Q, q1 = min(q0 + Q, d.L);
      float s = 0.f;
      for (int i = 0; i < per; ++i) {
        const int tt = q0 + lane * per + i;
        if (tt < q1) s += lfs[tt];
      }
      float incl = s;
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      if (lane == 31) wsum[warp] = incl;
      __syncthreads();
      float F0 = 0.f;
      for (int u = 0; u < warp; ++u) F0 += wsum[u];
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
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, imax, o);
        if (lane >= o) imax = fmaxf(imax, y);
      }
      float xmax = __shfl_up_sync(0xffffffffu, imax, 1);
      if (lane == 0) xmax = -INFINITY;
      if (lane == 31) wmax[warp] = imax;
      __syncthreads();
      float run = m, ML = m, FL = 0.f;
      for (int u = 0; u < 4; ++u) {
        if (u < warp) run = fmaxf(run, wmax[u]);
        ML = fmaxf(ML, wmax[u]);
        FL += wsum[u];
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
          aw[tt] = base + tt < d.S ? expf(gv - ML) : 0.f;
          if (writer) {
            g_out[grow + base + tt] = gv;
            Mt[grow + base + tt] = run;
            mt_out[grow + base + tt] = F + run;
          }
        }
      }
      for (int tt = d.L + tid; tt < d.Lp; tt += kThreads) aw[tt] = 0.f;
      decay = expf(m - ML);
      m = FL + ML;
      if (c + 1 == d.nC) break;  // the last chunk's gates alone
    } else {
      // the weights of chunk c's positions, from the gates of launch 1
      const float mc = mchain[static_cast<size_t>(bh) * (d.nC + 1) + c];
      for (int tt = tid; tt < d.Lp; tt += kThreads) {
        const bool ok = tt < len;
        const float a = ok ? expf(mc - Mt[grow + base + tt]) * d.scale : 0.f;
        aw[tt] = a;
        bw[tt] = ok ? inv[grow + base + tt] : 0.f;
        nw[tt] = ok ? a * dd[grow + base + tt] : 0.f;
      }
      const float ML = Mt[grow + base + d.L - 1];
      const float rdecay = expf(mc - ML);
      decay = rdecay;
    }

    const int np = c + 1 < d.nC ? PL : np_last;
    for (int r = 0; r * kRound < np; ++r, ++gr) {
      cp_async_wait1();
      __syncthreads();  // round gr has landed (and the weights are written)
      const int p = kRound * r + warp;
      if (p < np) {
        const float* ap = ring + (gr % 2) * kWalkRoundF + warp * kWalkPieceF;
        const float* bp = ap + kPiece * kLdB;
        const float* wa = aw + kPiece * p;
        const float* wb = bw + kPiece * p;
        // k step kk: k slot t is position 8 kk + 2 t, slot t + 4 the next
#pragma unroll
        for (int kk = 0; kk < kPiece / 8; ++kk) {
          const int r8 = 8 * kk + 2 * t;
          const float a0 = wa[r8], a1 = wa[r8 + 1];
          const float b0 = REV ? wb[r8] : 1.f, b1 = REV ? wb[r8 + 1] : 1.f;
          const float* A0 = ap + r8 * kLdB + g4;
          const float* B0 = bp + r8 * kLdB + g4;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (mt < MT) {
              const SplitA a({a0 * A0[16 * mt], a0 * A0[16 * mt + 8],
                              a1 * A0[kLdB + 16 * mt],
                              a1 * A0[kLdB + 16 * mt + 8]});
#pragma unroll
              for (int n = 0; n < 4; ++n)
                if (n < NT)
                  mma_split(acc[mt][n], accx[mt][n], a, b0 * B0[8 * n],
                            b1 * B0[kLdB + 8 * n]);
            }
          }
        }
        if (with_n && lane < TS) {
          const float* wn = nwp + kPiece * p;
#pragma unroll 8
          for (int r8 = 0; r8 < kPiece; ++r8)
            nacc += wn[r8] * ap[r8 * kLdB + lane];
        }
      }
      __syncthreads();  // every warp is done with the round's slot
      issue(gr + 2);
    }

    // S_next = decay S + the four warps' shares, in order
    if (warp > 0) {
      float* pw = part + (warp - 1) * kWalkPartF;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (mt < MT && n < NT)
              pw[((mt * 4 + n) * 4 + e) * 32 + lane] =
                  acc[mt][n][e] + accx[mt][n][e];
      pw[kPiece * kPiece + lane] = nacc;
    }
    __syncthreads();
    if (warp == 0) {
      const int cs = REV ? c - 1 : c + 1;
      float* Sd = St + (static_cast<size_t>(bh) * d.nC + cs) * slot;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (mt < MT && n < NT) {
              const int i = ((mt * 4 + n) * 4 + e) * 32 + lane;
              const float u = acc[mt][n][e] + accx[mt][n][e] + part[i] +
                              part[kWalkPartF + i] + part[2 * kWalkPartF + i];
              Cr[mt][n][e] = decay * Cr[mt][n][e] + u;
              const int dr = d0 + 16 * mt + g4 + 8 * (e / 2),
                        j = j0 + 8 * n + 2 * t + e % 2;
              if (dr < d.Dq && j < d.Dv)
                Sd[static_cast<size_t>(dr) * d.Dv + j] = Cr[mt][n][e];
            }
          }
      if (with_n && lane < TS) {
        const int i = kPiece * kPiece + lane;
        nr = decay * nr + (nacc + part[i] + part[kWalkPartF + i] +
                           part[2 * kWalkPartF + i]);
        if (d0 + lane < d.Dq)
          nSt[(static_cast<size_t>(bh) * d.nC + cs) * d.Dq + d0 + lane] = nr;
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] = accx[mt][n][e] = 0.f;
    nacc = 0.f;
  }
}

// 1. the gates and the chunk-start states C_c, n_c (c >= 1)
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_fstates_kernel(const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ log_f,
                   const float* __restrict__ log_i, float* __restrict__ g,
                   float* __restrict__ Mt, float* __restrict__ mt,
                   float* __restrict__ mchain, float* __restrict__ Cst,
                   float* __restrict__ nst, int* __restrict__ ticket, Dims d,
                   int TS, int vec) {
  walk<T, false>(k, v, log_f, log_i, g, Mt, mt, mchain, nullptr, nullptr,
                 Cst, nst, ticket, d, TS, vec);
}

// 3. the gradients of the chunk-start states: Gst[c], dnst[c] hold
// G_{c+1}, dn_{c+1} (zero for the last chunk)
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dstates_kernel(const T* __restrict__ q, const T* __restrict__ dh,
                   float* __restrict__ Mt, float* __restrict__ mchain,
                   const float* __restrict__ inv, const float* __restrict__ dd,
                   float* __restrict__ Gst, float* __restrict__ dnst, Dims d,
                   int TS, int vec) {
  walk<T, true>(q, dh, nullptr, nullptr, nullptr, Mt, nullptr, mchain, inv,
                dd, Gst, dnst, nullptr, d, TS, vec);
}

// ---------------------------------------------------------------------------
// 2, 4. the rows and the columns: one block per (b, h, chunk, 16 RG rows;
// the columns kernel's RG is 1)
// ---------------------------------------------------------------------------

// a slot of their rings (floats): per parity an A piece (16 RG rows) and
// a B piece (32 rows), row stride kLdA; P = 4 / RG parities.  A job (32
// columns of an output) hands 16 values a thread from P - 1 parities to
// parity 0.
__host__ __device__ inline int piece_floats(int RG) {
  return (16 * RG + kPiece) * kLdA;
}
__host__ __device__ inline int part_floats(int RG) {
  return (4 / RG - 1) * 16 * 32 * RG;
}
// the rows kernel's shared memory: a ring of two slots, dh.v (then dq's
// weights) for its rows over the chunk, the hand-over, the chunk's g, and
// per row M_t, inv_t, dd_t
inline size_t rows_smem_bytes(int RG, int Lp) {
  const int RB = 16 * RG;
  return sizeof(float) *
         (2 * (4 / RG) * static_cast<size_t>(piece_floats(RG)) +
          static_cast<size_t>(RB) * (Lp + 8) + part_floats(RG) + Lp +
          3 * RB);
}
// the columns kernel's (RG 1): a ring of two slots, dk's and dv's
// weights for its 16 keys over the chunk, the hand-over, and per position
// M_t, inv_t, dd_t
inline size_t cols_smem_bytes(int Lp) {
  return sizeof(float) *
         (2 * 4 * static_cast<size_t>(piece_floats(1)) +
          2 * 16 * static_cast<size_t>(Lp + 8) + part_floats(1) + 3 * Lp);
}

// 2. a chunk's 16 RG rows: the row scalars, dq and q.dq
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dh,
                const float* __restrict__ g, const float* __restrict__ Mt,
                const float* __restrict__ mt,
                const float* __restrict__ mchain,
                const float* __restrict__ Cst, const float* __restrict__ nst,
                float* __restrict__ Ybuf, float* __restrict__ inv_out,
                float* __restrict__ dd_out, float* __restrict__ R_out,
                T* __restrict__ dq, Dims d, int RG, int vec_q, int vec_v,
                int vec_s) {
  extern __shared__ __align__(16) float smem[];
  const int P = 4 / RG, RB = 16 * RG, ldE = d.Lp + 8;
  const int pieceF = piece_floats(RG), slotF = P * pieceF;
  float* ring = smem;                // [2][slotF]
  float* E = ring + 2 * slotF;       // [RB][ldE]: dh.v, then dq's weights
  float* part = E + RB * ldE;        // the hand-over
  float* gs = part + part_floats(RG);  // [Lp]: the chunk's g
  float* rM = gs + d.Lp;             // [RB] per row: M_t,
  float* rInv = rM + RB;             //               inv_t,
  float* rDD = rInv + RB;            //               dd_t
  const int c = blockIdx.y, bh = blockIdx.z;
  const int t0 = blockIdx.x * RB, base = c * d.L;
  const int len = min(d.L, d.S - base);  // the chunk's real positions
  if (t0 >= len) return;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g4 = lane / 4, t = lane % 4;
  const int rg = warp % RG, par = warp / RG;  // row group, parity
  const size_t off = static_cast<size_t>(bh) * d.S + base;
  const T* qc = q + off * d.Dq;
  const T* kc = k + off * d.Dq;
  const T* vc = v + off * d.Dv;
  const T* dhc = dh + off * d.Dv;
  const size_t grow = static_cast<size_t>(bh) * d.Sp + base;
  const bool carry = c > 0;
  const float* Cc = Cst + (static_cast<size_t>(bh) * d.nC + c) * d.Dq * d.Dv;
  const float* nc = nst + (static_cast<size_t>(bh) * d.nC + c) * d.Dq;
  const int rows_end = min(t0 + RB, len);
  const int nKT = (rows_end + kPiece - 1) / kPiece;  // key tiles
  const int nKG = (nKT + P - 1) / P;                  // groups of P of them
  const int nDq = (d.Dq + kPiece - 1) / kPiece;
  const int nDv = (d.Dv + kPiece - 1) / kPiece;
  const int ta = t0 + 16 * rg;  // the warp's first row
  const bool rows_real = ta < len;
  const int tr[2] = {ta + g4, ta + g4 + 8};  // this thread's rows
  const float mc = mchain[static_cast<size_t>(bh) * (d.nC + 1) + c];
  float wM[2], wWc[2], wDiv[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const bool real = tr[h2] < len;
    wM[h2] = real ? Mt[grow + tr[h2]] : 0.f;
    wWc[h2] = real && carry ? expf(mc - wM[h2]) * d.scale : 0.f;
    wDiv[h2] = real ? expf(-mt[grow + tr[h2]]) : 1.f;
  }
  for (int s = tid; s < d.Lp; s += kThreads)
    gs[s] = s < len ? g[grow + s] : kNeg;
  if (tid < RB) rM[tid] = t0 + tid < len ? Mt[grow + t0 + tid] : 0.f;

  // den and dh.num: parity p takes key tiles P kg + p at or below the
  // diagonal, q k^T over the Dq pieces, then dh v^T over the Dv pieces
  float sc[4][4], scx[4][4], ec[4][4], ecx[4][4];
  float sums[4] = {0.f, 0.f, 0.f, 0.f};  // W's row sums, W dh.v's
  const int nA = nDq + nDv;
  pipeline(
      nKG * nA, ring, slotF,
      [&](int i, float* sl) {
        const int kg = i / nA, r = i % nA;
        const bool isq = r < nDq;
        const int D = isq ? d.Dq : d.Dv, vec = isq ? vec_q : vec_v;
        const int c0 = kPiece * (isq ? r : r - nDq);
        load_piece<kPiece, T>(sl, kLdA, isq ? qc : dhc, D, t0, RB, len, c0,
                              D, vec);
        for (int p = 0; p < P; ++p) {
          const int kt = P * kg + p;
          if (kt < nKT)
            load_piece<kPiece, T>(sl + p * pieceF + RB * kLdA, kLdA,
                                  isq ? kc : vc, D, kPiece * kt, kPiece, len,
                                  c0, D, vec);
        }
      },
      [&](int i, const float* sl) {
        const int kg = i / nA, r = i % nA;
        const int kt = P * kg + par;
        if (r == 0) {
          zero(sc); zero(scx); zero(ec); zero(ecx);
        }
        // a warp whose rows all lie above its key tile skips it
        if (kt < nKT && kPiece * kt <= ta + 15 && rows_real) {
          const float* Ap = sl + 16 * rg * kLdA;
          const float* Bp = sl + par * pieceF + RB * kLdA;
          if (r < nDq) mma_abt(sc, scx, Ap, kLdA, Bp, 1.f, 1.f);
          else mma_abt(ec, ecx, Ap, kLdA, Bp, 1.f, 1.f);
          if (r + 1 == nA) {
            // W = scale (q.k) exp(g_s - M_t) on s <= t
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int h2 = e / 2, tt = tr[h2];
                const int s = kPiece * kt + 8 * j + 2 * t + e % 2;
                const float ev = ec[j][e] + ecx[j][e];
                float w = 0.f;
                if (s <= tt && tt < len)
                  w = (sc[j][e] + scx[j][e]) * d.scale *
                      expf(gs[s] - wM[h2]);
                sums[h2] += w;
                sums[2 + h2] += w * ev;
                E[(16 * rg + g4 + 8 * h2) * ldE + s] = ev;
              }
          }
        }
      });
  hand_over(sums, part, P, RG, par);

  // the carry: Y = dh C_c^T (kept for dq) over jobs of 32 columns of Dq,
  // parity p taking the Dv pieces P rg + p; q.Y and q.n_c
  float acc[4][4], accx[4][4];
  float qY[2] = {0.f, 0.f}, qn[2] = {0.f, 0.f};
  if (carry) {
    const int nRG = (nDv + P - 1) / P;
    pipeline(
        nDq * nRG, ring, slotF,
        [&](int i, float* sl) {
          const int j = i / nRG, rgp = i % nRG;
          for (int p = 0; p < P; ++p) {
            const int r = P * rgp + p;
            if (r < nDv) {
              load_piece<kPiece, T>(sl + p * pieceF, kLdA, dhc, d.Dv, t0, RB,
                                    len, kPiece * r, d.Dv, vec_v);
              load_piece<kPiece, float>(sl + p * pieceF + RB * kLdA, kLdA,
                                        Cc, d.Dv, kPiece * j, kPiece, d.Dq,
                                        kPiece * r, d.Dv, vec_s);
            }
          }
        },
        [&](int i, const float* sl) {
          const int j = i / nRG, rgp = i % nRG;
          const int r = P * rgp + par;
          if (rgp == 0) {
            zero(acc); zero(accx);
          }
          if (r < nDv && rows_real)
            mma_abt(acc, accx, sl + par * pieceF + 16 * rg * kLdA, kLdA,
                    sl + par * pieceF + RB * kLdA, 1.f, 1.f);
          if (rgp + 1 == nRG) {
            float (&y)[16] = fold(acc, accx);
            hand_over(y, part, P, RG, par);
            if (par == 0) {
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int h2 = e / 2, tt = tr[h2];
                  const int col = kPiece * j + 8 * jj + 2 * t + e % 2;
                  if (tt < len && col < d.Dq) {
                    const float yv = y[4 * jj + e];
                    const float qv =
                        to_f32(qc[static_cast<size_t>(tt) * d.Dq + col]);
                    Ybuf[(grow + tt) * d.Dq + col] = yv;
                    qY[h2] += yv * qv;
                    qn[h2] += qv * nc[col];
                  }
                }
            }
          }
        });
  }

  // the row scalars: sums over the quad, then inv_t and dd_t
  if (par == 0) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      sums[h2] = quad_sum(sums[h2]);
      sums[2 + h2] = quad_sum(sums[2 + h2]);
      qY[h2] = quad_sum(qY[h2]);
      qn[h2] = quad_sum(qn[h2]);
    }
    if (t == 0) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int tt = tr[h2];
        float inv = 0.f, ddv = 0.f;
        if (tt < len) {
          const float den = wWc[h2] * qn[h2] + sums[h2];
          const float num = wWc[h2] * qY[h2] + sums[2 + h2];
          const float clamp = wDiv[h2];
          const bool active = fabsf(den) > clamp;
          inv = 1.f / fmaxf(fabsf(den), clamp);
          ddv = active ? -copysignf(1.f, den) * num * inv * inv : 0.f;
          inv_out[grow + tt] = inv;
          dd_out[grow + tt] = ddv;
        }
        rInv[16 * rg + g4 + 8 * h2] = inv;
        rDD[16 * rg + g4 + 8 * h2] = ddv;
      }
    }
  }
  __syncthreads();

  // the weights of dq: D_ts scale (v_s.delta_t + dd_t), in place of dh.v
  const int ncols = nKT * kPiece;
  for (int e = tid; e < RB * ncols; e += kThreads) {
    const int r = e / ncols, s = e - r * ncols, tt = t0 + r;
    float w = 0.f;
    if (s <= tt && tt < len)
      w = expf(gs[s] - rM[r]) * d.scale * (E[r * ldE + s] * rInv[r] + rDD[r]);
    E[r * ldE + s] = w;
  }

  // dq over jobs of 32 columns (parity p taking key tiles P kg + p), and
  // q.dq
  float Rp[2] = {0.f, 0.f};
  pipeline(
      nDq * nKG, ring, slotF,
      [&](int i, float* sl) {
        const int j = i / nKG, kg = i % nKG;
        for (int p = 0; p < P; ++p) {
          const int kt = P * kg + p;
          if (kt < nKT)
            load_piece<kPiece, T>(sl + p * pieceF, kLdB, kc, d.Dq,
                                  kPiece * kt, kPiece, len, kPiece * j, d.Dq,
                                  vec_q);
        }
      },
      [&](int i, const float* sl) {
        const int j = i / nKG, kg = i % nKG;
        const int kt = P * kg + par;
        if (kg == 0) {
          zero(acc); zero(accx);
        }
        if (kt < nKT && kPiece * kt <= ta + 15 && rows_real)
          mma_ab(acc, accx, E + 16 * rg * ldE + kPiece * kt, ldE,
                 sl + par * pieceF, 1.f, 1.f);
        if (kg + 1 == nKG) {
          float (&y)[16] = fold(acc, accx);
          hand_over(y, part, P, RG, par);
          if (par == 0) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int h2 = e / 2, tt = tr[h2], row = 16 * rg + g4 + 8 * h2;
                const int col = kPiece * j + 8 * jj + 2 * t + e % 2;
                if (tt < len && col < d.Dq) {
                  float x = y[4 * jj + e];
                  if (carry)
                    x += wWc[h2] *
                         (rInv[row] * Ybuf[(grow + tt) * d.Dq + col] +
                          rDD[row] * nc[col]);
                  Rp[h2] +=
                      x * to_f32(qc[static_cast<size_t>(tt) * d.Dq + col]);
                  dq[(off + tt) * d.Dq + col] = from_f32<T>(x);
                }
              }
          }
        }
      });
  if (par == 0) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) Rp[h2] = quad_sum(Rp[h2]);
    if (t == 0)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
        if (tr[h2] < len) R_out[grow + tr[h2]] = Rp[h2];
  }
}

// 4. a chunk's 16 keys: dk, dv and k.dk; the last block of a (b, h) also
// dlog_f
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_cols_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dh,
                const float* __restrict__ g, const float* __restrict__ Mt,
                const float* __restrict__ inv, const float* __restrict__ dd,
                const float* __restrict__ R, const float* __restrict__ Gst,
                const float* __restrict__ dnst, T* __restrict__ dk,
                T* __restrict__ dv, float* __restrict__ dlf,
                float* __restrict__ dli, int* __restrict__ ticket, Dims d,
                int vec_q, int vec_v, int vec_s) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int last;
  // one row group of 16 keys, P = 4 parities (a warp each)
  constexpr int P = 4, RB = 16;
  const int ldE = d.Lp + 8;
  const int pieceF = piece_floats(1), slotF = P * pieceF;
  float* ring = smem;                // [2][slotF]
  float* bufC = ring + 2 * slotF;    // [RB][ldE]: dk's weights
  float* bufP = bufC + RB * ldE;     //            dv's
  float* part = bufP + RB * ldE;     // the hand-over
  float* tM = part + part_floats(1);  // [Lp] per position: M_t,
  float* tInv = tM + d.Lp;            //                    inv_t,
  float* tDD = tInv + d.Lp;           //                    dd_t
  const int c = blockIdx.y, bh = blockIdx.z;
  const int s0 = blockIdx.x * RB, base = c * d.L;
  const int len = min(d.L, d.S - base);
  const int tid = threadIdx.x;
  if (s0 < len) {
    const int lane = tid % 32, warp = tid / 32;
    const int g4 = lane / 4, t = lane % 4;
    const int par = warp;
    const size_t off = static_cast<size_t>(bh) * d.S + base;
    const T* qc = q + off * d.Dq;
    const T* kc = k + off * d.Dq;
    const T* vc = v + off * d.Dv;
    const T* dhc = dh + off * d.Dv;
    const size_t grow = static_cast<size_t>(bh) * d.Sp + base;
    const bool carry_in = c + 1 < d.nC;
    const float* G = Gst + (static_cast<size_t>(bh) * d.nC + c) * d.Dq * d.Dv;
    const float* dn = dnst + (static_cast<size_t>(bh) * d.nC + c) * d.Dq;
    const float ML = Mt[grow + d.L - 1];
    const int nDq = (d.Dq + kPiece - 1) / kPiece;
    const int nDv = (d.Dv + kPiece - 1) / kPiece;
    const int ks[2] = {s0 + g4, s0 + g4 + 8};  // this thread's keys
    float kG[2], kWv[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const bool real = ks[h2] < len;
      kG[h2] = real ? g[grow + ks[h2]] : kNeg;
      kWv[h2] = real && carry_in ? expf(kG[h2] - ML) : 0.f;
    }
    for (int tt = tid; tt < d.Lp; tt += kThreads) {
      const bool ok = tt < len;
      tM[tt] = ok ? Mt[grow + tt] : 0.f;
      tInv[tt] = ok ? inv[grow + tt] : 0.f;
      tDD[tt] = ok ? dd[grow + tt] : 0.f;
    }
    // the row tiles at or after the block's first key
    const int kt0 = s0 / kPiece, nT = (len + kPiece - 1) / kPiece;
    const int nTT = nT - kt0, nTG = (nTT + P - 1) / P;
    float sc[4][4], scx[4][4], ec[4][4], ecx[4][4];

    // the weights: parity p takes row tiles kt0 + P kg + p, k q^T over the
    // Dq pieces, then v dh^T over the Dv pieces
    const int nA = nDq + nDv;
    pipeline(
        nTG * nA, ring, slotF,
        [&](int i, float* sl) {
          const int kg = i / nA, r = i % nA;
          const bool isk = r < nDq;
          const int D = isk ? d.Dq : d.Dv, vec = isk ? vec_q : vec_v;
          const int c0 = kPiece * (isk ? r : r - nDq);
          load_piece<kPiece, T>(sl, kLdA, isk ? kc : vc, D, s0, RB, len, c0,
                                D, vec);
          for (int p = 0; p < P; ++p) {
            const int kt = kt0 + P * kg + p;
            if (kt < nT)
              load_piece<kPiece, T>(sl + p * pieceF + RB * kLdA, kLdA,
                                    isk ? qc : dhc, D, kPiece * kt, kPiece,
                                    len, c0, D, vec);
          }
        },
        [&](int i, const float* sl) {
          const int kg = i / nA, r = i % nA;
          const int kt = kt0 + P * kg + par;
          if (r == 0) {
            zero(sc); zero(scx); zero(ec); zero(ecx);
          }
          if (kt < nT) {
            const float* Ap = sl;
            const float* Bp = sl + par * pieceF + RB * kLdA;
            if (r < nDq) mma_abt(sc, scx, Ap, kLdA, Bp, 1.f, 1.f);
            else mma_abt(ec, ecx, Ap, kLdA, Bp, 1.f, 1.f);
            if (r + 1 == nA) {
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int h2 = e / 2, s = ks[h2];
                  const int tt = kPiece * kt + 8 * j + 2 * t + e % 2;
                  const float w = s <= tt && tt < len
                                      ? expf(kG[h2] - tM[tt]) * d.scale
                                      : 0.f;
                  const int at = (g4 + 8 * h2) * ldE + tt;
                  bufC[at] = w * ((ec[j][e] + ecx[j][e]) * tInv[tt] + tDD[tt]);
                  bufP[at] = w * (sc[j][e] + scx[j][e]) * tInv[tt];
                }
            }
          }
        });

    // dk, then dv, over jobs of 32 columns; a job's depth steps are the row
    // tiles (the weights times q or dh) and, with the carry, the pieces of
    // Dv (wv v G^T) or Dq (wv k G); parity p takes steps P kg + p
    const int nS1 = nTT + (carry_in ? nDv : 0), nG1 = (nS1 + P - 1) / P;
    const int nS2 = nTT + (carry_in ? nDq : 0), nG2 = (nS2 + P - 1) / P;
    const int n1 = nDq * nG1, n2 = nDv * nG2;
    float acc[4][4], accx[4][4];
    float Lp2[2] = {0.f, 0.f};
    pipeline(
        n1 + n2, ring, slotF,
        [&](int i, float* sl) {
          const bool isdk = i < n1;
          const int nG = isdk ? nG1 : nG2, i2 = isdk ? i : i - n1;
          const int j = i2 / nG, kg = i2 % nG;
          for (int p = 0; p < P; ++p) {
            const int u = P * kg + p;
            float* Ad = sl + p * pieceF;
            float* Bd = Ad + RB * kLdA;
            if (u < nTT) {
              load_piece<kPiece, T>(Bd, kLdB, isdk ? qc : dhc,
                                    isdk ? d.Dq : d.Dv, kPiece * (kt0 + u),
                                    kPiece, len, kPiece * j,
                                    isdk ? d.Dq : d.Dv, isdk ? vec_q : vec_v);
            } else if (isdk && u < nS1) {
              const int r = u - nTT;
              load_piece<kPiece, T>(Ad, kLdA, vc, d.Dv, s0, RB, len,
                                    kPiece * r, d.Dv, vec_v);
              load_piece<kPiece, float>(Bd, kLdA, G, d.Dv, kPiece * j,
                                        kPiece, d.Dq, kPiece * r, d.Dv,
                                        vec_s);
            } else if (!isdk && u < nS2) {
              const int r = u - nTT;
              load_piece<kPiece, T>(Ad, kLdA, kc, d.Dq, s0, RB, len,
                                    kPiece * r, d.Dq, vec_q);
              load_piece<kPiece, float>(Bd, kLdB, G, d.Dv, kPiece * r,
                                        kPiece, d.Dq, kPiece * j, d.Dv,
                                        vec_s);
            }
          }
        },
        [&](int i, const float* sl) {
          const bool isdk = i < n1;
          const int nG = isdk ? nG1 : nG2, i2 = isdk ? i : i - n1;
          const int j = i2 / nG, kg = i2 % nG;
          const int u = P * kg + par;
          const float* Ad = sl + par * pieceF;
          const float* Bd = Ad + RB * kLdA;
          if (kg == 0) {
            zero(acc); zero(accx);
          }
          if (u < nTT) {
            mma_ab(acc, accx, (isdk ? bufC : bufP) + kPiece * (kt0 + u), ldE,
                   Bd, 1.f, 1.f);
          } else if (u < (isdk ? nS1 : nS2)) {
            if (isdk)
              mma_abt(acc, accx, Ad, kLdA, Bd, kWv[0], kWv[1]);
            else
              mma_ab(acc, accx, Ad, kLdA, Bd, kWv[0], kWv[1]);
          }
          if (kg + 1 == nG) {
            float (&y)[16] = fold(acc, accx);
            hand_over(y, part, P, 1, par);
            if (par == 0) {
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int h2 = e / 2, s = ks[h2];
                  const int col = kPiece * j + 8 * jj + 2 * t + e % 2;
                  if (s >= len) continue;
                  if (isdk && col < d.Dq) {
                    float x = y[4 * jj + e];
                    if (carry_in) x += kWv[h2] * dn[col];
                    Lp2[h2] +=
                        x * to_f32(kc[static_cast<size_t>(s) * d.Dq + col]);
                    dk[(off + s) * d.Dq + col] = from_f32<T>(x);
                  } else if (!isdk && col < d.Dv) {
                    dv[(off + s) * d.Dv + col] = from_f32<T>(y[4 * jj + e]);
                  }
                }
            }
          }
        });
    if (par == 0) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) Lp2[h2] = quad_sum(Lp2[h2]);
      if (t == 0)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
          if (ks[h2] < len) dli[off + ks[h2]] = Lp2[h2];
    }
  }

  // the (b, h)'s last block: dlog_f_r = sum_{t >= r} (R_t - Li_t), thread
  // i over a segment of consecutive positions, after the sums of the
  // segments that follow it, in that order
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(ticket + bh, 1) == static_cast<int>(gridDim.x *
                                                         gridDim.y) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* tot = part;
  const size_t out = static_cast<size_t>(bh) * d.S;
  const size_t row = static_cast<size_t>(bh) * d.Sp;
  const int seg = (d.S + kThreads - 1) / kThreads;
  const int a0 = min(d.S, tid * seg), a1 = min(d.S, a0 + seg);
  float sum = 0.f;
  for (int t = a1 - 1; t >= a0; --t) sum += R[row + t] - __ldcg(dli + out + t);
  tot[tid] = sum;
  __syncthreads();
  float run = 0.f;
  for (int u = kThreads - 1; u > tid; --u) run += tot[u];
  for (int t = a1 - 1; t >= a0; --t) {
    const float li_t = __ldcg(dli + out + t);
    run += R[row + t] - li_t;
    dlf[out + t] = run;
  }
}

// 16-byte aligned (cp.async's loads)
bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename E>
int launch_all(const void* q_, const void* k_, const void* v_,
               const float* lf, const float* li, const void* dh_, void* dq_,
               void* dk_, void* dv_, float* dlf, float* dli, float* g,
               float* Mt, float* mt, float* mchain, float* Cst, float* nst,
               float* Gst, float* dnst, float* Ybuf, float* inv, float* dd,
               float* R, int* ticket, const Dims& d, cudaStream_t st) {
  const E* q = static_cast<const E*>(q_);
  const E* k = static_cast<const E*>(k_);
  const E* v = static_cast<const E*>(v_);
  const E* dh = static_cast<const E*>(dh_);
  E* dq = static_cast<E*>(dq_);
  E* dk = static_cast<E*>(dk_);
  E* dv = static_cast<E*>(dv_);
  // tiles from the head dims: 16 x 16 state tiles where Dq and Dv are at
  // most 32, else 32 x 32
  const bool small = d.Dq <= 32 && d.Dv <= 32;
  const int TS = small ? 16 : 32;
  // the rows kernel's blocks: 32 rows where the head dims exceed 32 (half
  // the reads of k, v and C_c), else 16; the columns kernel's always 16
  // keys (measured faster at the train shape: more blocks an SM)
  const int RGr = small ? 1 : 2;
  const size_t sizes[4] = {walk_smem_bytes(d.Lp), rows_smem_bytes(RGr, d.Lp),
                           walk_smem_bytes(d.Lp), cols_smem_bytes(d.Lp)};
  if (sizes[1] > kSmemMax || sizes[3] > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernels[4] = {
      reinterpret_cast<const void*>(bwd_fstates_kernel<E>),
      reinterpret_cast<const void*>(bwd_rows_kernel<E>),
      reinterpret_cast<const void*>(bwd_dstates_kernel<E>),
      reinterpret_cast<const void*>(bwd_cols_kernel<E>)};
  // the dynamic shared-memory limits, raised once per device to the
  // largest a call has asked for, so a call inside a CUDA graph capture
  // makes no attribute call
  static size_t raised[64][4] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t* lim = raised[dev >= 0 && dev < 64 ? dev : 0];
  for (int i = 0; i < 4; ++i) {
    if (sizes[i] > lim[i]) {
      err = cudaFuncSetAttribute(kernels[i],
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(sizes[i]));
      if (err != cudaSuccess) return static_cast<int>(err);
      lim[i] = sizes[i];
    }
  }
  const bool f32 = sizeof(E) == 4;
  const int vec_q = f32 && d.Dq % 4 == 0 && aligned(q) && aligned(k);
  const int vec_v = f32 && d.Dv % 4 == 0 && aligned(v) && aligned(dh);
  const int vec_s = d.Dv % 4 == 0;  // the states (torch's allocations)
  const int vec_f = f32 && d.Dq % 4 == 0 && d.Dv % 4 == 0 && aligned(k) &&
                    aligned(v);
  const int vec_r = f32 && d.Dq % 4 == 0 && d.Dv % 4 == 0 && aligned(q) &&
                    aligned(dh);

  const dim3 tiles((d.Dv + TS - 1) / TS, (d.Dq + TS - 1) / TS, d.BH);
  const dim3 rblocks((d.L + 16 * RGr - 1) / (16 * RGr), d.nC, d.BH);
  const dim3 cblocks((d.L + 15) / 16, d.nC, d.BH);
  bwd_fstates_kernel<E><<<tiles, kThreads, sizes[0], st>>>(
      k, v, lf, li, g, Mt, mt, mchain, Cst, nst, ticket, d, TS, vec_f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_rows_kernel<E><<<rblocks, kThreads, sizes[1], st>>>(
      q, k, v, dh, g, Mt, mt, mchain, Cst, nst, Ybuf, inv, dd, R, dq, d, RGr,
      vec_q, vec_v, vec_s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dstates_kernel<E><<<tiles, kThreads, sizes[2], st>>>(
      q, dh, Mt, mchain, inv, dd, Gst, dnst, d, TS, vec_r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_cols_kernel<E><<<cblocks, kThreads, sizes[3], st>>>(
      q, k, v, dh, g, Mt, inv, dd, R, Gst, dnst, dk, dv, dlf, dli, ticket, d,
      vec_q, vec_v, vec_s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k (BH, S, Dq), v, dh (BH, S, Dv) contiguous in one type (bf16 != 0:
// bfloat16, else float32); log_f, log_i (BH, S) float32.  Outputs dq, dk,
// dv in the inputs' type, dlog_f, dlog_i (BH, S) float32.  Scratch, all
// float32 (Sp = ceil(S / L) L, nC = ceil(S / L)) but the tickets: g, Mt, mt
// (BH, Sp); mchain (BH, nC + 1); Cst (BH, nC, Dq, Dv); nst (BH, nC, Dq);
// Gst (BH, nC, Dq, Dv); dnst (BH, nC, Dq); Ybuf (BH, Sp, Dq); inv, dd, R
// (BH, Sp); ticket (BH) int32.  The states as torch allocates them
// (16-byte aligned).  The columns kernel's shared memory must fit the
// card (kernels/mlstm_chunk.py: bwd_smem_bytes checks).  Returns the
// cudaError_t of the first call that fails, else of the last launch.
int mlstm_chunk_bwd_launch(const void* q, const void* k, const void* v,
                           const float* log_f, const float* log_i,
                           const void* dh, void* dq, void* dk, void* dv,
                           float* dlog_f, float* dlog_i, float* g, float* Mt,
                           float* mt, float* mchain, float* Cst, float* nst,
                           float* Gst, float* dnst, float* Ybuf, float* inv,
                           float* dd, float* R, int* ticket, int BH, int S,
                           int Dq, int Dv, int L, int bf16, void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  Dims d;
  d.BH = BH;
  d.S = S;
  d.Dq = Dq;
  d.Dv = Dv;
  d.L = L;
  d.nC = (S + L - 1) / L;
  d.Lp = (L + kPiece - 1) / kPiece * kPiece;
  d.Sp = d.nC * L;
  d.scale = 1.f / sqrtf(static_cast<float>(Dq));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_all<__nv_bfloat16>(q, k, v, log_f, log_i, dh, dq, dk, dv,
                                     dlog_f, dlog_i, g, Mt, mt, mchain, Cst,
                                     nst, Gst, dnst, Ybuf, inv, dd, R, ticket,
                                     d, st);
  return launch_all<float>(q, k, v, log_f, log_i, dh, dq, dk, dv, dlog_f,
                           dlog_i, g, Mt, mt, mchain, Cst, nst, Gst, dnst,
                           Ybuf, inv, dd, R, ticket, d, st);
}

}  // extern "C"

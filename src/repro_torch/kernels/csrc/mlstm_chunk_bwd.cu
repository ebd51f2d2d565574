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
// S = 1024, Dq = Dv = 512, chunk 256) one call needs 43 GFLOP on the
// float32 CUDA cores (chip_smoke.py: mlstm_bwd_flops counts them), 0.64 ms
// at 67 TFLOP/s, against 117 MB of inputs and outputs (35 us).
//
// Design: six launches on the stream, each a simple SIMT kernel with
// float32 accumulation (tensor cores wait for a later version):
//   1. gates (one thread a (b, h)): the forward's stabilizer chain again:
//      g, M_t, m_t per position, M_L and the chunk-start m per chunk.
//   2. fstates (a block a 64 x 64 tile of C, over the chunks in order):
//      the stabilized chunk-start states C_c, n_c, recomputed rather
//      than saved (64 MB of float32 at the train shape per layer, made
//      in about as long as the forward's states part takes).
//   3. rows (a block 64 positions t of one chunk): den_t and dh_t.num_t,
//      the row scalars, then dq_t (all Dq columns) and q_t.dq_t.
//   4. dstates (a block a 64 x 64 tile of G, over the chunks in
//      reverse): G_{c+1} and dn_{c+1} for each chunk c.  This is the Dv
//      split: each column block of G depends only on its own columns of
//      dh (and of v through dk), so no block needs another's.
//   5. columns (a block 64 positions s of one chunk): dk_s, dv_s (all
//      columns) and k_s.dk_s.
//   6. dgates (one thread a (b, h)): the suffix sums of dlog_f.
// Every block owns whole rows of its outputs and sums in one fixed
// order: no atomics, so two launches give the same bits.  Products are
// 64 x 64 output tiles from 32-deep shared-memory slabs, a thread 4 x 4
// outputs; the rows and columns kernels keep their (64, chunk) float32
// weights in dynamic shared memory (kernels/mlstm_chunk.py:
// bwd_smem_bytes).  expf is the accurate one (never --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;          // output tile (mlstm_chunk.py BWD_TILE)
constexpr int kKS = 32;         // slab depth (BWD_SLAB)
constexpr int kPad = 65;        // slab row stride (BWD_PAD)
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;  // mlstm_chunk.py NEG
// load_d's row scale when there is none
constexpr const float* kNoScale = nullptr;

struct Dims {
  int BH, S, Dq, Dv, L, nC, Lp, Sp;
  float scale;
};

template <typename E>
__device__ __forceinline__ float ld(const E* p);
template <>
__device__ __forceinline__ float ld<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <typename E>
__device__ __forceinline__ void st(E* p, float v);
template <>
__device__ __forceinline__ void st<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void st<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// a sum over the 16 lanes of a half warp that share a thread row ty
__device__ __forceinline__ float half_warp_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

// dst[kk][r] = M[(r0 + r) * ldm + k0 + kk] for rows r0 + r < rows and
// columns k0 + kk < cols, else 0: a 64-row, 32-deep slab of a row-major
// matrix, transposed so the depth comes first
template <typename E>
__device__ __forceinline__ void load_t(float (*dst)[kPad], const E* M,
                                       int ldm, int r0, int rows, int k0,
                                       int cols) {
  for (int e = threadIdx.x; e < kT * kKS; e += kThreads) {
    const int r = e / kKS, kk = e % kKS;
    const int row = r0 + r, col = k0 + kk;
    dst[kk][r] = row < rows && col < cols
                     ? ld(M + static_cast<size_t>(row) * ldm + col) : 0.f;
  }
}

// dst[kk][c] = M[(k0 + kk) * ldm + c0 + c] * w[kk] for rows k0 + kk < rows
// and columns c0 + c < cols, else 0: a 32-deep slab of 64 columns, each
// depth row scaled by w (nullptr: 1)
template <typename E>
__device__ __forceinline__ void load_d(float (*dst)[kPad], const E* M,
                                       int ldm, int k0, int rows, int c0,
                                       int cols, const float* w) {
  for (int e = threadIdx.x; e < kT * kKS; e += kThreads) {
    const int kk = e / kT, c = e % kT;
    const int row = k0 + kk, col = c0 + c;
    float v = 0.f;
    if (row < rows && col < cols) {
      v = ld(M + static_cast<size_t>(row) * ldm + col);
      if (w != nullptr) v *= w[kk];
    }
    dst[kk][c] = v;
  }
}

// acc[i][j] += sum_kk A[kk][ty + 16 i] B[kk][tx + 16 j]
__device__ __forceinline__ void mma_slab(float acc[4][4],
                                         const float (*A)[kPad],
                                         const float (*B)[kPad], int ty,
                                         int tx) {
#pragma unroll 8
  for (int kk = 0; kk < kKS; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_kk buf[(ty + 16 i) * ldb + k0 + kk] B[kk][tx + 16 j]:
// the A operand read in place from a row-major shared buffer
__device__ __forceinline__ void mma_buf(float acc[4][4], const float* buf,
                                        int ldb, int k0,
                                        const float (*B)[kPad], int ty,
                                        int tx) {
#pragma unroll 8
  for (int kk = 0; kk < kKS; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = buf[(ty + 16 * i) * ldb + k0 + kk];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// the valid positions of chunk c: a prefix of its L
__device__ __forceinline__ int chunk_len(const Dims& d, int c) {
  return min(d.L, d.S - c * d.L);
}

// 1. the stabilizer chain, one thread a (b, h), as the forward computes it
__global__ void bwd_gates_kernel(const float* __restrict__ log_f,
                             const float* __restrict__ log_i,
                             float* __restrict__ g, float* __restrict__ Mt,
                             float* __restrict__ mt, float* __restrict__ ML,
                             float* __restrict__ mchain, Dims d) {
  const int bh = blockIdx.x * blockDim.x + threadIdx.x;
  if (bh >= d.BH) return;
  const float* lf = log_f + static_cast<size_t>(bh) * d.S;
  const float* li = log_i + static_cast<size_t>(bh) * d.S;
  const size_t row = static_cast<size_t>(bh) * d.Sp;
  float m = kNeg;
  mchain[bh * (d.nC + 1)] = m;
  for (int c = 0; c < d.nC; ++c) {
    float F = 0.f, run = m;
    for (int p = 0; p < d.L; ++p) {
      const int t = c * d.L + p;
      const float lfv = t < d.S ? lf[t] : 0.f;     // padding: f = 1
      const float liv = t < d.S ? li[t] : kNeg;    //          i = 0
      F += lfv;
      const float gv = liv - F;
      run = fmaxf(run, gv);
      g[row + t] = gv;
      Mt[row + t] = run;
      mt[row + t] = F + run;
    }
    ML[bh * d.nC + c] = run;
    m = F + run;
    mchain[bh * (d.nC + 1) + c + 1] = m;
  }
}

// 2. the stabilized chunk-start states: Cst[c], nst[c] for c >= 1
template <typename E>
__global__ void __launch_bounds__(kThreads)
bwd_fstates_kernel(const E* __restrict__ k, const E* __restrict__ v,
               const float* __restrict__ g, const float* __restrict__ ML,
               const float* __restrict__ mchain, float* __restrict__ Cst,
               float* __restrict__ nst, Dims d) {
  __shared__ float As[kKS][kPad], Bs[kKS][kPad];
  __shared__ float w[kKS];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int v0 = blockIdx.x * kT, d0 = blockIdx.y * kT, bh = blockIdx.z;
  const bool with_n = blockIdx.x == 0;
  const E* kb = k + static_cast<size_t>(bh) * d.S * d.Dq;
  const E* vb = v + static_cast<size_t>(bh) * d.S * d.Dv;
  float acc[4][4];
  zero(acc);
  float nacc = 0.f;
  for (int c = 0; c + 1 < d.nC; ++c) {
    const float ml = ML[bh * d.nC + c];
    const float decay = expf(mchain[bh * (d.nC + 1) + c] - ml);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= decay;
    nacc *= decay;
    const int lim = chunk_len(d, c);
    const E* kc = kb + static_cast<size_t>(c) * d.L * d.Dq;
    const E* vc = vb + static_cast<size_t>(c) * d.L * d.Dv;
    for (int p0 = 0; p0 < lim; p0 += kKS) {
      __syncthreads();
      if (tid < kKS) {
        const int p = p0 + tid;
        w[tid] = p < lim
                     ? expf(g[static_cast<size_t>(bh) * d.Sp + c * d.L + p] -
                            ml)
                     : 0.f;
      }
      __syncthreads();
      load_d(As, kc, d.Dq, p0, lim, d0, d.Dq, w);
      load_d(Bs, vc, d.Dv, p0, lim, v0, d.Dv, kNoScale);
      __syncthreads();
      mma_slab(acc, As, Bs, ty, tx);
      if (with_n && tid < kT)
        for (int kk = 0; kk < kKS; ++kk) nacc += As[kk][tid];
    }
    float* C = Cst + (static_cast<size_t>(bh) * d.nC + c + 1) * d.Dq * d.Dv;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = d0 + ty + 16 * i, col = v0 + tx + 16 * j;
        if (r < d.Dq && col < d.Dv)
          C[static_cast<size_t>(r) * d.Dv + col] = acc[i][j];
      }
    if (with_n && tid < kT && d0 + tid < d.Dq)
      nst[(static_cast<size_t>(bh) * d.nC + c + 1) * d.Dq + d0 + tid] = nacc;
  }
}

// 3. a chunk's 64 rows: the row scalars, dq and q.dq
template <typename E>
__global__ void __launch_bounds__(kThreads)
bwd_rows_kernel(const E* __restrict__ q, const E* __restrict__ k,
            const E* __restrict__ v, const E* __restrict__ dh,
            const float* __restrict__ g, const float* __restrict__ Mt,
            const float* __restrict__ mt, const float* __restrict__ mchain,
            const float* __restrict__ Cst, const float* __restrict__ nst,
            float* __restrict__ Ybuf, float* __restrict__ inv_out,
            float* __restrict__ dd_out, float* __restrict__ R_out,
            E* __restrict__ dq, Dims d) {
  extern __shared__ float smem[];
  float (*As)[kPad] = reinterpret_cast<float (*)[kPad]>(smem);
  float (*Bs)[kPad] = As + kKS;
  float* U = smem + 2 * kKS * kPad;          // [kT][Lp + 1]
  const int ldu = d.Lp + 1;
  __shared__ float rM[kT], rWc[kT], rDen[kT], rNum[kT], rInv[kT], rDD[kT],
      rR[kT], cG[kT];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int it = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int p0 = it * kT;
  const int lim = chunk_len(d, c);
  const size_t pos0 = static_cast<size_t>(bh) * d.Sp + c * d.L;  // chunk's
  const size_t off = static_cast<size_t>(bh) * d.S + c * d.L;    // row 0
  const E* qc = q + off * d.Dq;
  const E* kc = k + off * d.Dq;
  const E* vc = v + off * d.Dv;
  const E* dhc = dh + off * d.Dv;
  const bool carry = c > 0;
  const float mc = mchain[bh * (d.nC + 1) + c];
  if (tid < kT) {
    const int p = p0 + tid;
    rM[tid] = p < d.L ? Mt[pos0 + p] : 0.f;
    rWc[tid] = carry && p < lim ? expf(mc - Mt[pos0 + p]) * d.scale : 0.f;
    rDen[tid] = 0.f;
    rNum[tid] = 0.f;
    rR[tid] = 0.f;
  }
  float acc[4][4], acc2[4][4];

  // den and dh.num within the chunk, the causal column tiles
  for (int jt = 0; jt <= it; ++jt) {
    const int s0 = jt * kT;
    __syncthreads();
    if (tid < kT) cG[tid] = s0 + tid < lim ? g[pos0 + s0 + tid] : kNeg;
    zero(acc);
    zero(acc2);
    for (int k0 = 0; k0 < d.Dq; k0 += kKS) {
      __syncthreads();
      load_t(As, qc, d.Dq, p0, lim, k0, d.Dq);
      load_t(Bs, kc, d.Dq, s0, lim, k0, d.Dq);
      __syncthreads();
      mma_slab(acc, As, Bs, ty, tx);
    }
    for (int k0 = 0; k0 < d.Dv; k0 += kKS) {
      __syncthreads();
      load_t(As, dhc, d.Dv, p0, lim, k0, d.Dv);
      load_t(Bs, vc, d.Dv, s0, lim, k0, d.Dv);
      __syncthreads();
      mma_slab(acc2, As, Bs, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const float w = s0 + col <= p0 + r ? expf(cG[col] - rM[r]) : 0.f;
        const float ds = w * d.scale * acc[i][j];
        den += ds;
        num += ds * acc2[i][j];
        U[r * ldu + s0 + col] = acc2[i][j];
      }
      den = half_warp_sum(den);
      num = half_warp_sum(num);
      if (tx == 0) {
        rDen[r] += den;
        rNum[r] += num;
      }
    }
  }

  // the carry: Y = C_c dh_t (kept for dq), q_t.Y_t and q_t.n_c
  if (carry) {
    const float* C = Cst + (static_cast<size_t>(bh) * d.nC + c) * d.Dq * d.Dv;
    const float* nc = nst + (static_cast<size_t>(bh) * d.nC + c) * d.Dq;
    for (int d0 = 0; d0 < d.Dq; d0 += kT) {
      zero(acc);
      for (int k0 = 0; k0 < d.Dv; k0 += kKS) {
        __syncthreads();
        load_t(As, dhc, d.Dv, p0, lim, k0, d.Dv);
        load_t(Bs, C, d.Dv, d0, d.Dq, k0, d.Dv);
        __syncthreads();
        mma_slab(acc, As, Bs, ty, tx);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, p = p0 + r;
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = d0 + tx + 16 * j;
          if (p < lim && col < d.Dq) {
            part += acc[i][j] * ld(qc + static_cast<size_t>(p) * d.Dq + col);
            Ybuf[(pos0 + p) * d.Dq + col] = acc[i][j];
          }
        }
        part = half_warp_sum(part);
        if (tx == 0) rNum[r] += rWc[r] * part;
      }
    }
    __syncthreads();
    if (tid < kT && p0 + tid < lim) {
      const E* qr = qc + static_cast<size_t>(p0 + tid) * d.Dq;
      float qn = 0.f;
      for (int col = 0; col < d.Dq; ++col) qn += ld(qr + col) * nc[col];
      rDen[tid] += rWc[tid] * qn;
    }
  }
  __syncthreads();

  // the row scalars
  if (tid < kT) {
    const int p = p0 + tid;
    float inv = 0.f, ddv = 0.f;
    if (p < lim) {
      const float den = rDen[tid];
      const float clamp = expf(-mt[pos0 + p]);
      const bool active = fabsf(den) > clamp;
      inv = 1.f / fmaxf(fabsf(den), clamp);
      ddv = active ? -copysignf(1.f, den) * rNum[tid] * inv * inv : 0.f;
    }
    rInv[tid] = inv;
    rDD[tid] = ddv;
    if (p < d.L) {
      inv_out[pos0 + p] = inv;
      dd_out[pos0 + p] = ddv;
    }
  }
  __syncthreads();

  // the weights of dq: D_ts scale (v_s.delta_t + dd_t), in place of U
  const int ncols = (it + 1) * kT;
  for (int e = tid; e < kT * ncols; e += kThreads) {
    const int r = e / ncols, s = e % ncols;
    float w = 0.f;
    if (s <= p0 + r && s < lim && p0 + r < lim)
      w = expf(g[pos0 + s] - rM[r]) * d.scale *
          (U[r * ldu + s] * rInv[r] + rDD[r]);
    U[r * ldu + s] = w;
  }
  __syncthreads();

  // dq, and q.dq
  for (int d0 = 0; d0 < d.Dq; d0 += kT) {
    zero(acc);
    for (int s0 = 0; s0 < ncols; s0 += kKS) {
      __syncthreads();
      load_d(Bs, kc, d.Dq, s0, lim, d0, d.Dq, kNoScale);
      __syncthreads();
      mma_buf(acc, U, ldu, s0, Bs, ty, tx);
    }
    const float* nc = nst + (static_cast<size_t>(bh) * d.nC + c) * d.Dq;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, p = p0 + r;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = d0 + tx + 16 * j;
        if (p < lim && col < d.Dq) {
          float x = acc[i][j];
          if (carry)
            x += rWc[r] * (rInv[r] * Ybuf[(pos0 + p) * d.Dq + col] +
                           rDD[r] * nc[col]);
          part += x * ld(qc + static_cast<size_t>(p) * d.Dq + col);
          st(dq + (off + p) * d.Dq + col, x);
        }
      }
      part = half_warp_sum(part);
      if (tx == 0) rR[r] += part;
    }
  }
  __syncthreads();
  if (tid < kT && p0 + tid < d.L) R_out[pos0 + p0 + tid] = rR[tid];
}

// 4. the gradient of the stabilized chunk-start states, over the chunks in
// reverse: Gst[c], dnst[c] hold G_{c+1}, dn_{c+1} (zero for the last)
template <typename E>
__global__ void __launch_bounds__(kThreads)
bwd_dstates_kernel(const E* __restrict__ q, const E* __restrict__ dh,
               const float* __restrict__ Mt, const float* __restrict__ ML,
               const float* __restrict__ mchain,
               const float* __restrict__ inv, const float* __restrict__ dd,
               float* __restrict__ Gst, float* __restrict__ dnst, Dims d) {
  __shared__ float As[kKS][kPad], Bs[kKS][kPad];
  __shared__ float rw[kKS], rinv[kKS], rdd[kKS];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int v0 = blockIdx.x * kT, d0 = blockIdx.y * kT, bh = blockIdx.z;
  const bool with_n = blockIdx.x == 0;
  float acc[4][4];
  zero(acc);
  float dn = 0.f;
  for (int c = d.nC - 1; c >= 0; --c) {
    float* G = Gst + (static_cast<size_t>(bh) * d.nC + c) * d.Dq * d.Dv;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = d0 + ty + 16 * i, col = v0 + tx + 16 * j;
        if (r < d.Dq && col < d.Dv)
          G[static_cast<size_t>(r) * d.Dv + col] = acc[i][j];
      }
    if (with_n && tid < kT && d0 + tid < d.Dq)
      dnst[(static_cast<size_t>(bh) * d.nC + c) * d.Dq + d0 + tid] = dn;
    if (c == 0) break;                      // w_carry is 0 in chunk 0
    const float mc = mchain[bh * (d.nC + 1) + c];
    const float decay = expf(mc - ML[bh * d.nC + c]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= decay;
    dn *= decay;
    const int lim = chunk_len(d, c);
    const size_t pos0 = static_cast<size_t>(bh) * d.Sp + c * d.L;
    const size_t off = static_cast<size_t>(bh) * d.S + c * d.L;
    for (int p0 = 0; p0 < lim; p0 += kKS) {
      __syncthreads();
      if (tid < kKS) {
        const int p = p0 + tid;
        const bool ok = p < lim;
        rw[tid] = ok ? expf(mc - Mt[pos0 + p]) * d.scale : 0.f;
        rinv[tid] = ok ? inv[pos0 + p] : 0.f;
        rdd[tid] = ok ? dd[pos0 + p] : 0.f;
      }
      __syncthreads();
      load_d(As, q + off * d.Dq, d.Dq, p0, lim, d0, d.Dq, rw);
      load_d(Bs, dh + off * d.Dv, d.Dv, p0, lim, v0, d.Dv, rinv);
      __syncthreads();
      mma_slab(acc, As, Bs, ty, tx);
      if (with_n && tid < kT)
        for (int kk = 0; kk < kKS; ++kk) dn += As[kk][tid] * rdd[kk];
    }
  }
}

// 5. a chunk's 64 columns: dk, dv and k.dk
template <typename E>
__global__ void __launch_bounds__(kThreads)
bwd_cols_kernel(const E* __restrict__ q, const E* __restrict__ k,
            const E* __restrict__ v, const E* __restrict__ dh,
            const float* __restrict__ g, const float* __restrict__ Mt,
            const float* __restrict__ ML, const float* __restrict__ inv,
            const float* __restrict__ dd, const float* __restrict__ Gst,
            const float* __restrict__ dnst, float* __restrict__ Li_out,
            E* __restrict__ dk, E* __restrict__ dv, Dims d) {
  extern __shared__ float smem[];
  float (*As)[kPad] = reinterpret_cast<float (*)[kPad]>(smem);
  float (*Bs)[kPad] = As + kKS;
  const int ldu = d.Lp + 1;
  float* bufC = smem + 2 * kKS * kPad;       // [kT][Lp + 1]: dk's weights
  float* bufP = bufC + kT * ldu;             //               dv's weights
  __shared__ float cG[kT], cWv[kT], rM[kT], rInv[kT], rDD[kT], cL[kT];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int jt = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int s0 = jt * kT;
  const int lim = chunk_len(d, c);
  const size_t pos0 = static_cast<size_t>(bh) * d.Sp + c * d.L;
  const size_t off = static_cast<size_t>(bh) * d.S + c * d.L;
  const E* qc = q + off * d.Dq;
  const E* kc = k + off * d.Dq;
  const E* vc = v + off * d.Dv;
  const E* dhc = dh + off * d.Dv;
  const bool carry_in = c + 1 < d.nC;
  const float ml = ML[bh * d.nC + c];
  if (tid < kT) {
    const int s = s0 + tid;
    cG[tid] = s < lim ? g[pos0 + s] : kNeg;
    cWv[tid] = carry_in && s < lim ? expf(g[pos0 + s] - ml) : 0.f;
    cL[tid] = 0.f;
  }
  float acc[4][4], acc2[4][4];

  // the weights, over the row tiles at or below the diagonal
  for (int p0 = s0; p0 < d.Lp; p0 += kT) {
    __syncthreads();
    if (tid < kT) {
      const int p = p0 + tid;
      rM[tid] = p < d.L ? Mt[pos0 + p] : 0.f;
      rInv[tid] = p < lim ? inv[pos0 + p] : 0.f;
      rDD[tid] = p < lim ? dd[pos0 + p] : 0.f;
    }
    zero(acc);
    zero(acc2);
    for (int k0 = 0; k0 < d.Dq; k0 += kKS) {
      __syncthreads();
      load_t(As, kc, d.Dq, s0, lim, k0, d.Dq);
      load_t(Bs, qc, d.Dq, p0, lim, k0, d.Dq);
      __syncthreads();
      mma_slab(acc, As, Bs, ty, tx);
    }
    for (int k0 = 0; k0 < d.Dv; k0 += kKS) {
      __syncthreads();
      load_t(As, vc, d.Dv, s0, lim, k0, d.Dv);
      load_t(Bs, dhc, d.Dv, p0, lim, k0, d.Dv);
      __syncthreads();
      mma_slab(acc2, As, Bs, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, col = tx + 16 * j;
        const float w = s0 + r <= p0 + col
                            ? expf(cG[r] - rM[col]) * d.scale : 0.f;
        bufC[r * ldu + p0 + col] = w * (acc2[i][j] * rInv[col] + rDD[col]);
        bufP[r * ldu + p0 + col] = w * acc[i][j] * rInv[col];
      }
  }
  __syncthreads();

  const float* G = Gst + (static_cast<size_t>(bh) * d.nC + c) * d.Dq * d.Dv;
  const float* dn = dnst + (static_cast<size_t>(bh) * d.nC + c) * d.Dq;
  // dk, and k.dk
  for (int d0 = 0; d0 < d.Dq; d0 += kT) {
    zero(acc);
    for (int t0 = s0; t0 < d.Lp; t0 += kKS) {
      __syncthreads();
      load_d(Bs, qc, d.Dq, t0, lim, d0, d.Dq, kNoScale);
      __syncthreads();
      mma_buf(acc, bufC, ldu, t0, Bs, ty, tx);
    }
    zero(acc2);
    if (carry_in) {
      for (int k0 = 0; k0 < d.Dv; k0 += kKS) {
        __syncthreads();
        load_t(As, vc, d.Dv, s0, lim, k0, d.Dv);
        load_t(Bs, G, d.Dv, d0, d.Dq, k0, d.Dv);
        __syncthreads();
        mma_slab(acc2, As, Bs, ty, tx);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, s = s0 + r;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = d0 + tx + 16 * j;
        if (s < lim && col < d.Dq) {
          const float x = acc[i][j] + cWv[r] * (acc2[i][j] + dn[col]);
          part += x * ld(kc + static_cast<size_t>(s) * d.Dq + col);
          st(dk + (off + s) * d.Dq + col, x);
        }
      }
      part = half_warp_sum(part);
      if (tx == 0) cL[r] += part;
    }
  }
  // dv
  for (int v0 = 0; v0 < d.Dv; v0 += kT) {
    zero(acc);
    for (int t0 = s0; t0 < d.Lp; t0 += kKS) {
      __syncthreads();
      load_d(Bs, dhc, d.Dv, t0, lim, v0, d.Dv, kNoScale);
      __syncthreads();
      mma_buf(acc, bufP, ldu, t0, Bs, ty, tx);
    }
    zero(acc2);
    if (carry_in) {
      for (int k0 = 0; k0 < d.Dq; k0 += kKS) {
        __syncthreads();
        load_t(As, kc, d.Dq, s0, lim, k0, d.Dq);
        load_d(Bs, G, d.Dv, k0, d.Dq, v0, d.Dv, kNoScale);
        __syncthreads();
        mma_slab(acc2, As, Bs, ty, tx);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, s = s0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = v0 + tx + 16 * j;
        if (s < lim && col < d.Dv)
          st(dv + (off + s) * d.Dv + col, acc[i][j] + cWv[r] * acc2[i][j]);
      }
    }
  }
  __syncthreads();
  if (tid < kT && s0 + tid < d.L) Li_out[pos0 + s0 + tid] = cL[tid];
}

// 6. dlog_f_r = sum_{t >= r} (R_t - Li_t), dlog_i = Li; one thread a (b, h)
__global__ void bwd_dgates_kernel(const float* __restrict__ R,
                              const float* __restrict__ Li,
                              float* __restrict__ dlf,
                              float* __restrict__ dli, Dims d) {
  const int bh = blockIdx.x * blockDim.x + threadIdx.x;
  if (bh >= d.BH) return;
  const size_t row = static_cast<size_t>(bh) * d.Sp;
  const size_t out = static_cast<size_t>(bh) * d.S;
  float run = 0.f;
  for (int t = d.S - 1; t >= 0; --t) {
    const float li_t = Li[row + t];
    run += R[row + t] - li_t;
    dlf[out + t] = run;
    dli[out + t] = li_t;
  }
}

template <typename E>
int launch_all(const void* q_, const void* k_, const void* v_,
               const float* lf, const float* li, const void* dh_, void* dq_,
               void* dk_, void* dv_, float* dlf, float* dli, float* g,
               float* Mt, float* mt, float* ML, float* mchain, float* Cst,
               float* nst, float* Gst, float* dnst, float* Ybuf, float* inv,
               float* dd, float* R, float* Li, const Dims& d,
               cudaStream_t st) {
  const E* q = static_cast<const E*>(q_);
  const E* k = static_cast<const E*>(k_);
  const E* v = static_cast<const E*>(v_);
  const E* dh = static_cast<const E*>(dh_);
  E* dq = static_cast<E*>(dq_);
  E* dk = static_cast<E*>(dk_);
  E* dv = static_cast<E*>(dv_);
  const size_t slabs = 2 * kKS * kPad * sizeof(float);
  const size_t buf = static_cast<size_t>(kT) * (d.Lp + 1) * sizeof(float);
  const size_t rows_smem = slabs + buf;
  const size_t cols_smem = slabs + 2 * buf;
  // the dynamic shared-memory limits, raised once per device to the
  // largest a call has asked for, so a call inside a CUDA graph capture
  // makes no attribute call
  static size_t raised[64][2] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t* lim = raised[dev >= 0 && dev < 64 ? dev : 0];
  if (rows_smem > lim[0]) {
    err = cudaFuncSetAttribute(bwd_rows_kernel<E>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(rows_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    lim[0] = rows_smem;
  }
  if (cols_smem > lim[1]) {
    err = cudaFuncSetAttribute(bwd_cols_kernel<E>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(cols_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    lim[1] = cols_smem;
  }

  const int gate_blocks = (d.BH + 31) / 32;
  bwd_gates_kernel<<<gate_blocks, 32, 0, st>>>(lf, li, g, Mt, mt, ML, mchain,
                                               d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 tiles((d.Dv + kT - 1) / kT, (d.Dq + kT - 1) / kT, d.BH);
  if (d.nC > 1) {
    bwd_fstates_kernel<E><<<tiles, kThreads, 0, st>>>(k, v, g, ML, mchain, Cst,
                                                  nst, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 chunk_tiles(d.Lp / kT, d.nC, d.BH);
  bwd_rows_kernel<E><<<chunk_tiles, kThreads, rows_smem, st>>>(
      q, k, v, dh, g, Mt, mt, mchain, Cst, nst, Ybuf, inv, dd, R, dq, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dstates_kernel<E><<<tiles, kThreads, 0, st>>>(q, dh, Mt, ML, mchain, inv,
                                                dd, Gst, dnst, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_cols_kernel<E><<<chunk_tiles, kThreads, cols_smem, st>>>(
      q, k, v, dh, g, Mt, ML, inv, dd, Gst, dnst, Li, dk, dv, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dgates_kernel<<<gate_blocks, 32, 0, st>>>(R, Li, dlf, dli, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k (BH, S, Dq), v, dh (BH, S, Dv) contiguous in one type (bf16 != 0:
// bfloat16, else float32); log_f, log_i (BH, S) float32.  Outputs dq, dk,
// dv in the inputs' type, dlog_f, dlog_i (BH, S) float32.  Scratch, all
// float32 (Sp = ceil(S / L) L, nC = ceil(S / L)): g, Mt, mt (BH, Sp); ML
// (BH, nC); mchain (BH, nC + 1); Cst (BH, nC, Dq, Dv); nst (BH, nC, Dq);
// Gst (BH, nC, Dq, Dv); dnst (BH, nC, Dq); Ybuf (BH, Sp, Dq); inv, dd, R,
// Li (BH, Sp).  The columns kernel's shared memory must fit the card
// (kernels/mlstm_chunk.py: bwd_smem_bytes checks).  Returns the
// cudaError_t of the first call that fails, else of the last launch.
int mlstm_chunk_bwd_launch(const void* q, const void* k, const void* v,
                           const float* log_f, const float* log_i,
                           const void* dh, void* dq, void* dk, void* dv,
                           float* dlog_f, float* dlog_i, float* g, float* Mt,
                           float* mt, float* ML, float* mchain, float* Cst,
                           float* nst, float* Gst, float* dnst, float* Ybuf,
                           float* inv, float* dd, float* R, float* Li,
                           int BH, int S, int Dq, int Dv, int L, int bf16,
                           void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  Dims d;
  d.BH = BH;
  d.S = S;
  d.Dq = Dq;
  d.Dv = Dv;
  d.L = L;
  d.nC = (S + L - 1) / L;
  d.Lp = (L + kT - 1) / kT * kT;
  d.Sp = d.nC * L;
  d.scale = 1.f / sqrtf(static_cast<float>(Dq));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_all<__nv_bfloat16>(q, k, v, log_f, log_i, dh, dq, dk, dv,
                                     dlog_f, dlog_i, g, Mt, mt, ML, mchain,
                                     Cst, nst, Gst, dnst, Ybuf, inv, dd, R,
                                     Li, d, st);
  return launch_all<float>(q, k, v, log_f, log_i, dh, dq, dk, dv, dlog_f,
                           dlog_i, g, Mt, mt, ML, mchain, Cst, nst, Gst, dnst,
                           Ybuf, inv, dd, R, Li, d, st);
}

}  // extern "C"

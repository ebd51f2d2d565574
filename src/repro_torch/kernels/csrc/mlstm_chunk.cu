// mlstm_chunk — chunkwise-parallel mLSTM forward (xLSTM matrix memory) with
// stabilized log-space gates, carrying C (Dq x Dv), n (Dq) and m across
// chunks.
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
// float32.  All arithmetic is float32; FMA contraction is allowed (the
// kernel is held at a tolerance); there are no atomics, so a run is
// deterministic.
//
// Bound: bytes.  At the xlstm-350m serve shape (B = 4, H = 4, S = 1024,
// Dq = Dv = 512, L = 256, bf16) a call moves 84 MB and needs 21.5 GFLOP
// (the causal half of each L x L block), which the bf16 tensor peak would
// take a little less time for than HBM takes for the bytes.
//
// Design.  The TPU kernel keeps all of C in VMEM and walks the chunks as
// its sequential grid axis; a Hopper block has 227 KB of shared memory and
// C is 1 MiB per (b, h) at that shape.  The stabilizer chain depends on the
// gates alone, so given m every column slice of C and of h is independent:
//   1. mlstm_gates_kernel, one warp per (b, h), runs the chain over the
//      chunks (warp scans for cumsum and cummax) and writes g, Mt, m_t per
//      position, m at every chunk boundary, and the final m.
//   2. mlstm_scores_kernel, one block per (b, h, chunk, 64 x 64 tile
//      pair with s <= t), writes W (the masked, gated scores) to scratch,
//      so the score product is done once and not once per column slice.
//   3. mlstm_columns_kernel, one block per (b, h, 64 columns of Dv), keeps
//      its (Dq, 64) slice of C and all of n in shared memory and loops
//      over the chunks: h for the chunk's rows from the old C, then the
//      carry update.  Nothing carries between blocks.  n, which every
//      slice needs for den, is carried by every block (1/64 of the work).
// q, k, v and W stream through shared memory in 64 x 32 and 64 x 64
// sub-tiles; each thread holds a 4 x 4 accumulator (rows ty + 16 i,
// columns 4 tx + j).  CUDA cores only: wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kTile = 64;      // output tile: rows and columns
constexpr int kDepth = 32;     // depth of one staged sub-tile
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPad = 65;       // row stride of row-major staged tiles
constexpr int kPadT = 68;      // row stride of the transposed k tile

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

// ---------------------------------------------------------------------------
// 1. the stabilizer chain: one warp per (b, h)
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
// 2. the gated causal scores W, one 64 x 64 tile per block
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const float* __restrict__ g, const float* __restrict__ Mt,
                    float* __restrict__ W, int S, int L, int nC, int Dq,
                    int nT, float scale) {
  const int bh = blockIdx.x / nC, c = blockIdx.x % nC;
  const int tt = blockIdx.y / nT, st = blockIdx.y % nT;
  const int t0 = tt * kTile, s0 = st * kTile;
  if (st > tt || c * L + t0 >= S) return;   // above the diagonal, or padding
  __shared__ float Qs[kTile * (kDepth + 1)];   // [t][d], stride 33
  __shared__ __align__(16) float Ks[kDepth * kPadT];  // [d][s], stride 68
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* qb = q + (size_t)bh * S * Dq;
  const T* kb = k + (size_t)bh * S * Dq;
  float acc[4][4] = {};
  for (int d0 = 0; d0 < Dq; d0 += kDepth) {
    for (int e = tid; e < kTile * kDepth; e += kThreads) {
      const int r = e / kDepth, dd = e % kDepth, d = d0 + dd;
      const int tq = t0 + r, pq = c * L + tq;
      const int sk = s0 + r, pk = c * L + sk;
      Qs[r * (kDepth + 1) + dd] =
          (tq < L && pq < S && d < Dq) ? to_f32(qb[(size_t)pq * Dq + d]) : 0.f;
      Ks[dd * kPadT + r] =
          (sk < L && pk < S && d < Dq) ? to_f32(kb[(size_t)pk * Dq + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kDepth; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * (kDepth + 1) + kk];
      const float4 b = *reinterpret_cast<const float4*>(&Ks[kk * kPadT + 4 * tx]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] += a[i] * b.x;
        acc[i][1] += a[i] * b.y;
        acc[i][2] += a[i] * b.z;
        acc[i][3] += a[i] * b.w;
      }
    }
    __syncthreads();
  }
  const int Lp = nT * kTile;
  const size_t grow = ((size_t)bh * nC + c) * L;   // gate row of this chunk
  float* Wb = W + ((size_t)bh * nC + c) * Lp * Lp;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    const bool treal = t < L && c * L + t < S;
    const float mt = treal ? Mt[grow + t] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + 4 * tx + j;
      float val = 0.f;
      if (treal && s <= t) val = acc[i][j] * scale * expf(g[grow + s] - mt);
      Wb[(size_t)t * Lp + s] = val;
    }
  }
}

// ---------------------------------------------------------------------------
// 3. h and the carry, one block per (b, h, 64 columns of Dv)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_columns_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ Mt, const float* __restrict__ mt,
                     const float* __restrict__ mchain,
                     const float* __restrict__ W, const float* __restrict__ C0,
                     const float* __restrict__ n0, T* __restrict__ h,
                     float* __restrict__ C_out, float* __restrict__ n_out,
                     int S, int L, int nC, int Dq, int Dv, int nT, int DqP,
                     float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                       // [DqP][64]: this block's C slice
  float* ns = Cs + (size_t)DqP * kTile;   // [DqP]
  float* As = ns + DqP;                   // [64][65]: q, W or (wv k) tiles
  float* Bs = As + kTile * kPad;          // [64][64]: v tiles
  float* rwc = Bs + kTile * kTile;        // [64]: exp(m - Mt_t) per row
  float* rden = rwc + kTile;              // [64]: den, then the divisor
  float* wvs = rden + kTile;              // [L]: exp(g_s - ML) of the chunk
  const int jt = blockIdx.x, bh = blockIdx.y, j0 = jt * kTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* qb = q + (size_t)bh * S * Dq;
  const T* kb = k + (size_t)bh * S * Dq;
  const T* vb = v + (size_t)bh * S * Dv;
  T* hb = h + (size_t)bh * S * Dv;
  const int Lp = nT * kTile;

  for (int e = tid; e < DqP * kTile; e += kThreads) {
    const int d = e / kTile, j = j0 + e % kTile;
    Cs[e] = (C0 && d < Dq && j < Dv) ? C0[((size_t)bh * Dq + d) * Dv + j] : 0.f;
  }
  for (int d = tid; d < DqP; d += kThreads)
    ns[d] = (n0 && d < Dq) ? n0[(size_t)bh * Dq + d] : 0.f;
  __syncthreads();

  for (int c = 0; c < nC; ++c) {
    const int cb = c * L;                          // first position
    const size_t grow = ((size_t)bh * nC + c) * L;  // gate row
    const float mprev = mchain[(size_t)bh * (nC + 1) + c];
    const float* Wc = W + ((size_t)bh * nC + c) * Lp * Lp;

    // -- h for the chunk's rows, 64 at a time, from the old C and n ------
    for (int tt = 0; tt < nT; ++tt) {
      const int t0 = tt * kTile;
      if (t0 >= L || cb + t0 >= S) break;
      float acc[4][4] = {};
      float qn = 0.f;
      for (int d0 = 0; d0 < DqP; d0 += kDepth) {
        for (int e = tid; e < kTile * kDepth; e += kThreads) {
          const int r = e / kDepth, dd = e % kDepth, d = d0 + dd;
          const int t = t0 + r, p = cb + t;
          As[r * (kDepth + 1) + dd] =
              (t < L && p < S && d < Dq) ? to_f32(qb[(size_t)p * Dq + d]) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kDepth; ++kk) {
          float a[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * (kDepth + 1) + kk];
          const float4 b =
              *reinterpret_cast<const float4*>(&Cs[(d0 + kk) * kTile + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][0] += a[i] * b.x;
            acc[i][1] += a[i] * b.y;
            acc[i][2] += a[i] * b.z;
            acc[i][3] += a[i] * b.w;
          }
        }
        if (tid < kTile)
          for (int kk = 0; kk < kDepth; ++kk)
            qn += As[tid * (kDepth + 1) + kk] * ns[d0 + kk];
        __syncthreads();
      }
      if (tid < kTile) {
        const int t = t0 + tid;
        const bool real = t < L && cb + t < S;
        const float wc = real ? expf(mprev - Mt[grow + t]) : 0.f;
        rwc[tid] = wc;
        rden[tid] = wc * (qn * scale);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = rwc[ty + 16 * i] * scale;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= w;
      }
      // intra-chunk: sum over s-tiles st <= tt of W[t, s] v_s
      float dsum = 0.f;
      for (int st = 0; st <= tt; ++st) {
        const int s0 = st * kTile;
        for (int e = tid; e < kTile * kTile; e += kThreads) {
          const int r = e / kTile, cc = e % kTile;
          As[r * kPad + cc] = Wc[(size_t)(t0 + r) * Lp + s0 + cc];
          const int s = s0 + r, p = cb + s, j = j0 + cc;
          Bs[e] = (s < L && p < S && j < Dv) ? to_f32(vb[(size_t)p * Dv + j]) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kTile; ++kk) {
          float a[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * kPad + kk];
          const float4 b = *reinterpret_cast<const float4*>(&Bs[kk * kTile + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][0] += a[i] * b.x;
            acc[i][1] += a[i] * b.y;
            acc[i][2] += a[i] * b.z;
            acc[i][3] += a[i] * b.w;
          }
        }
        if (tid < kTile)
          for (int kk = 0; kk < kTile; ++kk) dsum += As[tid * kPad + kk];
        __syncthreads();
      }
      if (tid < kTile) {
        const int t = t0 + tid;
        const bool real = t < L && cb + t < S;
        const float den = rden[tid] + dsum;
        rden[tid] = real ? fmaxf(fabsf(den), expf(-mt[grow + t])) : 1.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, t = t0 + r, p = cb + t;
        if (t >= L || p >= S) continue;
        const float div = rden[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = j0 + 4 * tx + j;
          if (col < Dv) hb[(size_t)p * Dv + col] = from_f32<T>(acc[i][j] / div);
        }
      }
      __syncthreads();   // rwc / rden are rewritten by the next row tile
    }

    // -- the carry: C <- decay C + sum_s wv_s k_s v_s^T, n likewise -------
    const float ML = Mt[grow + L - 1];
    const float decay = expf(mprev - ML);
    for (int s = tid; s < L; s += kThreads)
      wvs[s] = (cb + s < S) ? expf(g[grow + s] - ML) : 0.f;
    __syncthreads();
    for (int dt0 = 0; dt0 < DqP; dt0 += kTile) {
      float acc[4][4] = {};
      float nacc = 0.f;
      for (int s0 = 0; s0 < L && cb + s0 < S; s0 += kDepth) {
        for (int e = tid; e < kDepth * kTile; e += kThreads) {
          const int r = e / kTile, cc = e % kTile;
          const int s = s0 + r, p = cb + s, d = dt0 + cc, j = j0 + cc;
          const bool real = s < L && p < S;
          As[r * kPad + cc] =
              (real && d < Dq) ? wvs[s] * to_f32(kb[(size_t)p * Dq + d]) : 0.f;
          Bs[e] = (real && j < Dv) ? to_f32(vb[(size_t)p * Dv + j]) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kDepth; ++kk) {
          float a[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = As[kk * kPad + ty + 16 * i];
          const float4 b = *reinterpret_cast<const float4*>(&Bs[kk * kTile + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][0] += a[i] * b.x;
            acc[i][1] += a[i] * b.y;
            acc[i][2] += a[i] * b.z;
            acc[i][3] += a[i] * b.w;
          }
        }
        if (tid < kTile)
          for (int kk = 0; kk < kDepth; ++kk) nacc += As[kk * kPad + tid];
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* crow = &Cs[(dt0 + ty + 16 * i) * kTile + 4 * tx];
#pragma unroll
        for (int j = 0; j < 4; ++j) crow[j] = decay * crow[j] + acc[i][j];
      }
      if (tid < kTile) ns[dt0 + tid] = decay * ns[dt0 + tid] + nacc;
    }
    __syncthreads();
  }

  for (int e = tid; e < DqP * kTile; e += kThreads) {
    const int d = e / kTile, j = j0 + e % kTile;
    if (d < Dq && j < Dv) C_out[((size_t)bh * Dq + d) * Dv + j] = Cs[e];
  }
  if (jt == 0)
    for (int d = tid; d < Dq; d += kThreads) n_out[(size_t)bh * Dq + d] = ns[d];
}

template <typename T>
cudaError_t launch_all(const void* q, const void* k, const void* v,
                       const float* lf, const float* li, const float* C0,
                       const float* n0, const float* m0, void* h, float* C,
                       float* n, float* m, float* g, float* Mt, float* mt,
                       float* mchain, float* W, int BH, int S, int Dq, int Dv,
                       int L, cudaStream_t stream) {
  const int nC = (S + L - 1) / L;
  const int nT = (L + kTile - 1) / kTile;
  const int DqP = (Dq + kTile - 1) / kTile * kTile;
  const float scale = 1.0f / sqrtf((float)Dq);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);

  mlstm_gates_kernel<<<BH, 32, 0, stream>>>(lf, li, m0, g, Mt, mt, mchain, m,
                                            S, L, nC);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  mlstm_scores_kernel<T><<<dim3(BH * nC, nT * nT), kThreads, 0, stream>>>(
      qt, kt, g, Mt, W, S, L, nC, Dq, nT, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem = sizeof(float) *
      ((size_t)DqP * kTile + DqP + kTile * kPad + kTile * kTile + 2 * kTile + L);
  err = cudaFuncSetAttribute(mlstm_columns_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  mlstm_columns_kernel<T><<<dim3((Dv + kTile - 1) / kTile, BH), kThreads, smem,
                            stream>>>(
      qt, kt, vt, g, Mt, mt, mchain, W, C0, n0, static_cast<T*>(h), C, n, S, L,
      nC, Dq, Dv, nT, DqP, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mlstm_chunk_launch(const void* q, const void* k, const void* v,
                                  const void* log_f, const void* log_i,
                                  const void* C0, const void* n0,
                                  const void* m0, void* h, void* C, void* n,
                                  void* m, void* g, void* Mt, void* mt,
                                  void* mchain, void* W, int BH, int S, int Dq,
                                  int Dv, int L, int bf16, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_all<__nv_bfloat16>(
        q, k, v, f(log_f), f(log_i), f(C0), f(n0), f(m0), h, w(C), w(n), w(m),
        w(g), w(Mt), w(mt), w(mchain), w(W), BH, S, Dq, Dv, L, st);
  return (int)launch_all<float>(
      q, k, v, f(log_f), f(log_i), f(C0), f(n0), f(m0), h, w(C), w(n), w(m),
      w(g), w(Mt), w(mt), w(mchain), w(W), BH, S, Dq, Dv, L, st);
}

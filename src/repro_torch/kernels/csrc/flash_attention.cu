// flash_attention — the forward pass of causal / sliding-window softmax
// attention with an online softmax and float32 accumulation.
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
//
// Bound: operations.  At the recurrentgemma-9b local-attention shape
// (B = 4, 16 heads, S = 3072, D = 256, window 2048, bf16) q, k, v and o are
// 403 MB (120 us at 3.35 TB/s), and the 268.5 M (q, k) pairs that the
// causal mask and the window keep need 4 D = 1024 float ops each: 274.9
// GFLOP, 278 us at the 989 TFLOP/s bf16 tensor-core peak.  This kernel
// does them on the float32 CUDA cores (67 TFLOP/s: 4.1 ms at best).
//
// Design.  The TPU kernel walks the k tiles as its sequential grid axis
// and keeps the (block_q, D) accumulator in VMEM.  Here one block of 256
// threads owns one (b, h, 64-row q tile), loops over the 64-row k tiles
// itself and keeps the accumulator in registers: thread (ty, tx) of the
// 16 x 16 grid holds rows ty + 16 i (i < 4) and output columns tx + 16 c
// (c < 16).  Tiles that the causal mask and the window leave empty are
// skipped (a fully masked tile would leave m, l and the accumulator as
// they are).  q, k and v are staged in shared memory as float32: the q
// tile and the k tile with a row stride of D + 1 (no bank conflicts when
// 16 threads read 16 rows at one d), the v tile, and the tile's scores:
// 214,528 bytes at D = Dv = 256, under Hopper's 232,448.  Each score row
// is reduced by 4 neighbouring lanes (shuffles in a fixed order).  No
// atomics, so a launch repeats bitwise.  FMA contraction is allowed (the
// kernel is held at a tolerance); expf is the accurate one (never
// --use_fast_math).  wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;   // the Pallas kernel's NEG
constexpr int kBq = 64;          // q rows per block
constexpr int kBk = 64;          // k rows per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kMaxD = 256;
constexpr int kCols = kMaxD / 16;  // output columns per thread
constexpr int kSp = kBk + 1;     // row stride of the score tile

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

// whether query position qp may attend key position kp
__device__ __forceinline__ bool attend(int qp, int kp, int Sk, int causal,
                                       int window) {
  bool ok = kp < Sk;
  if (causal) ok = ok && kp <= qp;
  if (window) ok = ok && kp > qp - window;
  return ok;
}

size_t smem_bytes(int D, int Dv) {
  return sizeof(float) *
         ((size_t)(kBq + kBk) * (D + 1) + (size_t)kBk * Dv + kBq * kSp +
          3 * kBq);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int D, int Dv, float scale, int causal, int window) {
  extern __shared__ __align__(16) float smem[];
  const int DP = D + 1;
  float* qs = smem;                        // [kBq][DP]
  float* ks = qs + kBq * DP;               // [kBk][DP]
  float* vs = ks + kBk * DP;               // [kBk][Dv]
  float* ps = vs + kBk * Dv;               // [kBq][kSp] scores, then p
  float* ms = ps + kBq * kSp;              // [kBq] running max
  float* ls = ms + kBq;                    // [kBq] running denominator
  float* als = ls + kBq;                   // [kBq] this tile's rescale

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBq;
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * Sq * D;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * Dv;
  T* ob = o + bh * Sq * Dv;

  for (int i = tid; i < kBq * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    qs[r * DP + d] = q0 + r < Sq ? to_f32(qb[(size_t)(q0 + r) * D + d]) : 0.f;
  }
  if (tid < kBq) {
    ms[tid] = kNeg;
    ls[tid] = 0.f;
  }
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  // the k tiles that hold a key some row of this q tile may attend
  const int qlast = min(q0 + kBq, Sq) - 1;
  const int kbeg = window ? max(0, q0 - window + 1) : 0;
  const int kend = causal ? min(Sk, qlast + 1) : Sk;
  const int kt0 = kbeg / kBk, kt1 = (kend + kBk - 1) / kBk;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kBk;
    __syncthreads();  // the last tile's p and v are read (q is staged)
    for (int i = tid; i < kBk * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      ks[r * DP + d] =
          k0 + r < Sk ? to_f32(kb[(size_t)(k0 + r) * D + d]) : 0.f;
    }
    for (int i = tid; i < kBk * Dv; i += kThreads) {
      const int r = i / Dv, c = i - r * Dv;
      vs[r * Dv + c] =
          k0 + r < Sk ? to_f32(vb[(size_t)(k0 + r) * Dv + c]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        ps[r * kSp + c] =
            attend(q0 + r, k0 + c, Sk, causal, window) ? s[i][j] * scale
                                                       : kNeg;
      }
    __syncthreads();

    // online softmax: 4 neighbouring lanes per row, 16 keys each
    {
      const int r = tid / 4, part = tid % 4;
      float* pr = ps + r * kSp + part * 16;
      const float mprev = ms[r];
      float mx = mprev;
#pragma unroll
      for (int j = 0; j < 16; ++j) mx = fmaxf(mx, pr[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int kp = k0 + part * 16 + j;
        const float p =
            attend(q0 + r, kp, Sk, causal, window) ? expf(pr[j] - mx) : 0.f;
        pr[j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float al = expf(mprev - mx);
        als[r] = al;
        ls[r] = ls[r] * al + sum;
        ms[r] = mx;
      }
    }
    __syncthreads();

    // rescale the accumulator, then add p v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = als[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= al;
    }
    for (int j = 0; j < kBk; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * kSp + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tx + 16 * c;
        const float vv = col < Dv ? vs[j * Dv + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * vv;
      }
    }
  }
  __syncthreads();  // ls is final (also when no tile was visited)

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= Sq) continue;
    const float den = fmaxf(ls[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < Dv)
        ob[(size_t)(q0 + r) * Dv + col] = from_f32<T>(acc[i][c] / den);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int Sq, int Sk, int D, int Dv, float scale,
                   int causal, int window, cudaStream_t st) {
  const size_t smem = smem_bytes(D, Dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBq - 1) / kBq, BH);
  flash_fwd_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, D, Dv, scale,
      causal, window);
  return cudaGetLastError();
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

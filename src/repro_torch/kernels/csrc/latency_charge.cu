// latency_charge — one event interval of the §6 client-latency layer on
// flattened (trial, partition) rows: dirty-key decay and LARK first-touch
// charges, then the quorum rebuild-wait histogram, SLO count and latency
// sum.
//
// Replaces the Pallas TPU kernel repro/kernels/pac_eval.py:
// _latency_kernel (:263, wrapper latency_charge, pallas_call at :293), and
// the decay chain the reference runs before it (kernels/latency.py:
// decay_from_dt).  Per row r = b * P + p:
//   dec      = prod_i (bit i of dt[b] ? pow[i, p, :] : 1)       (i in order)
//   nd       = dirty * (avail ? dec : 1), flushed to 0 below 1e-30f
//   dup      = max(kf * (dirty - nd), 0)
//   qhist[k] = max(lamw[p] * cnt_k, 0), cnt_k the paying writes whose wait
//              lies in [2^k, 2^(k+1)) (top bucket open-ended), 0 unless qok
//   qslo     = max(qok ? lamw[p] * max(min(dt, rem - slo), 0) : 0, 0)
//   qsum     = max(qok ? lamw[p] * (pay*rem - (0.5*pay) * (pay - 1)) : 0, 0)
// dirty/nd/dup (R, NB) f32, dt (B,) i32, avail/qok (R,) bool, rem (R,) i32,
// pow (nbits, P, NB) f32, kf (NB,) f32, lamw (P,) f32, qhist (R, nbins),
// qslo/qsum (R,) f32.
//
// Exactness: every float op is one __fmul_rn / __fsub_rn in the
// reference's order (no contraction into FMA, no fast math, denormals
// kept: the build passes neither --use_fast_math nor -ftz), the
// 1e-30f floor compare comes before the charge, and the integer closed
// forms stay int32.  A multiply by an exact 1.0 is the identity, so a
// clear bit of dt skips its table load and its multiply.
//
// Bound: bytes.  At the paper tile (B = 8, P = 4096, NB = 4, nbins = 16,
// nbits = 22) the call reads about 2.2 MB (dirty, the pow tables once,
// the row flags and lamw) and writes about 3.4 MB (nd, dup, qhist, qslo,
// qsum): about 1.7 us at 3.35 TB/s.  The integer and float work is a few
// hundred operations per row, under the byte time.
// Design: one thread per row, neighbouring threads on neighbouring
// partitions, so each warp reads and writes contiguous runs of the
// (R, NB) and (R, nbins) arrays and the pow tables; pow[i, p, :] and
// lamw[p] are read by index, nothing is broadcast over trials.  The
// reference's 128-lane pads of NB and nbins are TPU layout and are not
// carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBuckets = 8;
constexpr int kI32Max = 0x7fffffff;

__device__ __forceinline__ float subnormal_floor() {
  return __int_as_float(0x0da24260);        // np.float32(1e-30)
}

__global__ void __launch_bounds__(kThreads)
latency_charge_kernel(const float* __restrict__ dirty,
                      const int32_t* __restrict__ dt,
                      const uint8_t* __restrict__ avail,
                      const uint8_t* __restrict__ qok,
                      const int32_t* __restrict__ rem,
                      const float* __restrict__ pow_tables,
                      const float* __restrict__ kf,
                      const float* __restrict__ lamw,
                      float* __restrict__ new_dirty, float* __restrict__ dup,
                      float* __restrict__ qhist, float* __restrict__ qslo,
                      float* __restrict__ qsum, int B, int P, int NB,
                      int nbits, int nbins, int slo_ticks) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= (long long)B * P) return;
  const int b = (int)(r / P);
  const int p = (int)(r - (long long)b * P);
  const int d = dt[b];

  // -- decay chain and dirty step, one bucket per unrolled slot
  float dec[kMaxBuckets];
#pragma unroll
  for (int j = 0; j < kMaxBuckets; ++j) dec[j] = 1.0f;
  for (int i = 0; i < nbits; ++i) {
    if (((d >> i) & 1) == 0) continue;       // factor 1.0: the identity
    const float* t = pow_tables + ((long long)i * P + p) * NB;
#pragma unroll
    for (int j = 0; j < kMaxBuckets; ++j)
      if (j < NB) dec[j] = __fmul_rn(dec[j], t[j]);
  }
  const bool av = avail[r] != 0;
  const float floor_ = subnormal_floor();
#pragma unroll
  for (int j = 0; j < kMaxBuckets; ++j) {
    if (j >= NB) break;
    const long long o = r * NB + j;
    const float x = dirty[o];
    float nd = __fmul_rn(x, av ? dec[j] : 1.0f);
    nd = nd >= floor_ ? nd : 0.0f;
    new_dirty[o] = nd;
    dup[o] = fmaxf(__fmul_rn(kf[j], __fsub_rn(x, nd)), 0.0f);
  }

  // -- quorum closed forms: int32 counts, one scaling by the write rate
  const bool ok = qok[r] != 0;
  const int rm = rem[r];
  const float lw = lamw[p];
  const int pay = max(min(d, rm), 0);
  float* qh = qhist + r * nbins;
  for (int k = 0; k < nbins; ++k) {
    const int lo = 1 << k;
    const int hi = k == nbins - 1 ? kI32Max : 2 * lo - 1;
    int cnt = min(rm, hi) - max(rm - pay + 1, lo) + 1;
    cnt = ok ? max(cnt, 0) : 0;
    qh[k] = fmaxf(__fmul_rn(lw, __int2float_rn(cnt)), 0.0f);
  }
  const float payf = __int2float_rn(pay);
  const float remf = __int2float_rn(rm);
  const float half_pay = __fmul_rn(0.5f, payf);
  const float v = __fsub_rn(__fmul_rn(payf, remf),
                            __fmul_rn(half_pay, __fsub_rn(payf, 1.0f)));
  qsum[r] = fmaxf(ok ? __fmul_rn(lw, v) : 0.0f, 0.0f);
  const int slo_cnt = max(min(d, rm - slo_ticks), 0);
  qslo[r] = fmaxf(ok ? __fmul_rn(lw, __int2float_rn(slo_cnt)) : 0.0f, 0.0f);
}

}  // namespace

extern "C" int latency_charge_launch(
    const void* dirty, const void* dt, const void* avail, const void* qok,
    const void* rem, const void* pow_tables, const void* kf, const void* lamw,
    void* new_dirty, void* dup, void* qhist, void* qslo, void* qsum, int B,
    int P, int NB, int nbits, int nbins, int slo_ticks, void* stream) {
  if (NB < 1 || NB > kMaxBuckets) return (int)cudaErrorInvalidValue;
  const long long R = (long long)B * P;
  if (R <= 0) return 0;
  const unsigned grid = (unsigned)((R + kThreads - 1) / kThreads);
  latency_charge_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)dirty, (const int32_t*)dt, (const uint8_t*)avail,
      (const uint8_t*)qok, (const int32_t*)rem, (const float*)pow_tables,
      (const float*)kf, (const float*)lamw, (float*)new_dirty, (float*)dup,
      (float*)qhist, (float*)qslo, (float*)qsum, B, P, NB, nbits, nbins,
      slo_ticks);
  return (int)cudaGetLastError();
}

// latency_charge — one event interval of the §6 client-latency layer on
// flattened (trial, partition) rows: dirty-key decay and LARK first-touch
// charges, then the quorum rebuild-wait histogram, SLO count and latency
// sum.
//
// Replaces the Pallas TPU kernel repro/kernels/pac_eval.py:
// _latency_kernel (:263, wrapper latency_charge, pallas_call at :325), and
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
// clear bit of dt needs no table load: its factor is 1.0.
//
// Bound: bytes.  At the timed shape (B = 8, P = 4096, NB = 4, nbins = 16,
// the 9 tables that dt in [1, 400) touches) the call reads 1.32 MB (dirty,
// those tables once, the row flags, rem, lamw) and writes 3.41 MB (nd,
// dup, qhist, qslo, qsum): 4,735,024 bytes, 1.41 us at 3.35 TB/s.  The
// integer and float work is a few hundred operations per row, under the
// byte time.
// Design: a block of 128 rows, one thread each, so that 256 blocks cover
// the 132 SMs at the paper tile.  A thread issues every set bit's table
// row before the chain (the bits unrolled, each load predicated on its
// bit, a row one 16-byte load when NB = 4 and two when NB = 8), then
// multiplies in bit order: one memory round trip where the loop of the
// first port waited for each set bit's table in turn.  dt[b] is one
// broadcast load per warp.  dirty comes in, and nd and dup go out, as
// 16-byte vectors where NB is a multiple of 4 and the tensor's base is
// 16-byte aligned (the kernel tests this; scalars otherwise).  A warp's
// 32 rows are contiguous, so their qhist is one contiguous range: each
// row's rem, pay, qok and lamw go to shared memory, and the warp writes
// the range as 16-byte stores of four consecutive bins (single floats at
// an unaligned head or ragged tail), computing each bin where it stores
// it, without waiting for the block's other warps.
// The reference's 128-lane pads of NB and nbins are TPU layout and are not
// carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;                  // rows of a block, one thread each
constexpr int kMaxBuckets = 8;
constexpr int kMaxBits = 31;
constexpr int kI32Max = 0x7fffffff;

__device__ __forceinline__ float subnormal_floor() {
  return __int_as_float(0x0da24260);        // np.float32(1e-30)
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// NB floats from p: 16-byte loads when `vec` (NB % 4 == 0, p aligned)
template <int NB>
__device__ __forceinline__ void load_row(float (&v)[NB], const float* p,
                                         bool vec) {
  if (NB % 4 == 0 && vec) {
#pragma unroll
    for (int j = 0; j < NB; j += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + j));
      v[j] = q.x;
      v[j + 1] = q.y;
      v[j + 2] = q.z;
      v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NB; ++j) v[j] = __ldg(p + j);
  }
}

template <int NB>
__device__ __forceinline__ void store_row(float* p, const float (&v)[NB],
                                          bool vec) {
  if (NB % 4 == 0 && vec) {
#pragma unroll
    for (int j = 0; j < NB; j += 4)
      *reinterpret_cast<float4*>(p + j) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < NB; ++j) p[j] = v[j];
  }
}

// one qhist bin of a row: the paying writes whose wait lies in bin k
__device__ __forceinline__ float bin_charge(int k, int nbins, int rm,
                                            int pay, bool ok, float lw) {
  const int lo = 1 << k;
  const int hi = k == nbins - 1 ? kI32Max : 2 * lo - 1;
  int cnt = min(rm, hi) - max(rm - pay + 1, lo) + 1;
  cnt = ok ? max(cnt, 0) : 0;
  return fmaxf(__fmul_rn(lw, __int2float_rn(cnt)), 0.0f);
}

template <int NB>
__global__ void __launch_bounds__(kRows)
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
                      float* __restrict__ qsum, int B, int P, int nbits,
                      int nbins, int slo_ticks) {
  // the bits whose table rows one thread keeps in flight at once: all 31
  // up to NB = 4, 16 above (the registers of 31 rows of 8)
  constexpr int kGroup = NB <= 4 ? kMaxBits : 16;
  __shared__ int s_rem[kRows], s_pay[kRows];
  __shared__ float s_lw[kRows];
  __shared__ bool s_ok[kRows];
  const long long R = static_cast<long long>(B) * P;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows),
                                        R - r0));
  const int t = threadIdx.x;
  if (t < rows) {
    const long long r = r0 + t;
    const int b = static_cast<int>(r / P);
    const int p = static_cast<int>(r - static_cast<long long>(b) * P);
    const int d = __ldg(dt + b);
    // the loads that do not wait for dt go out beside it
    float x[NB], kfv[NB];
    load_row<NB>(x, dirty + r * NB, aligned16(dirty));
    load_row<NB>(kfv, kf, aligned16(kf));
    const bool av = avail[r] != 0;
    const bool ok = qok[r] != 0;
    const int rm = rem[r];
    const float lw = __ldg(lamw + p);

    // -- decay chain: every set bit's table row first, then bit order
    const bool vec_pow = aligned16(pow_tables);
    float dec[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) dec[j] = 1.0f;
#pragma unroll
    for (int i0 = 0; i0 < kMaxBits; i0 += kGroup) {
      float tab[kGroup][NB];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int i = i0 + g;
        if (i < kMaxBits && i < nbits && ((d >> i) & 1) != 0) {
          load_row<NB>(tab[g], pow_tables +
                                   (static_cast<long long>(i) * P + p) * NB,
                       vec_pow);
        } else {
#pragma unroll
          for (int j = 0; j < NB; ++j) tab[g][j] = 1.0f;
        }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g)      // bit 0 first, as the reference
#pragma unroll
        for (int j = 0; j < NB; ++j) dec[j] = __fmul_rn(dec[j], tab[g][j]);
    }

    // -- dirty step
    float nd[NB], du[NB];
    const float floor_ = subnormal_floor();
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float raw = __fmul_rn(x[j], av ? dec[j] : 1.0f);
      nd[j] = raw >= floor_ ? raw : 0.0f;
      du[j] = fmaxf(__fmul_rn(kfv[j], __fsub_rn(x[j], nd[j])), 0.0f);
    }
    store_row<NB>(new_dirty + r * NB, nd, aligned16(new_dirty));
    store_row<NB>(dup + r * NB, du, aligned16(dup));

    // -- quorum closed forms: int32 counts, one scaling by the write rate
    const int pay = max(min(d, rm), 0);
    const float payf = __int2float_rn(pay);
    const float remf = __int2float_rn(rm);
    const float half_pay = __fmul_rn(0.5f, payf);
    const float v = __fsub_rn(__fmul_rn(payf, remf),
                              __fmul_rn(half_pay, __fsub_rn(payf, 1.0f)));
    qsum[r] = fmaxf(ok ? __fmul_rn(lw, v) : 0.0f, 0.0f);
    const int slo_cnt = max(min(d, rm - slo_ticks), 0);
    qslo[r] = fmaxf(ok ? __fmul_rn(lw, __int2float_rn(slo_cnt)) : 0.0f,
                    0.0f);
    s_rem[t] = rm;
    s_pay[t] = pay;
    s_lw[t] = lw;
    s_ok[t] = ok;
  }
  __syncwarp();

  // -- qhist: a warp's 32 rows are one contiguous range of 32 * nbins
  // floats, written as 16-byte stores of four consecutive bins; the warp
  // goes on without waiting for the block's other rows
  const int lane = t & 31, w0 = t - lane;   // the warp's first row
  const int wrows = max(0, min(32, rows - w0));
  float* q = qhist + (r0 + w0) * nbins;
  const int n = wrows * nbins;
  const int head = min(n, static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(q) & 15)) & 15) >> 2));
  const int quads = (n - head) >> 2;
  for (int e = lane; e < head; e += 32) {
    const int row = w0 + e / nbins, k = e % nbins;
    q[e] = bin_charge(k, nbins, s_rem[row], s_pay[row], s_ok[row],
                      s_lw[row]);
  }
  for (int i = lane; i < quads; i += 32) {
    const int e = head + 4 * i;
    int row = w0 + e / nbins, k = e % nbins;
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      v[c] = bin_charge(k, nbins, s_rem[row], s_pay[row], s_ok[row],
                        s_lw[row]);
      if (++k == nbins) {
        k = 0;
        ++row;
      }
    }
    *reinterpret_cast<float4*>(q + e) = make_float4(v[0], v[1], v[2], v[3]);
  }
  for (int e = head + 4 * quads + lane; e < n; e += 32) {
    const int row = w0 + e / nbins, k = e % nbins;
    q[e] = bin_charge(k, nbins, s_rem[row], s_pay[row], s_ok[row],
                      s_lw[row]);
  }
}

template <int NB>
int launch(const void* dirty, const void* dt, const void* avail,
           const void* qok, const void* rem, const void* pow_tables,
           const void* kf, const void* lamw, void* new_dirty, void* dup,
           void* qhist, void* qslo, void* qsum, int B, int P, int nbits,
           int nbins, int slo_ticks, void* stream) {
  const long long R = static_cast<long long>(B) * P;
  const unsigned grid = static_cast<unsigned>((R + kRows - 1) / kRows);
  latency_charge_kernel<NB><<<grid, kRows, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dirty), static_cast<const int32_t*>(dt),
      static_cast<const uint8_t*>(avail), static_cast<const uint8_t*>(qok),
      static_cast<const int32_t*>(rem),
      static_cast<const float*>(pow_tables), static_cast<const float*>(kf),
      static_cast<const float*>(lamw), static_cast<float*>(new_dirty),
      static_cast<float*>(dup), static_cast<float*>(qhist),
      static_cast<float*>(qslo), static_cast<float*>(qsum), B, P, nbits,
      nbins, slo_ticks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int latency_charge_launch(
    const void* dirty, const void* dt, const void* avail, const void* qok,
    const void* rem, const void* pow_tables, const void* kf, const void* lamw,
    void* new_dirty, void* dup, void* qhist, void* qslo, void* qsum, int B,
    int P, int NB, int nbits, int nbins, int slo_ticks, void* stream) {
  if (NB < 1 || NB > kMaxBuckets) return (int)cudaErrorInvalidValue;
  if (static_cast<long long>(B) * P <= 0) return 0;
  switch (NB) {
#define LC_CASE(n)                                                       \
  case n:                                                                \
    return launch<n>(dirty, dt, avail, qok, rem, pow_tables, kf, lamw,   \
                     new_dirty, dup, qhist, qslo, qsum, B, P, nbits,     \
                     nbins, slo_ticks, stream);
    LC_CASE(1) LC_CASE(2) LC_CASE(3) LC_CASE(4)
    LC_CASE(5) LC_CASE(6) LC_CASE(7) LC_CASE(8)
#undef LC_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// microsim_scan — the §5.2 micro-simulator's tick loop (paper Tables 3-4):
// a 1 ms-tick processor-sharing queue of one partition per config row,
// through a node failure at fail_t and its return at recover_t, in both
// modes (LARK, which serves through the outage and backfills afterwards,
// and the baseline, which pauses for min(ps / bw, 300) s).
//
// Replaces repro/core/microsim.py: _simulate_batch (a lax.scan over ticks,
// vmapped over the 12 rows of the table grid; no Pallas body).  The plain
// version beside it is repro_torch/core/microsim.py: _simulate_batch_plain,
// and the two agree bit for bit (torch.equal on every output).
//
// Bound: the latency of one tick.  The ticks form one dependent chain;
// what a launch must move is small (the per-tick outputs, 8 bytes per
// (mode, row, tick), 100 MB for both tables' 24 blocks at 520,000 ticks,
// about 30 us at 3.35 TB/s), and its arithmetic (about 10,000 operations
// per block and tick, kernels/microsim_scan.py: work) would take about 2 ms
// spread over the card.  A tick costs a few block barriers and two
// Threefry hashes in sequence, so the time goes to that chain.
//
// Design.
//   * Grid: one block per (mode, row): blocks [0, R) run LARK, [R, 2R) the
//     baseline, so one launch runs a whole table (24 blocks).
//   * Loop: every tick runs inside the block, a persistent loop.
//   * State: kThreads = AGES threads, one per ring slot.  The reference
//     rolls its (AGES, 2) cohort arrays every tick; here slot s keeps its
//     cohort's remaining bytes and count (read and write class) in
//     registers, and the age of slot s is (s - head) mod AGES.  A roll
//     moves head back by one: the slot that held age AGES-1 becomes age 0
//     and takes the tick's arrivals, so the oldest cohort drops out, as the
//     reference's roll drops it, and nothing is copied.  The latency
//     histogram lives in shared memory; in a tick every slot has a
//     distinct age, so each thread adds to its own bin.
//   * Random draws: threads 0..63 each walk the split chain (the same two
//     hashes in every lane, key and subkey from the counters (0, 0) and
//     (0, 1)) and hash their own counter row * 64 + lane under the subkey:
//     jax.random.split and uniform under jax_threefry_partitionable.  A
//     warp ballot counts the reads and writes among the tick's arrivals.
//   * Per tick: three barriers: after the arrival counts, after the block
//     sum of the cohort counts (total), after the block sum of the
//     completions.  Thread 0 carries the fluid key counts (okeys,
//     pending) and writes per_tick_done and pending_ts; hist is written
//     once at the end.
//
// Arithmetic.  Every float operation is the reference's, as XLA compiles
// it for the CPU (core/microsim.py's docstring): one IEEE float32 multiply,
// add, subtract or divide (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, so
// nvcc contracts nothing), a division by TICKS_PER_S written as a multiply
// by 0.001f as XLA rewrites it, and __fmaf_rn exactly where XLA's object
// code has a vfmadd: the request-size denominator, the outage key count
// and the end of the baseline pause.  The block sums add integer counts
// (each cohort count at most MAX_ARR, the sums below 2^24), exact in float32
// in any order.  Never --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kAges = 512;      // AGES: max tracked sojourn, ms
constexpr int kMaxArr = 64;     // MAX_ARR: max arrivals per tick
constexpr int kThreads = kAges; // one thread per ring slot
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

// Threefry-2x32, 20 rounds (jax/_src/prng.py: _threefry2x32_lowering).
__device__ __forceinline__ uint2 threefry(uint32_t k1, uint32_t k2,
                                          uint32_t x1, uint32_t x2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x1 += x2;
      x2 = rotl(x2, rot[i % 2][j]) ^ x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return make_uint2(x1, x2);
}

// Block sum of integer-valued floats (exact in any order); `red` holds
// kWarps partials and is not reused before the next barrier after this.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, red[w]);
  return s;
}

__global__ void __launch_bounds__(kThreads)
microsim_scan_kernel(const float* __restrict__ rs_in,
                     const float* __restrict__ ps_in,
                     const float* __restrict__ bw_in,
                     const float* __restrict__ u_in,
                     const float* __restrict__ lf_in,
                     const float* __restrict__ rf_in, int R, int ticks,
                     int fail_t, int recover_t, uint32_t key1,
                     uint32_t key2, float* __restrict__ hist_out,
                     float* __restrict__ done_out,
                     float* __restrict__ pending_out,
                     float* __restrict__ down_out) {
  __shared__ float hist[kAges];
  __shared__ float red_total[kWarps];
  __shared__ float red_done[kWarps];
  __shared__ int arrivals[2][2];     // [warp][read, write]

  const int s = threadIdx.x;
  const int row = blockIdx.x % R;
  const bool lark = blockIdx.x < R;
  const size_t out_row = static_cast<size_t>(blockIdx.x) * ticks;

  // per-row constants (core/microsim.py: row_constants), in every thread
  const float rs = rs_in[row], ps = ps_in[row], bw = bw_in[row];
  const float u = u_in[row], lf = lf_in[row], read_frac = rf_in[row];
  const float second =
      __fmul_rn(__fmul_rn(__fmul_rn(__fsub_rn(1.f, read_frac), 2.f), lf),
                rs);
  const float q = __fdiv_rn(__fmul_rn(u, bw), __fmaf_rn(read_frac, rs, second));
  const float rate_pt = __fmul_rn(q, 0.001f);
  const float wbytes = __fmul_rn(__fmul_rn(lf, 2.f), rs);
  const float n_keys = fmaxf(__fdiv_rn(ps, rs), 1.f);
  const float w_rate = __fmul_rn(rate_pt, __fsub_rn(1.f, read_frac));
  const float bf_rate = __fmul_rn(__fdiv_rn(__fmul_rn(bw, 0.2f), rs), 0.001f);
  const float fg_bw = __fmul_rn(bw, 0.001f);
  const float lim = fminf(__fdiv_rn(ps, bw), 300.f);
  const float base_end = __fmaf_rn(lim, 1000.f, static_cast<float>(fail_t));

  hist[s] = 0.f;
  float rem0 = 0.f, rem1 = 0.f, cnt0 = 0.f, cnt1 = 0.f;
  float acc = 0.f, okeys = 0.f, pending = 0.f;
  uint32_t k1 = key1, k2 = key2;
  int head = 0;
  const uint32_t counter = static_cast<uint32_t>(row * kMaxArr + s);
  __syncthreads();

  for (int t = 0; t < ticks; ++t) {
    // ---- arrivals ---------------------------------------------------------
    acc = __fadd_rn(acc, rate_pt);
    const float n_arr = floorf(acc);
    acc = __fsub_rn(acc, n_arr);
    if (s < kMaxArr) {
      const uint2 next = threefry(k1, k2, 0u, 0u);
      const uint2 sub = threefry(k1, k2, 0u, 1u);
      k1 = next.x;
      k2 = next.y;
      const uint2 b = threefry(sub.x, sub.y, 0u, counter);
      const uint32_t bits = b.x ^ b.y;
      const float draw =
          __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.f);
      const bool arrived = static_cast<float>(s) < n_arr;
      const unsigned reads =
          __ballot_sync(0xffffffffu, arrived && draw < read_frac);
      const unsigned writes =
          __ballot_sync(0xffffffffu, arrived && !(draw < read_frac));
      if ((s & 31) == 0) {
        arrivals[s >> 5][0] = __popc(reads);
        arrivals[s >> 5][1] = __popc(writes);
      }
    }
    __syncthreads();
    const bool paused = !lark && t >= fail_t &&
                        static_cast<float>(t) < base_end;
    const float n_read =
        paused ? 0.f : static_cast<float>(arrivals[0][0] + arrivals[1][0]);
    const float n_write =
        paused ? 0.f : static_cast<float>(arrivals[0][1] + arrivals[1][1]);

    // age-advance: the slot of age AGES-1 becomes age 0 (its cohort drops)
    head = (head - 1) & (kAges - 1);
    const int age = (s - head) & (kAges - 1);
    if (age == 0) {
      rem0 = rs;
      rem1 = wbytes;
      cnt0 = n_read;
      cnt1 = n_write;
    }

    // ---- processor sharing --------------------------------------------------
    const float total =
        fmaxf(block_sum(__fadd_rn(cnt0, cnt1), red_total), 1.f);
    const float share = __fdiv_rn(fg_bw, total);
    if (cnt0 > 0.f) rem0 = __fsub_rn(rem0, share);
    if (cnt1 > 0.f) rem1 = __fsub_rn(rem1, share);

    // ---- completions (rem <= 0 and age >= 1 tick RTT) -------------------------
    const bool rtt = age >= 1;
    const bool c0 = cnt0 > 0.f && rem0 <= 0.f && rtt;
    const bool c1 = cnt1 > 0.f && rem1 <= 0.f && rtt;
    const float lat = __fadd_rn(c0 ? cnt0 : 0.f, c1 ? cnt1 : 0.f);
    if (lat != 0.f) hist[age] = __fadd_rn(hist[age], lat);
    if (c0) cnt0 = 0.f;
    if (c1) cnt1 = 0.f;
    const float done = block_sum(lat, red_done);

    // ---- outage / backfill key dynamics (fluid), thread 0 ---------------------
    if (s == 0) {
      if (lark) {
        const bool backfilling = t >= recover_t && pending > 0.5f;
        if (t >= fail_t && t < recover_t)
          okeys = __fmaf_rn(w_rate, __fsub_rn(1.f, __fdiv_rn(okeys, n_keys)), okeys);
        if (t == recover_t) pending = okeys;
        if (backfilling)
          pending = fmaxf(__fsub_rn(__fsub_rn(pending, bf_rate),
                                    __fdiv_rn(__fmul_rn(w_rate, pending),
                                              n_keys)),
                          0.f);
      }
      done_out[out_row + t] = done;
      pending_out[out_row + t] = pending;
    }
  }
  __syncthreads();
  hist_out[static_cast<size_t>(blockIdx.x) * kAges + s] = hist[s];
  if (s == 0) down_out[blockIdx.x] = __fmul_rn(lim, 1000.f);
}

}  // namespace

extern "C" int microsim_scan_launch(const float* rs, const float* ps,
                                    const float* bw, const float* u,
                                    const float* lf, const float* read_frac,
                                    int R, int ticks, int fail_t,
                                    int recover_t, uint32_t key1,
                                    uint32_t key2, float* hist, float* done,
                                    float* pending, float* down,
                                    cudaStream_t stream) {
  if (R < 1 || ticks < 1) return static_cast<int>(cudaErrorInvalidValue);
  microsim_scan_kernel<<<2 * R, kThreads, 0, stream>>>(
      rs, ps, bw, u, lf, read_frac, R, ticks, fail_t, recover_t, key1, key2,
      hist, done, pending, down);
  return static_cast<int>(cudaGetLastError());
}

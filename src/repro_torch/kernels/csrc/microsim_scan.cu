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
// Bound: latency.  The ticks form two dependent chains: the Threefry key
// chain (one hash a tick, the same for every row, both modes and both
// tables) and each simulation's queue (two warp reductions and a divide a
// tick).  What a launch must move is small (the per-tick outputs, 8 bytes per
// (mode, row, tick): 200 MB for 48 simulations at 520,000 ticks, 60 us at
// 3.35 TB/s) and its arithmetic, spread over the card, takes a few ms
// (kernels/microsim_scan.py: work), so the time goes to the longer chain.
//
// Design: one launch runs every row given, in both modes, beside the key
// chain, and takes the arrivals off the queue's chain.
//   * Block 0, one thread: the key chain.  k_{t+1} = threefry(k_t; 0, 0)
//     and sub_t = threefry(k_t; 0, 1) (jax.random.split under
//     jax_threefry_partitionable), two independent hashes a tick; sub_t
//     goes to `subs` in device memory, and every kBatch ticks a release
//     store publishes how many are there (`progress`, zeroed by the
//     launcher).  Computed once per launch.
//   * Blocks 1..R, one per config row, five warps:
//       - warps 0 and 1 (the arrivals): wait (acquire) for a batch of
//         sub-keys, then per tick run the row's rate accumulator (acc +=
//         rate_pt, floor, subtract: the arrival count), hash the lane's
//         counter (row within its table) * 64 + lane under sub_t (jax's
//         uniform(sub, (rows, 64)); each table draws alone), and count
//         with two ballots the reads and writes among the arrivals.  The
//         two warps' counts go to a shared-memory ring of kSlots batches,
//         as small integers, under mbarriers (full: 64 arrivals; empty:
//         64).  These depend on the seed, the tick and the row alone,
//         never on the queue, so they run ahead of it.
//       - warps 2 and 3 (the queues, LARK and baseline): one warp per
//         simulation, no block barrier in the loop.  AGES ring slots of
//         the reference's rolled (AGES, 2) cohort arrays, in the warp's
//         own shared memory: lane l owns slots j * 32 + l (row j < 16) of
//         both classes, and the age of slot s is (s - head) mod AGES.  A
//         roll moves head back by one: the slot that held age AGES-1
//         becomes age 0 and takes the tick's arrivals (zero while the
//         baseline pauses), so the oldest cohort drops out and nothing is
//         copied.  A warp-uniform mask marks the rows that may hold a
//         cohort (set when a cohort arrives in the row, cleared when a
//         vote finds it empty); the tick visits those rows alone, since an
//         empty cohort changes nothing.  The cohort counts are integers
//         (each at most MAX_ARR, their sums below 2^24), so the reference's
//         float32 sums of them are exact in any order: each lane keeps the
//         sum of its own counts as an integer (plus a new cohort, less the
//         dropped one and its completions), and the tick's total and its
//         completions are one integer warp reduction each
//         (__reduce_add_sync), the reference's bits.  The latency
//         histogram lives in shared memory too: in a tick every slot has
//         a distinct age, so no two lanes add to one bin.  Lane 0 writes
//         per_tick_done; hist is written once at the end.
//       - warp 4: LARK's fluid key counts (okeys, pending), which depend
//         on the tick alone (a serial chain of divides a tick, kept off
//         the other warps); it writes both modes' pending_ts.
//   All blocks are resident at once (R + 1 small blocks), so the waits
//   end; a wait that does not end in ~17 s traps.
//
// Arithmetic.  Every float operation is the reference's, as XLA compiles
// it for the CPU (core/microsim.py's docstring): one IEEE float32 multiply,
// add, subtract or divide (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, so
// nvcc contracts nothing), a division by TICKS_PER_S written as a multiply
// by 0.001f as XLA rewrites it, and __fmaf_rn exactly where XLA's object
// code has a vfmadd: the request-size denominator, the outage key count
// and the end of the baseline pause.  Never --use_fast_math.
//
// threefry_chain_cycles times the key chain's step alone: one thread, n
// dependent hashes, clock64 around them.

#include "sm90.cuh"

#include <math.h>

namespace {

constexpr int kAges = 512;      // AGES: max tracked sojourn, ms
constexpr int kMaxArr = 64;     // MAX_ARR: max arrivals per tick
constexpr int kBatch = 128;     // ticks a ring slot and a published batch
constexpr int kSlots = 4;       // ring slots of arrival counts
constexpr int kThreads = 160;   // arrivals: warps 0, 1; queues: 2, 3;
                                // the fluid key counts: 4

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

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// spin until *p >= need; trap after ~17 s
__device__ __forceinline__ void wait_progress(const uint32_t* p,
                                              uint32_t need) {
  if (ld_acquire(p) >= need) return;
  const long long t0 = clock64();
  while (ld_acquire(p) < need) {
    __nanosleep(100);
    if (clock64() - t0 > (1LL << 35)) __trap();
  }
}

// the sub-key of tick t, published by block 0
__device__ __forceinline__ uint2 load_sub(const uint2* subs, int t) {
  return __ldcg(subs + t);
}

__global__ void __launch_bounds__(kThreads)
microsim_scan_kernel(const float* __restrict__ rs_in,
                     const float* __restrict__ ps_in,
                     const float* __restrict__ bw_in,
                     const float* __restrict__ u_in,
                     const float* __restrict__ lf_in,
                     const float* __restrict__ rf_in, int R,
                     int rows_per_table, int ticks, int fail_t,
                     int recover_t, uint32_t key1, uint32_t key2,
                     uint2* __restrict__ subs, uint32_t* __restrict__ progress,
                     float* __restrict__ hist_out,
                     float* __restrict__ done_out,
                     float* __restrict__ pending_out,
                     float* __restrict__ down_out) {
  // ---- block 0: the key chain -----------------------------------------------
  if (blockIdx.x == 0) {
    if (threadIdx.x != 0) return;
    uint32_t k1 = key1, k2 = key2;
    for (int t0 = 0; t0 < ticks; t0 += kBatch) {
      const int end = min(t0 + kBatch, ticks);
      for (int t = t0; t < end; ++t) {
        const uint2 next = threefry(k1, k2, 0u, 0u);
        subs[t] = threefry(k1, k2, 0u, 1u);
        k1 = next.x;
        k2 = next.y;
      }
      st_release(progress, static_cast<uint32_t>(end));
    }
    return;
  }

  __shared__ uint32_t ring[kSlots][kBatch][2];  // [slot][tick][warp]
  // per queue warp: the latency histogram, and each cohort's remaining
  // bytes and count by class, indexed by ring slot
  __shared__ float hist[2][kAges], rem[2][2][kAges], cnt[2][2][kAges];
  __shared__ __align__(8) uint64_t bars[2 * kSlots];  // full, empty

  const int row = blockIdx.x - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t bar_f = sm90::smem_u32(&bars[0]);       // + 8 slot
  const uint32_t bar_e = sm90::smem_u32(&bars[kSlots]);  // + 8 slot

  // per-row constants (core/microsim.py: row_constants)
  const float rs = rs_in[row], ps = ps_in[row], bw = bw_in[row];
  const float u = u_in[row], lf = lf_in[row], read_frac = rf_in[row];
  const float second =
      __fmul_rn(__fmul_rn(__fmul_rn(__fsub_rn(1.f, read_frac), 2.f), lf),
                rs);
  const float q = __fdiv_rn(__fmul_rn(u, bw), __fmaf_rn(read_frac, rs, second));
  const float rate_pt = __fmul_rn(q, 0.001f);
  const size_t lark_row = static_cast<size_t>(row) * ticks;
  const size_t base_row = static_cast<size_t>(R + row) * ticks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      sm90::mbar_init(bar_f + 8 * s, 64);
      sm90::mbar_init(bar_e + 8 * s, 64);
    }
    sm90::fence_barrier_init();
  }
  for (int i = threadIdx.x; i < 2 * kAges; i += kThreads)
    (&hist[0][0])[i] = 0.f;
  for (int i = threadIdx.x; i < 4 * kAges; i += kThreads) {
    (&rem[0][0][0])[i] = 0.f;
    (&cnt[0][0][0])[i] = 0.f;
  }
  __syncthreads();

  if (warp == 4) {
    // ---- outage / backfill key dynamics (fluid), warp 4 ---------------------
    // They depend on the tick alone: every lane computes LARK's (okeys,
    // pending), lane 0 writes both modes' pending_ts.
    const float n_keys = fmaxf(__fdiv_rn(ps, rs), 1.f);
    const float w_rate = __fmul_rn(rate_pt, __fsub_rn(1.f, read_frac));
    const float bf_rate =
        __fmul_rn(__fdiv_rn(__fmul_rn(bw, 0.2f), rs), 0.001f);
    float okeys = 0.f, pending = 0.f;
    for (int t = 0; t < ticks; ++t) {
      const bool backfilling = t >= recover_t && pending > 0.5f;
      if (t >= fail_t && t < recover_t)
        okeys = __fmaf_rn(w_rate, __fsub_rn(1.f, __fdiv_rn(okeys, n_keys)), okeys);
      if (t == recover_t) pending = okeys;
      if (backfilling)
        pending = fmaxf(__fsub_rn(__fsub_rn(pending, bf_rate),
                                  __fdiv_rn(__fmul_rn(w_rate, pending),
                                            n_keys)),
                        0.f);
      if (lane == 0) {
        pending_out[lark_row + t] = pending;
        pending_out[base_row + t] = 0.f;
      }
    }
    return;
  }

  if (warp < 2) {
    // ---- the arrivals: warps 0 and 1, lane index w * 32 + lane ------------
    const int idx = warp * 32 + lane;
    const uint32_t counter =
        static_cast<uint32_t>((row % rows_per_table) * kMaxArr + idx);
    float acc = 0.f;
    for (int b = 0, t0 = 0; t0 < ticks; ++b, t0 += kBatch) {
      const int n = min(kBatch, ticks - t0), slot = b % kSlots;
      if (b >= kSlots)
        sm90::mbar_wait(bar_e + 8 * slot, ((b / kSlots) - 1) & 1);
      wait_progress(progress, static_cast<uint32_t>(t0 + n));
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const int t = t0 + i;
        acc = __fadd_rn(acc, rate_pt);
        const float n_arr = floorf(acc);
        acc = __fsub_rn(acc, n_arr);
        const uint2 sub = load_sub(subs, t);
        const uint2 h = threefry(sub.x, sub.y, 0u, counter);
        const uint32_t bits = h.x ^ h.y;
        const float draw =
            __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.f);
        const bool arrived = static_cast<float>(idx) < n_arr;
        const unsigned reads =
            __ballot_sync(0xffffffffu, arrived && draw < read_frac);
        const unsigned writes =
            __ballot_sync(0xffffffffu, arrived && !(draw < read_frac));
        if (lane == 0)
          ring[slot][i][warp] = __popc(reads) | (__popc(writes) << 16);
      }
      sm90::mbar_arrive(bar_f + 8 * slot);
    }
    return;
  }

  // ---- the queues: warp 2 LARK, warp 3 the baseline -------------------------
  const int qw = warp - 2;
  const bool lark = qw == 0;
  const int sim = lark ? row : R + row;  // output row: [mode][row]
  const size_t out_row = lark ? lark_row : base_row;
  float* my_hist = hist[qw];
  float* rem0 = rem[qw][0];
  float* rem1 = rem[qw][1];
  float* cnt0 = cnt[qw][0];
  float* cnt1 = cnt[qw][1];
  const float wbytes = __fmul_rn(__fmul_rn(lf, 2.f), rs);
  const float fg_bw = __fmul_rn(bw, 0.001f);
  const float lim = fminf(__fdiv_rn(ps, bw), 300.f);
  const float base_end = __fmaf_rn(lim, 1000.f, static_cast<float>(fail_t));

  int head = 0;
  uint32_t busy = 0;  // warp-uniform: bit j set when row j may hold a cohort
  int mine = 0;       // the sum of this lane's cohort counts

  for (int b = 0, t0 = 0; t0 < ticks; ++b, t0 += kBatch) {
    const int n = min(kBatch, ticks - t0), slot = b % kSlots;
    sm90::mbar_wait(bar_f + 8 * slot, (b / kSlots) & 1);
    for (int i = 0; i < n; ++i) {
      const int t = t0 + i;
      // ---- arrivals (the baseline rejects them while it pauses) -----------
      const uint32_t a0 = ring[slot][i][0], a1 = ring[slot][i][1];
      const bool paused = !lark && t >= fail_t &&
                          static_cast<float>(t) < base_end;
      const float n_read =
          paused ? 0.f : static_cast<float>((a0 & 0xFFFFu) + (a1 & 0xFFFFu));
      const float n_write =
          paused ? 0.f : static_cast<float>((a0 >> 16) + (a1 >> 16));

      // age-advance: the slot of age AGES-1 becomes age 0 (its cohort
      // drops) and takes the arrivals; slot head is lane head % 32's
      head = (head - 1) & (kAges - 1);
      if ((head & 31) == lane) {
        mine += static_cast<int>(n_read) + static_cast<int>(n_write) -
                static_cast<int>(cnt0[head]) - static_cast<int>(cnt1[head]);
        rem0[head] = rs;
        rem1[head] = wbytes;
        cnt0[head] = n_read;
        cnt1[head] = n_write;
      }
      busy |= 1u << (head >> 5);

      // ---- processor sharing ------------------------------------------------
      const float total = fmaxf(
          static_cast<float>(__reduce_add_sync(0xffffffffu, mine)), 1.f);
      const float share = __fdiv_rn(fg_bw, total);

      // ---- completions (rem <= 0 and age >= 1 tick RTT) ---------------------
      int lat_sum = 0;
      for (uint32_t m = busy; m; m &= m - 1) {
        const int j = __ffs(m) - 1, sl = j * 32 + lane;
        float r0 = rem0[sl], r1 = rem1[sl], c0 = cnt0[sl], c1 = cnt1[sl];
        if (c0 > 0.f) r0 = __fsub_rn(r0, share);
        if (c1 > 0.f) r1 = __fsub_rn(r1, share);
        const int age = (sl - head) & (kAges - 1);
        const bool rtt = age >= 1;
        const bool d0 = c0 > 0.f && r0 <= 0.f && rtt;
        const bool d1 = c1 > 0.f && r1 <= 0.f && rtt;
        // lat is 0 for most slots: adding +0 leaves a bin's bits as they
        // are, so every lane adds without a branch
        const float lat = __fadd_rn(d0 ? c0 : 0.f, d1 ? c1 : 0.f);
        my_hist[age] = __fadd_rn(my_hist[age], lat);
        lat_sum += static_cast<int>(lat);
        if (d0) c0 = 0.f;
        if (d1) c1 = 0.f;
        rem0[sl] = r0;
        rem1[sl] = r1;
        cnt0[sl] = c0;
        cnt1[sl] = c1;
        // a row left with no cohort changes nothing until one arrives
        if (!__any_sync(0xffffffffu, c0 > 0.f || c1 > 0.f))
          busy &= ~(1u << j);
      }
      mine -= lat_sum;
      const float done =
          static_cast<float>(__reduce_add_sync(0xffffffffu, lat_sum));

      if (lane == 0) done_out[out_row + t] = done;
    }
    sm90::mbar_arrive(bar_e + 8 * slot);
  }
  __syncwarp();
  for (int a = lane; a < kAges; a += 32)
    hist_out[static_cast<size_t>(sim) * kAges + a] = my_hist[a];
  if (lane == 0) down_out[sim] = __fmul_rn(lim, 1000.f);
}

// n dependent key-chain steps in one thread: the cycles they took
__global__ void threefry_chain_kernel(uint32_t k1, uint32_t k2, int n,
                                      long long* __restrict__ cycles,
                                      uint2* __restrict__ last) {
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
    const uint2 next = threefry(k1, k2, 0u, 0u);
    k1 = next.x;
    k2 = next.y;
  }
  const long long t1 = clock64();
  *cycles = t1 - t0;
  *last = make_uint2(k1, k2);
}

}  // namespace

// rs .. read_frac: (R,) float32 configs, R a multiple of rows_per_table
// (rows r and r + rows_per_table draw with one counter); subs (ticks,) of
// uint2 and progress (one uint32) scratch; hist (2, R, AGES), done and
// pending (2, R, ticks), down (2, R) float32, mode 0 LARK.  Zeroes
// progress, then launches R + 1 blocks.  Returns the cudaError_t.
extern "C" int microsim_scan_launch(const float* rs, const float* ps,
                                    const float* bw, const float* u,
                                    const float* lf, const float* read_frac,
                                    int R, int rows_per_table, int ticks,
                                    int fail_t, int recover_t, uint32_t key1,
                                    uint32_t key2, void* subs, void* progress,
                                    float* hist, float* done, float* pending,
                                    float* down, cudaStream_t stream) {
  if (R < 1 || ticks < 1 || rows_per_table < 1 || R % rows_per_table)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(progress, 0, sizeof(uint32_t), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  microsim_scan_kernel<<<R + 1, kThreads, 0, stream>>>(
      rs, ps, bw, u, lf, read_frac, R, rows_per_table, ticks, fail_t,
      recover_t, key1, key2, static_cast<uint2*>(subs),
      static_cast<uint32_t*>(progress), hist, done, pending, down);
  return static_cast<int>(cudaGetLastError());
}

// cycles[0] = the clock64 cycles of n dependent Threefry hashes of the key
// chain in one thread, last[0..1] the key it ends on
extern "C" int threefry_chain_cycles(uint32_t key1, uint32_t key2, int n,
                                     void* cycles, void* last,
                                     cudaStream_t stream) {
  threefry_chain_kernel<<<1, 1, 0, stream>>>(
      key1, key2, n, static_cast<long long*>(cycles),
      static_cast<uint2*>(last));
  return static_cast<int>(cudaGetLastError());
}

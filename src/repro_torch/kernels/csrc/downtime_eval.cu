// downtime_eval, pac_eval and node_count — per-row evaluation on boolean
// rank-space tiles: the §6 evaluation (plain and roster variants, each
// with or without the in-flight node counts), §5.1 PAC, and the counts
// alone.
//
// Replaces four Pallas TPU kernel bodies of repro/kernels/pac_eval.py:
// _pac_kernel (:23, wrapper pac_eval, pallas_call at :64),
// _downtime_kernel (:87) and _downtime_roster_kernel (:131), both called
// by downtime_eval (pallas_call at :405), and _node_count_kernel (:200,
// wrapper node_count, pallas_call at :250).  Inputs are (R, n_pad) bool
// tiles in succession-rank space (R = trials * partitions, row
// r = b * P + p); columns >= n_real are padding.  Outputs, per row:
//   lark   = cluster majority up AND some first-rf lane up AND some
//            latest-copy holder up (PAC; the first rf lanes even in the
//            roster variant, as the reference)
//   creps  = the first rf up lanes (the refreshed holder mask)
// pac_eval adds
//   maj    = 2 * (up lanes below voters) > voters, the 2f+1 baseline
//            (voters may exceed 32 and n_real; padding reads as down)
// and downtime_eval
//   nrep   = up count of the replica set: the first rf lanes, or the
//            roster's rf ranks (a rank outside [0, n_real) reads as down);
//            qmaj = 2 * nrep > rf
//   leader = lowest up rank (n_real when none is up); lfull = that lane's
//            latest-copy bit
//   repmask (optional) = bit j set iff lane j < rf is up
//   rleader (optional, roster only) = lowest up roster rank, n_real when
//            none
// and, in its counts mode (recruit (R,) int32, active (R,) bool), the
// (B, n_real) int32 counts, as node_count alone:
//   cnt[b, node] = #{p : active[b P + p] and recruit[b P + p] == node}
// where an id outside [0, n_real) — the engine's no-recruit sentinel
// n_real among them — counts nowhere.
//
// Bound: bytes.  Each row is read once (2 * n_pad bytes, + 4 * rf roster
// bytes) and written once (n_pad bytes of creps and 2 bytes for pac_eval;
// n_pad + 11 bytes, + 4 per extra, for downtime_eval).  At the paper tile
// (R = 8 * 4096, n_pad = 155), at 3.35 TB/s: pac_eval 3 R n_pad + 2 R =
// 15,302,656 bytes, 4.57 us; downtime_eval 3 R n_pad + 11 R = 15,597,568
// bytes, 4.66 us, and 15,859,712 (4.73 us) with an rf = 2 roster.  The
// counts add 5 bytes a row and 4 a (trial, node): 15,766,368 bytes
// (4.71 us), 16,028,512 (4.78 us) with the roster.  node_count alone
// moves 168,800 bytes (0.05 us), so a launch's latency, not its bytes,
// sets its time.  The arithmetic is a few integer ops per byte.
// Design: one kernel body, templated on the mode (pac, plain, roster) and
// on the counts, so that each launcher's instantiation carries only its
// own work.  A block owns a tile of T consecutive rows (64; four
// consecutive lanes to a row, 256 threads), T a multiple of 16 so that
// the tile's bytes start 16-byte aligned whatever n_pad is (when the
// tensor's base is).  The tile's up and full bytes are each one
// contiguous range; they come into shared memory in 16-byte cp.async
// pieces, the range widened to 16-byte boundaries so that a view at any
// byte offset, or a ragged last tile, needs nothing else (a widened piece
// holds a byte of the range, so it lies in the same allocation page; the
// bytes outside the range are never used).  The roster slice comes along
// the same way.  A row is read in 4-byte words at its own alignment
// (__funnelshift_r of two aligned shared words), each byte turned into
// one flag bit by a carry-free add.  The row's four lanes each count a
// quarter of its words (up lanes, up lanes holding the latest copy) and
// reduce with __shfl_xor_sync; its first lane walks from the first column
// for the ordered facts (creps, the lanes below rf and, for pac_eval, the
// up lanes below voters; the leader for downtime_eval), mostly one word.
// The roster seats, split over the four lanes, read their up byte from
// shared memory.  creps is zeroed in shared memory, each row sets its
// first rf up lanes, and the tile goes out as 16-byte stores over the
// same contiguous range (single bytes at an unaligned head or ragged
// tail).  Per-row outputs go out as bytes and words from each row's first
// lane.  T comes from n_pad at launch so that the tile fits in shared
// memory (and halves while that leaves SMs without a tile); a row too
// wide for 16 rows is walked in column passes, one range per row segment.
// The counts: a row's first lane loads its recruit id and active flag
// before the tile arrives and, after the walk, holds the key b n_real +
// node (b = r / P, taken per row: a tile straddles two trials whenever
// P % T != 0), or -1 when the row counts nowhere.  __match_any_sync
// groups the warp's lanes by key, and the lowest lane of each group adds
// the group's size with one global atomicAdd, as fused_downtime.cu does;
// integer atomics commute, so the counts are exact in any order.  The
// launcher zeroes the counts with a memset on the launch's stream.
// node_count alone is the same count, one thread a row, with no tile.
// The reference's 128-lane node, partition and roster padding is TPU
// layout and is not carried over.  Integer and bit math only: exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// what a launch evaluates: the instantiation of the kernel body
enum Mode : int {
  kPac = 0,     // pac_eval: lark, maj, creps
  kPlain = 1,   // downtime_eval: the replica set is the first rf lanes
  kRoster = 2,  // downtime_eval: the replica set is the roster's ranks
};

constexpr int kLanes = 4;           // threads per row, consecutive lanes
constexpr int kMaxRows = 64;        // rows of a tile (256 threads)
constexpr int kMinRows = 16;        // 16 * n_pad is a multiple of 16
constexpr int kMinBlocks = 132;     // shrink T until the tiles fill the SMs
constexpr int kBudget = 100 * 1024; // dynamic shared memory of one block
constexpr int kRosterCap = 16 * 1024;  // largest staged roster slice
constexpr int kCountThreads = 256;  // node_count alone: threads a block
// widening to 16-byte boundaries (< 32 bytes) and the word walk's read of
// one aligned word past a row (< 8 bytes) fit in this many extra bytes
constexpr int kSlop = 32;

// shared-memory plan of a launch
struct Plan {
  int rows;    // T, rows of a tile (= threads of a block)
  int chunk;   // columns per pass: n_pad when one pass holds the rows
  int stride;  // bytes per row segment in column passes, 0 in one pass
  int buf;     // bytes of each of the up, full and creps buffers
  int ro_buf;  // bytes of the staged roster slice (0: read from global)
};

__host__ __device__ inline long long align16(long long x) {
  return (x + 15) & ~15LL;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, uintptr_t src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying the bytes [src, src + n) into shared memory at dst in
// 16-byte pieces, widened to 16-byte boundaries: src[i] lands at
// dst[head + i], head = src & 15, which is returned.  n >= 1.
__device__ __forceinline__ int load_range(uint8_t* dst, const void* src,
                                          long long n, int tid, int nthr) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a0 = a & ~static_cast<uintptr_t>(15);
  const uintptr_t a1 = (a + n + 15) & ~static_cast<uintptr_t>(15);
  const int pieces = static_cast<int>((a1 - a0) >> 4);
  for (int i = tid; i < pieces; i += nthr)
    cp_async16(dst + 16 * i, a0 + 16 * static_cast<uintptr_t>(i));
  return static_cast<int>(a - a0);
}

// Zero the first `bytes` (a multiple of 16) of dst.
__device__ __forceinline__ void zero_smem(uint8_t* dst, int bytes, int tid,
                                          int nthr) {
  for (int i = tid; i < bytes / 16; i += nthr)
    reinterpret_cast<uint4*>(dst)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// Store shared bytes to [dst, dst + n), where src[(dst & 15) + i] holds
// dst[i] (src 16-byte aligned): 16-byte stores where a whole aligned
// piece lies inside the range, single bytes at an unaligned head and at a
// ragged tail.
__device__ __forceinline__ void store_range(uint8_t* dst, const uint8_t* src,
                                            long long n, int tid, int nthr) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  const uintptr_t b = a + n;
  const uintptr_t a0 = a & ~static_cast<uintptr_t>(15);
  uintptr_t lo = (a + 15) & ~static_cast<uintptr_t>(15);
  uintptr_t hi = b & ~static_cast<uintptr_t>(15);
  if (lo > hi) lo = hi = b;                 // no whole piece: all bytes
  for (uintptr_t x = a + tid; x < lo; x += nthr)
    *reinterpret_cast<uint8_t*>(x) = src[x - a0];
  for (uintptr_t x = lo + 16 * static_cast<uintptr_t>(tid); x < hi;
       x += 16 * static_cast<uintptr_t>(nthr))
    *reinterpret_cast<uint4*>(x) =
        *reinterpret_cast<const uint4*>(src + (x - a0));
  for (uintptr_t x = hi + tid; x < b; x += nthr)    // the ragged tail
    *reinterpret_cast<uint8_t*>(x) = src[x - a0];
}

// 0x80 in each byte of x that is not 0 (a bool byte reads as set when it
// is not 0, as the first port's `!= 0`); no carry crosses a byte
__device__ __forceinline__ uint32_t set_lanes(uint32_t x) {
  return (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
}

// 0x80 in bytes [0, n) of a word (n <= 0: none, n >= 4: all)
__device__ __forceinline__ uint32_t low_lanes(int n) {
  if (n <= 0) return 0u;
  if (n >= 4) return 0x80808080u;
  return 0x80808080u & ((1u << (8 * n)) - 1u);
}

// word k of a byte run p at any alignment (bytes p[4k] .. p[4k + 3]), from
// the aligned words a = p & ~3 and the shift sh = 8 (p & 3)
__device__ __forceinline__ uint32_t word_at(const uint32_t* a, int sh,
                                            int k) {
  return __funnelshift_r(a[k], a[k + 1], sh);
}

__device__ __forceinline__ const uint32_t* aligned_words(const uint8_t* p) {
  return reinterpret_cast<const uint32_t*>(reinterpret_cast<uintptr_t>(p) &
                                           ~static_cast<uintptr_t>(3));
}

__device__ __forceinline__ int word_shift(const uint8_t* p) {
  return 8 * static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3);
}

// one row's running evaluation over its column passes (the ordered facts
// in the row's first lane; n_rep and r_lead per lane until reduced)
struct RowState {
  int n_up = 0, n_first = 0, n_vote = 0, ldr = -1, n_rep = 0, r_lead = 0;
  bool full_up = false, ldr_full = false;
  uint32_t repmask = 0u;
};

// The ordered facts of columns [c0, c0 + wv) of one row, from the first
// column on: creps (the first rf up lanes, set in sc), the lanes j < rf,
// and the leader (downtime_eval) or the up lanes j < voters (pac_eval);
// mostly settled by the first word.  su, sf, sc point at the segment's
// up, full and zeroed creps bytes in shared memory.
template <int kMode>
__device__ __forceinline__ void ordered_facts(RowState& st,
                                              const uint8_t* su,
                                              const uint8_t* sf, uint8_t* sc,
                                              int c0, int wv, int rf,
                                              int voters) {
  const uint32_t* au = aligned_words(su);
  const int shu = word_shift(su);
  const int nw = (wv + 3) >> 2;
  const int last = kMode == kPac ? max(rf, voters) : rf;  // ordered lanes
  int seen = st.n_up;                       // up lanes before word k
  for (int k = 0; k < nw; ++k) {
    const int col = c0 + 4 * k;
    if (seen >= rf && col >= last) break;
    const uint32_t U = set_lanes(word_at(au, shu, k)) & low_lanes(wv - 4 * k);
    if (U == 0u) continue;
    if (kMode != kPac && st.ldr < 0) {
      const int byte = (__ffs(U) - 1) >> 3;
      st.ldr = col + byte;
      st.ldr_full = ((set_lanes(word_at(aligned_words(sf), word_shift(sf),
                                        k)) >> (8 * byte)) & 0x80u) != 0u;
    }
    if (seen < rf) {
      int rank = seen;
      for (uint32_t m = U; m != 0u; m &= m - 1u) {
        const int byte = (__ffs(m) - 1) >> 3;
        ++rank;
        if (rank <= rf) sc[4 * k + byte] = 1;
      }
    }
    seen += __popc(U);
    if (col < rf) {
      const uint32_t mine = U & low_lanes(rf - col);
      st.n_first += __popc(mine);
      if (kMode != kPac && col < 32)
        st.repmask |= (((mine >> 7) * 0x01020408u) >> 24) << col;
    }
    if (kMode == kPac && col < voters)
      st.n_vote += __popc(U & low_lanes(voters - col));
  }
}

// This lane's share of the order-free facts of a segment of wv real
// columns: the lane takes its quarter of the words, and counts the up
// lanes and the up lanes that hold the latest copy.
__device__ __forceinline__ void count_share(const uint8_t* su,
                                            const uint8_t* sf, int wv,
                                            int part, int& n_up,
                                            uint32_t& held) {
  const int nw = (wv + 3) >> 2;
  const int per = (nw + kLanes - 1) / kLanes;
  const int k0 = part * per, k1 = min(nw, k0 + per);
  if (k0 >= k1) return;
  const uint32_t* au = aligned_words(su);
  const uint32_t* af = aligned_words(sf);
  const int shu = word_shift(su), shf = word_shift(sf);
  uint32_t pu = au[k0], pf = af[k0];
  for (int k = k0; k < k1; ++k) {
    const uint32_t nu = au[k + 1], nf = af[k + 1];
    const uint32_t U = set_lanes(__funnelshift_r(pu, nu, shu)) &
                       low_lanes(wv - 4 * k);
    n_up += __popc(U);
    held |= set_lanes(__funnelshift_r(pf, nf, shf)) & U;
    pu = nu;
    pf = nf;
  }
}

// reductions over the kLanes consecutive lanes of a row; every lane of the
// warp takes part, and every lane of the row gets the result
__device__ __forceinline__ int row_sum(int v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o /= 2)
    v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t row_or(uint32_t v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o /= 2)
    v |= __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

__device__ __forceinline__ int row_min(int v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o /= 2)
    v = min(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

// The key a row counts under: b n_real + its recruit id when the row is
// active and the id lies in [0, n_real), else -1 (B n_real < 2^31,
// checked by the caller).
__device__ __forceinline__ int count_key(int rc, bool act, int b,
                                         int n_real) {
  return (act && rc >= 0 && rc < n_real) ? b * n_real + rc : -1;
}

// Add each lane's key (-1: none) to cnt: __match_any_sync groups the
// warp's lanes by key, and the lowest lane of each group adds the group's
// size.  Every lane of the warp calls it.
__device__ __forceinline__ void count_warp(int key,
                                           int32_t* __restrict__ cnt) {
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, key);
  if (key >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(cnt + key, __popc(peers));
}

// kCounts: the counts mode (recruit, active and cnt used; downtime modes)
template <int kMode, bool kCounts>
__global__ void __launch_bounds__(kMaxRows * kLanes)
row_eval_kernel(const uint8_t* __restrict__ up,
                     const uint8_t* __restrict__ full,
                     const int32_t* __restrict__ roster,
                     const int32_t* __restrict__ recruit,
                     const uint8_t* __restrict__ active,
                     uint8_t* __restrict__ lark, uint8_t* __restrict__ qmaj,
                     int32_t* __restrict__ leader,
                     uint8_t* __restrict__ lfull,
                     int32_t* __restrict__ nrep,
                     int32_t* __restrict__ repmask,
                     int32_t* __restrict__ rleader,
                     uint8_t* __restrict__ creps,
                     int32_t* __restrict__ cnt, int R, int n_pad,
                     int n_real, int rf, int voters, int P, Plan plan) {
  constexpr bool kWithRoster = kMode == kRoster;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_up = smem;
  uint8_t* s_full = smem + plan.buf;
  uint8_t* s_creps = smem + 2 * plan.buf;
  uint8_t* s_ro = smem + 3 * plan.buf;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lr = tid / kLanes, part = tid % kLanes;  // row in tile, lane
  const long long row0 = static_cast<long long>(blockIdx.x) * plan.rows;
  const int rows = static_cast<int>(min(static_cast<long long>(plan.rows),
                                        R - row0));
  const long long row = row0 + lr;
  const bool live = lr < rows;
  const bool one_pass = plan.stride == 0;

  constexpr bool counting = kCounts;
  int rc = -1;                              // the row's recruit id and
  bool act = false;                         // active flag, in its first
  if (counting && live && part == 0) {      // lane, loaded before the tile
    rc = recruit[row];
    act = active[row] != 0;
  }

  const int32_t* seats = nullptr;           // this row's roster ranks
  if (kWithRoster) {
    if (plan.ro_buf > 0) {
      const int h = load_range(s_ro, roster + row0 * rf,
                               4LL * rows * rf, tid, nthr);
      seats = reinterpret_cast<const int32_t*>(s_ro + h) + lr * rf;
    } else {
      seats = roster + row * rf;
    }
  }

  RowState st;
  st.r_lead = n_real;
  for (int c0 = 0; c0 < n_pad; c0 += plan.chunk) {
    const int w = min(plan.chunk, n_pad - c0);
    int ou, of, oc;                         // this row's segment offsets
    if (one_pass) {                         // the tile: one range each
      const long long base = row0 * n_pad, n = 1LL * rows * n_pad;
      ou = load_range(s_up, up + base, n, tid, nthr) + lr * n_pad;
      of = load_range(s_full, full + base, n, tid, nthr) + lr * n_pad;
      oc = static_cast<int>(reinterpret_cast<uintptr_t>(creps + base) & 15)
           + lr * n_pad;
      zero_smem(s_creps, static_cast<int>(align16(oc - lr * n_pad + n)),
                tid, nthr);
    } else {                                // one range per row segment
      __syncthreads();                      // the last pass is stored
      for (int r = 0; r < rows; ++r) {
        const long long g = (row0 + r) * n_pad + c0;
        load_range(s_up + r * plan.stride, up + g, w, tid, nthr);
        load_range(s_full + r * plan.stride, full + g, w, tid, nthr);
      }
      const long long g = row * n_pad + c0;
      ou = lr * plan.stride +
           static_cast<int>(reinterpret_cast<uintptr_t>(up + g) & 15);
      of = lr * plan.stride +
           static_cast<int>(reinterpret_cast<uintptr_t>(full + g) & 15);
      oc = lr * plan.stride +
           static_cast<int>(reinterpret_cast<uintptr_t>(creps + g) & 15);
      zero_smem(s_creps, plan.buf, tid, nthr);
    }
    cp_async_wait_all();
    __syncthreads();

    const int wv = min(w, n_real - c0);     // real columns of the segment
    int n_up = 0;
    uint32_t held = 0u;
    if (live && wv > 0) {
      if (part == 0)
        ordered_facts<kMode>(st, s_up + ou, s_full + of, s_creps + oc, c0,
                             wv, rf, voters);
      count_share(s_up + ou, s_full + of, wv, part, n_up, held);
    }
    if (live && kWithRoster) {
      for (int j = part; j < rf; j += kLanes) {
        const int r = seats[j];
        if (r < 0 || r >= n_real) continue;   // out of range: reads down
        if (r >= c0 && r < c0 + w && s_up[ou + r - c0] != 0) {
          ++st.n_rep;
          st.r_lead = min(st.r_lead, r);
        }
      }
    }
    st.n_up += row_sum(n_up);
    const uint32_t any_held = row_or(held);   // every lane shuffles
    st.full_up = st.full_up || any_held != 0u;
    __syncthreads();

    if (one_pass) {
      store_range(creps + row0 * n_pad, s_creps, 1LL * rows * n_pad, tid,
                  nthr);
    } else {
      for (int r = 0; r < rows; ++r) {
        const long long g = (row0 + r) * n_pad + c0;
        store_range(creps + g, s_creps + r * plan.stride, w, tid, nthr);
      }
    }
  }

  const int n_rep = kWithRoster ? row_sum(st.n_rep) : st.n_first;
  const int r_lead = kWithRoster ? row_min(st.r_lead) : n_real;
  if (counting)                             // every lane of the warp
    count_warp(count_key(rc, act, static_cast<int>(row) / P, n_real), cnt);
  if (live && part == 0) {
    lark[row] = (2 * st.n_up > n_real && st.n_first > 0 && st.full_up)
                    ? 1 : 0;
    if (kMode == kPac) {                    // qmaj holds maj
      qmaj[row] = (2 * st.n_vote > voters) ? 1 : 0;
      return;
    }
    qmaj[row] = (2 * n_rep > rf) ? 1 : 0;
    nrep[row] = n_rep;
    leader[row] = st.ldr < 0 ? n_real : st.ldr;
    lfull[row] = (st.ldr >= 0 && st.ldr_full) ? 1 : 0;
    if (repmask != nullptr)                 // rf <= 30, checked by caller
      repmask[row] = static_cast<int32_t>(st.repmask);
    if (kWithRoster && rleader != nullptr) rleader[row] = r_lead;
  }
}

// The tile: the most rows (128 down to 16) whose three row buffers and
// roster slice fit the budget, halved while that leaves SMs without a
// tile; rows too wide even for 16 go in column passes.  A roster slice
// larger than kRosterCap is read from global memory.
Plan make_plan(int R, int n_pad, int rf, bool roster) {
  auto ro_bytes = [&](int T) -> int {
    if (!roster) return 0;
    const long long b = align16(4LL * T * rf + kSlop);
    return b <= kRosterCap ? static_cast<int>(b) : 0;
  };
  auto buf = [&](int T) { return align16(1LL * T * n_pad + kSlop); };
  auto tile = [&](int T) { return 3 * buf(T) + ro_bytes(T); };
  if (tile(kMinRows) <= kBudget) {
    int T = kMaxRows;
    while (T > kMinRows &&
           (tile(T) > kBudget || (R + T - 1) / T < kMinBlocks))
      T /= 2;
    return Plan{T, n_pad, 0, static_cast<int>(buf(T)), ro_bytes(T)};
  }
  const int T = kMinRows;
  const int chunk = ((kBudget - ro_bytes(T)) / (3 * T) - kSlop) & ~15;
  const int stride = chunk + kSlop;
  return Plan{T, chunk, stride, T * stride, ro_bytes(T)};
}

// Zero the (B, n_real) counts on the launch's stream, before a kernel
// adds to them.
int zero_counts(void* cnt, int B, int n_real, cudaStream_t stream) {
  const size_t bytes = sizeof(int32_t) * static_cast<size_t>(B) * n_real;
  return static_cast<int>(cudaMemsetAsync(cnt, 0, bytes, stream));
}

template <int kMode, bool kCounts>
int launch(const void* up, const void* full, const void* roster,
           const void* recruit, const void* active, void* lark, void* qmaj,
           void* leader, void* lfull, void* nrep, void* repmask,
           void* rleader, void* creps, void* cnt, int R, int n_pad,
           int n_real, int rf, int voters, int B, int P, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kCounts) {
    if (R != 1LL * B * P) return static_cast<int>(cudaErrorInvalidValue);
    const int err = zero_counts(cnt, B, n_real, s);
    if (err != 0) return err;
  }
  if (R <= 0) return 0;
  static const cudaError_t attr = cudaFuncSetAttribute(
      row_eval_kernel<kMode, kCounts>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kBudget);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Plan plan = make_plan(R, n_pad, rf, kMode == kRoster);
  const int blocks = (R + plan.rows - 1) / plan.rows;
  const int smem = 3 * plan.buf + plan.ro_buf;
  row_eval_kernel<kMode, kCounts><<<blocks, plan.rows * kLanes, smem, s>>>(
      static_cast<const uint8_t*>(up), static_cast<const uint8_t*>(full),
      static_cast<const int32_t*>(roster),
      static_cast<const int32_t*>(recruit),
      static_cast<const uint8_t*>(active), static_cast<uint8_t*>(lark),
      static_cast<uint8_t*>(qmaj), static_cast<int32_t*>(leader),
      static_cast<uint8_t*>(lfull), static_cast<int32_t*>(nrep),
      static_cast<int32_t*>(repmask), static_cast<int32_t*>(rleader),
      static_cast<uint8_t*>(creps), static_cast<int32_t*>(cnt), R, n_pad,
      n_real, rf, voters, P, plan);
  return static_cast<int>(cudaGetLastError());
}

// node_count alone: one thread a row r = b P + p, no tile.
__global__ void __launch_bounds__(kCountThreads)
node_count_kernel(const int32_t* __restrict__ recruit,
                  const uint8_t* __restrict__ active,
                  int32_t* __restrict__ cnt, int R, int P, int n_real) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kCountThreads + threadIdx.x;
  int key = -1;
  if (r < R) {
    const int i = static_cast<int>(r);
    key = count_key(recruit[i], active[i] != 0, i / P, n_real);
  }
  count_warp(key, cnt);                     // every lane of the warp
}

}  // namespace

extern "C" int pac_eval_launch(const void* up, const void* full, void* lark,
                               void* maj, void* creps, int R, int n_pad,
                               int n_real, int rf, int voters,
                               void* stream) {
  return launch<kPac, false>(up, full, nullptr, nullptr, nullptr, lark, maj,
                             nullptr, nullptr, nullptr, nullptr, nullptr,
                             creps, nullptr, R, n_pad, n_real, rf, voters,
                             0, 0, stream);
}

extern "C" int downtime_eval_launch(const void* up, const void* full,
                                    const void* roster, void* lark,
                                    void* qmaj, void* leader, void* lfull,
                                    void* nrep, void* repmask,
                                    void* rleader, void* creps, int R,
                                    int n_pad, int n_real, int rf,
                                    void* stream) {
  return launch<kPlain, false>(up, full, roster, nullptr, nullptr, lark,
                               qmaj, leader, lfull, nrep, repmask, rleader,
                               creps, nullptr, R, n_pad, n_real, rf, 0, 0, 0,
                               stream);
}

extern "C" int downtime_roster_launch(const void* up, const void* full,
                                      const void* roster, void* lark,
                                      void* qmaj, void* leader, void* lfull,
                                      void* nrep, void* repmask,
                                      void* rleader, void* creps, int R,
                                      int n_pad, int n_real, int rf,
                                      void* stream) {
  return launch<kRoster, false>(up, full, roster, nullptr, nullptr, lark,
                                qmaj, leader, lfull, nrep, repmask, rleader,
                                creps, nullptr, R, n_pad, n_real, rf, 0, 0,
                                0, stream);
}

// The counts mode: the launchers above plus the in-flight counts of the
// (B, P) rows' recruit ids and active flags into cnt (B, n_real), which
// the launch zeroes first; R must equal B P.
extern "C" int downtime_eval_counts_launch(
    const void* up, const void* full, const void* roster,
    const void* recruit, const void* active, void* lark, void* qmaj,
    void* leader, void* lfull, void* nrep, void* repmask, void* rleader,
    void* creps, void* cnt, int R, int n_pad, int n_real, int rf, int B,
    int P, void* stream) {
  return launch<kPlain, true>(up, full, roster, recruit, active, lark, qmaj,
                              leader, lfull, nrep, repmask, rleader, creps,
                              cnt, R, n_pad, n_real, rf, 0, B, P, stream);
}

extern "C" int downtime_roster_counts_launch(
    const void* up, const void* full, const void* roster,
    const void* recruit, const void* active, void* lark, void* qmaj,
    void* leader, void* lfull, void* nrep, void* repmask, void* rleader,
    void* creps, void* cnt, int R, int n_pad, int n_real, int rf, int B,
    int P, void* stream) {
  return launch<kRoster, true>(up, full, roster, recruit, active, lark, qmaj,
                               leader, lfull, nrep, repmask, rleader, creps,
                               cnt, R, n_pad, n_real, rf, 0, B, P, stream);
}

// The counts alone, zeroed first: recruit, active (B, P), cnt (B, n_real).
extern "C" int node_count_launch(const void* recruit, const void* active,
                                 void* cnt, int B, int P, int n_real,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = zero_counts(cnt, B, n_real, s);
  if (err != 0 || B <= 0 || P <= 0) return err;
  const long long R = 1LL * B * P;
  const int blocks = static_cast<int>((R + kCountThreads - 1) / kCountThreads);
  node_count_kernel<<<blocks, kCountThreads, 0, s>>>(
      static_cast<const int32_t*>(recruit),
      static_cast<const uint8_t*>(active), static_cast<int32_t*>(cnt),
      static_cast<int>(R), P, n_real);
  return static_cast<int>(cudaGetLastError());
}

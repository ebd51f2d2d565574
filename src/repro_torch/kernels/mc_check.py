"""Holding the Monte Carlo row kernels ``pac_eval``, ``downtime_eval``
(plain and roster, each with and without the in-flight counts),
``node_count``, ``latency_charge``, ``fused_downtime_eval`` and
``fused_pac_eval`` against their plain versions bit for bit, the faults
that holding must catch, their bytes, and their times on the card.

The row kernels stage whole row tiles in 16-byte pieces, so the cases
reach the edges of that tiling: a row count that is not a multiple of a
tile, narrow rows (n_pad 31 and 63, n_real < n_pad), inputs that are
contiguous views at a byte offset (``data_ptr() % 16 != 0``), roster
seats outside [0, n_real), pac_eval's voters across a word and past
n_real, and latency rows whose last block is ragged.  The counts cases
(``COUNTS_CASES``) put trial boundaries inside a tile (P 4095, 100, 17),
shrink the tile to 16 rows, take B 1, 8 and 9 and n_real 1, 31, 155 and
300, plant the ids that count nowhere (-1, n_real, n_real + 5 and the
int32 extremes) on active rows, and take active all false and all true
and every row on node 0; their raw launches must also leave the words
past the counts alone.
``fused_downtime_eval`` holds W <= 8 words in registers and walks more
in a loop, so its cases take W 1, 5, 8 and 9, n_real not a multiple of
32, P not a multiple of a block, rosters at an offset, recruit ids
outside [0, n_real) and active all false and all true; ``fused_pac_eval``,
the same kernel body in its pac mode, takes W 1, 5, 8 and 9 with voters
within the first word, across it and past n_real.  Every output is
held with ``torch.equal``.  A planted fault's copy of a source is run on
outputs filled with a sentinel first, so that a row or byte it leaves
unwritten cannot pass by holding an earlier call's value.

    PYTHONPATH=src python -m repro_torch.kernels.mc_check [--parent DIR]
        [--ablate]

builds csrc/downtime_eval.cu, csrc/latency_charge.cu and
csrc/fused_downtime.cu and a copy of each per planted fault (``FAULTS``)
under ``build/``, runs every case through the kernels and the copies,
and prints one JSON line per case.  With ``--parent DIR`` (a checkout of
an earlier commit, e.g. a ``git archive`` of it) it also builds that
commit's sources of the same launchers (found by symbol, so a source
that a launcher has since left is found too, as node_count.cu) and times
both versions at the paper tile in turns, parent, change, change, parent
(``device_times``); a parent without the counts mode also has its
fill, node_count and row eval timed against one counts launch
(``STEP_PAIRS``).  ``--ablate`` times copies with one part taken out
(``ABLATIONS``).  Exits 0 when the kernels pass every case and every
fault fails at least one (pac_eval's own, ``PAC_FAULTS``, a pac_eval
case; ``FUSED_PAC_FAULTS`` a fused_pac_eval case; the counts mode's,
``COUNTS_FAULTS``, can fail only a counts case).  Needs nvcc and a
card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from . import _build, bitpack
from . import fused_step as fk
from . import pac_eval as pk

#: the paper tile: nodes, partitions, trials
N, P, B = 155, 4096, 8
#: launcher symbols by source, and their ctypes argtypes in that order
SYMBOLS = {"downtime_eval": ("downtime_eval_launch", "downtime_roster_launch",
                             "pac_eval_launch", "downtime_eval_counts_launch",
                             "downtime_roster_counts_launch",
                             "node_count_launch"),
           "latency_charge": ("latency_charge_launch",),
           "fused_downtime": ("fused_downtime_eval_launch",
                              "fused_pac_eval_launch")}
ARGTYPES = {"downtime_eval": (pk._DT_ARGTYPES, pk._DT_ARGTYPES, pk._ARGTYPES,
                              pk._DTC_ARGTYPES, pk._DTC_ARGTYPES,
                              pk._NC_ARGTYPES),
            "latency_charge": (pk._LC_ARGTYPES,),
            "fused_downtime": (fk._FDT_ARGTYPES, fk._ARGTYPES)}
#: index of the pac_eval launcher in downtime_eval.cu's SYMBOLS tuple
#: (the plain and roster launchers are 0 and 1), of its plain counts
#: launcher (COUNTS + 1 the roster one) and of node_count alone, and of
#: the fused_pac_eval launcher in fused_downtime.cu's
PAC = 2
COUNTS = 3
NODE_COUNT = 5
FUSED_PAC = 1

#: planted faults: (text that occurs once in the source, replacement)
FAULTS = {
    "downtime_eval": {
        # the creps rank compared with < in place of <=
        "creps_rank_lt": ("if (rank <= rf) sc[4 * k + byte] = 1;",
                          "if (rank < rf) sc[4 * k + byte] = 1;"),
        # a roster seat outside [0, n_real) counted as up
        "seat_out_of_range_up": (
            "if (r < 0 || r >= n_real) continue;   // out of range: reads down",
            "if (r < 0 || r >= n_real) { st.n_rep += c0 == 0; continue; }"),
        # the 16-byte piece holding a range's unaligned head not loaded
        "unaligned_head_dropped": (
            "for (int i = tid; i < pieces; i += nthr)",
            "for (int i = tid + (a != a0 ? 1 : 0); i < pieces; i += nthr)"),
        # the piece holding a range's ragged tail not loaded
        "ragged_tail_dropped": (
            "const uintptr_t a1 = (a + n + 15) & ~static_cast<uintptr_t>(15);",
            "const uintptr_t a1 = (a + n) & ~static_cast<uintptr_t>(15);"),
        # the creps bytes after the last whole 16-byte piece not stored
        "creps_tail_dropped": (
            "for (uintptr_t x = hi + tid; x < b; x += nthr)    // the ragged tail",
            "for (uintptr_t x = b + tid; x < b; x += nthr)    // the ragged tail"),
        # pac_eval's voters prefix one lane too long
        "voters_off_by_one": (
            "st.n_vote += __popc(U & low_lanes(voters - col));",
            "st.n_vote += __popc(U & low_lanes(voters + 1 - col));"),
        # the no-recruit sentinel n_real counted (on node 0 of the next
        # trial, or past the counts)
        "count_id_le_n_real": ("rc >= 0 && rc < n_real) ?",
                               "rc >= 0 && rc <= n_real) ?"),
        # a row that is not active counted
        "count_active_ignored": ("(act && rc >= 0", "(rc >= 0"),
        # every row of a tile counted in the trial of the tile's first row
        "count_trial_of_tile": ("static_cast<int>(row) / P",
                                "static_cast<int>(row0) / P"),
        # a group of rows on one node adds 1, not its size
        "count_group_size_one": ("atomicAdd(cnt + key, __popc(peers));",
                                 "atomicAdd(cnt + key, 1);"),
        # the counts not zeroed before the kernel adds to them
        "count_memset_dropped": (
            "  return static_cast<int>(cudaMemsetAsync(cnt, 0, bytes, stream));",
            "  return static_cast<int>(bytes & 0);"),
        # the rows of a ragged last tile not counted
        "count_ragged_tile_dropped": (
            "if (counting && live && part == 0) {",
            "if (counting && live && rows == plan.rows && part == 0) {"),
    },
    "latency_charge": {
        # qsum's pay * rem contracted into an FMA with the subtraction
        "qsum_fma": ("const float v = __fsub_rn(__fmul_rn(payf, remf),",
                     "const float v = fmaf(payf, remf, -1.0f *"),
        # the decay chain multiplied highest bit first
        "chain_highest_bit_first": (
            "for (int g = 0; g < kGroup; ++g)      // bit 0 first",
            "for (int g = kGroup - 1; g >= 0; --g)      // bit 0 first"),
        # dup charged from the decayed value before the 1e-30 flush
        "dup_unflushed": (
            "du[j] = fmaxf(__fmul_rn(kfv[j], __fsub_rn(x[j], nd[j])), 0.0f);",
            "du[j] = fmaxf(__fmul_rn(kfv[j], __fsub_rn(x[j], raw)), 0.0f);"),
        # the grid rounded down: a ragged last block of rows never runs
        "ragged_block_dropped": (
            "static_cast<unsigned>((R + kRows - 1) / kRows);",
            "static_cast<unsigned>(R / kRows);"),
    },
    "fused_downtime": {
        # a roster rank's bit taken from the next register word
        "word_select_next": ("const int wi = r >> 5;",
                             "const int wi = (r >> 5) + 1;"),
        # the last word's padding bits (ranks >= n_real) not masked
        "last_word_unmasked": (
            "u[k] &= prefix_mask(n_real, 32 * k);",
            "u[k] &= k + 1 < kW ? prefix_mask(n_real, 32 * k) : ~0u;"),
        # a row that is not active counted
        "inactive_row_counted": (
            "return (act && rc >= 0 && rc < n_real) ? rc : -1;",
            "return (rc >= 0 && rc < n_real) ? rc : -1;"),
        # the W > 8 loop's word stride one word short
        "loop_word_stride": (
            "const long long ws = P;                   // word stride",
            "const long long ws = P - 1;               // word stride"),
        # fused_pac_eval's voters prefix one lane too long
        "voters_one_lane_long": (
            "n_vote += __popc(u[k] & prefix_mask(voters, 32 * k));",
            "n_vote += __popc(u[k] & prefix_mask(voters + 1, 32 * k));"),
    },
}
#: downtime_eval.cu faults that a pac_eval case must fail (the rest are
#: the roster's and the counts'), those a counts case must (the counts
#: mode's own), and those a downtime_eval case must (the rest but
#: pac_eval's)
PAC_FAULTS = ("creps_rank_lt", "unaligned_head_dropped", "ragged_tail_dropped",
              "creps_tail_dropped", "voters_off_by_one")
COUNTS_FAULTS = tuple(f for f in FAULTS["downtime_eval"]
                      if f.startswith("count_"))
DOWNTIME_FAULTS = tuple(f for f in FAULTS["downtime_eval"]
                        if f != "voters_off_by_one" and
                        f not in COUNTS_FAULTS)
#: fused_downtime.cu faults that a fused_pac_eval case must fail (code the
#: pac mode shares, and its own), and those a fused_downtime_eval case
#: must (all but the pac mode's own)
FUSED_PAC_FAULTS = ("last_word_unmasked", "loop_word_stride",
                    "voters_one_lane_long")
FUSED_DOWNTIME_FAULTS = tuple(f for f in FAULTS["fused_downtime"]
                              if f != "voters_one_lane_long")

#: copies timed by --ablate: one part of the work taken out, or one size
#: or design choice changed (``probe_*``), each a list of (text,
#: replacement)
ABLATIONS = {
    "downtime_eval": {
        "empty": [("  const bool one_pass = plan.stride == 0;\n",
                   "  const bool one_pass = plan.stride == 0;\n"
                   "  if (R > 0) return;\n")],
        "no_loads": [("    cp_async16(dst + 16 * i,",
                      "    if (n < 0) cp_async16(dst + 16 * i,")],
        "no_walk": [("    if (live && wv > 0) {",
                     "    if (live && wv > 0 && R < 0) {")],
        "no_count": [("      count_share(s_up + ou,",
                      "      if (R < 0) count_share(s_up + ou,")],
        "no_creps_store": [("      store_range(creps + row0 * n_pad, s_creps,",
                            "      if (R < 0) store_range(creps + row0 * n_pad,"
                            " s_creps,")],
        **{f"rows_{t}": [("constexpr int kMaxRows = 64;",
                          f"constexpr int kMaxRows = {t};")]
           for t in (128, 32)},
        **{f"lanes_{t}": [("constexpr int kLanes = 4;",
                           f"constexpr int kLanes = {t};")]
           for t in (1, 2, 8)},
        # the counts mode without its atomics (the warp match stays)
        "no_count_atomics": [
            ("  if (key >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)\n",
             "  if (key >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1 &&\n"
             "      peers == 0u)\n")],
        # the counts mode with ids and flags made up, not loaded
        "no_count_loads": [
            ("    rc = recruit[row];\n    act = active[row] != 0;\n",
             "    rc = static_cast<int>(row % 160);\n"
             "    act = (row & 15) == 0;\n")],
        # the counts mode a run-time flag of every instantiation, not a
        # template one (the modes without counts then carry its code)
        "probe_runtime_counts": [("  constexpr bool counting = kCounts;\n",
                                  "  const bool counting = cnt != nullptr;\n")],
    },
    "latency_charge": {
        "empty": [("  const int t = threadIdx.x;\n",
                   "  const int t = threadIdx.x;\n  if (R > 0) return;\n")],
        "no_tables": [("if (i < kMaxBits && i < nbits && ((d >> i) & 1) != 0)",
                       "if (i < 0)")],
        "no_qhist": [("    *reinterpret_cast<float4*>(q + e) = make_float4(",
                      "    if (v[0] < -1.0f) *reinterpret_cast<float4*>(q + e) ="
                      " make_float4(")],
        "dt_constant": [("const int d = __ldg(dt + b);",
                         "const int d = 0x1A5 + (b & 1);")],
        "no_row_stores": [
            ("    store_row<NB>(new_dirty + r * NB,",
             "    if (rm < -2000000000) store_row<NB>(new_dirty + r * NB,"),
            ("    store_row<NB>(dup + r * NB,",
             "    if (rm < -2000000000) store_row<NB>(dup + r * NB,")],
        **{f"rows_{t}": [("constexpr int kRows = 128;",
                          f"constexpr int kRows = {t};")] for t in (64, 256)},
    },
    "fused_downtime": {
        "empty": [("  const bool counting = !kPac && cnt != nullptr;   // block-uniform\n",
                   "  const bool counting = !kPac && cnt != nullptr;   // block-uniform\n"
                   "  if (P > 0) return;\n")],
        "no_word_loads": [
            ("    u[k] = __ldg(upw + base + static_cast<long long>(k) * P);\n"
             "    f[k] = __ldg(fullw + base + static_cast<long long>(k) * P);\n",
             "    u[k] = static_cast<uint32_t>(base) * 0x9E3779B9u + k;\n"
             "    f[k] = u[k] * 0x85EBCA6Bu;\n")],
        "no_counts": [("  const bool counting = !kPac && cnt != nullptr;   // block-uniform",
                       "  const bool counting = false;")],
        "no_roster": [("  if (seats != nullptr) {\n    n_rep = 0;",
                       "  if (seats != nullptr && P < 0) {\n    n_rep = 0;")],
        # each counted row its own global atomicAdd, no warp aggregation
        "probe_row_atomics": [
            ("    const unsigned peers = __match_any_sync(0xFFFFFFFFu, node);\n"
             "    if (node >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)\n"
             "      atomicAdd(&cnt[b * n_real + node], __popc(peers));\n",
             "    if (node >= 0) atomicAdd(&cnt[b * n_real + node], 1);\n")],
        **{f"rows_{t}": [("constexpr int kThreads = 128;",
                          f"constexpr int kThreads = {t};")] for t in (64, 256)},
    },
}

#: downtime cases beside chip_smoke's dense paper-tile ones: (name, R,
#: n_pad, n_real, P(up), byte offsets of up, full and roster).  Half the
#: lanes up puts the majority and the leader on single bytes, so a byte
#: read from the wrong place shows; 3 % up puts leaders and ranks deep
#: into the rows.  8 * 4093 rows leave a ragged last tile.
DOWNTIME_CASES = (("ragged_155", 8 * 4093, 155, 155, 0.5, (0, 0, 0)),
                  ("n31", 1000, 31, 31, 0.5, (0, 0, 0)),
                  ("n63_pad", 1029, 63, 60, 0.5, (0, 0, 0)),
                  ("unaligned_155", 8 * 4093, 155, 155, 0.5, (3, 9, 4)),
                  ("sparse_unaligned_160", 4099, 160, 155, 0.03, (7, 1, 12)))
#: counts cases, each through both counts launchers and node_count alone:
#: (name, trials, partitions, n_pad, n_real, recruit ids ("mixed": in
#: [-2, n_real + 3) with every EDGE_IDS id planted on active rows,
#: "zero": every row on node 0), active ("mixed", "all" or "none")).
#: P 4095, 100 and 17 put trial boundaries inside tiles; 8 * 4095, 900,
#: 153 and 17 rows leave a ragged last tile; the small R and n_pad 31 / 63
#: shrink the tile to 16 rows; n_real 300 passes 256.
COUNTS_CASES = (("paper", 8, 4096, 155, 155, "mixed", "mixed"),
                ("p4095_straddle", 8, 4095, 155, 155, "mixed", "mixed"),
                ("p4095_node0_all", 8, 4095, 155, 155, "zero", "all"),
                ("b9_p100_n31", 9, 100, 31, 31, "mixed", "all"),
                ("b9_p17_n63_pad", 9, 17, 63, 60, "mixed", "mixed"),
                ("b1_p17_n1", 1, 17, 31, 1, "mixed", "all"),
                ("b1_p4096_n300", 1, 4096, 300, 300, "mixed", "mixed"),
                ("b8_p100_none_active", 8, 100, 155, 155, "mixed", "none"))
#: the ids outside [0, n_real) that count nowhere, as functions of n_real:
#: -1, the engine's no-recruit sentinel n_real, n_real + 5 and the int32
#: extremes
EDGE_IDS = (lambda n: -1, lambda n: n, lambda n: n + 5,
            lambda n: -2 ** 31, lambda n: 2 ** 31 - 1)
#: what a counts launch must overwrite: each count starts as SENTINEL, and
#: the GUARD words past the counts must keep it
SENTINEL, GUARD = -7, 32
#: pac_eval's (rf, voters) on each DOWNTIME_CASES case: voters within the
#: first word, at the edge of the first 32 lanes and across it, past
#: n_real (below n_pad where n_pad > n_real + 1) and past n_pad
PAC_KNOBS = ((2, 3), (3, 31), (4, 33), (30, 62), (2, 200))
#: fused_downtime_eval cases: (name, trials, W, partitions, n_real, words
#: ANDed into each up word (1: half the bits set), active ("mixed", "all"
#: or "none"), byte offset of the roster)
FUSED_CASES = (("w1_n31", 3, 1, 1000, 31, 1, "mixed", 0),
               ("w5_n155_ragged", 8, 5, 4093, 155, 1, "mixed", 0),
               ("w5_sparse_all_active", 8, 5, 4096, 155, 3, "all", 4),
               ("w5_n150_none_active", 8, 5, 1000, 150, 2, "none", 0),
               ("w8_n250", 4, 8, 777, 250, 2, "mixed", 0),
               ("w9_n270", 4, 9, 777, 270, 1, "mixed", 0),
               ("w9_n257_sparse", 2, 9, 300, 257, 4, "mixed", 4))
#: fused_pac_eval cases: (name, trials, W, partitions, n_real, words
#: ANDed into each up word); each runs with every FUSED_PAC_KNOBS
FUSED_PAC_CASES = (("w1_n31", 3, 1, 1000, 31, 1),
                   ("w5_n155_ragged", 8, 5, 4093, 155, 1),
                   ("w5_n150_sparse", 4, 5, 1000, 150, 3),
                   ("w8_n250", 4, 8, 777, 250, 1),
                   ("w9_n270", 4, 9, 777, 270, 1),
                   ("w9_n257_sparse", 2, 9, 300, 257, 3))
#: fused_pac_eval's (rf, voters): voters within the first word, at its
#: edge, across it (33), past n_real on the narrow cases, and past n_real
#: and every word on all
FUSED_PAC_KNOBS = ((2, 3), (3, 31), (4, 33), (30, 62), (2, 200), (5, 300))
#: latency cases beside the paper tile's: (name, trials, partitions, byte
#: offset of dirty and the decay tables, slo_ticks)
LATENCY_CASES = (("paper_slo0", 8, 4096, 0, 0),
                 ("paper_slo8", 8, 4096, 0, 8),
                 ("ragged_4093", 8, 4093, 0, 8),
                 ("unaligned_4096", 8, 4096, 4, 8))


# ---------------------------------------------------------------------------
# bytes each call must move (each input read once, each output written once)
# ---------------------------------------------------------------------------

def downtime_bytes(R: int, n_pad: int, rf: int = 0, *, B: int = 0,
                   n_real: int = 0) -> int:
    """downtime_eval on (R, n_pad) tiles: up and full read, creps written,
    11 bytes of row outputs; with a roster (rf > 0) its 4 R rf bytes; in
    the counts mode (B trials) those of node_count alone besides."""
    counts = counts_bytes(B, R // B, n_real) if B else 0
    return 3 * R * n_pad + 11 * R + 4 * R * rf + counts


def counts_bytes(B: int, P: int, n_real: int) -> int:
    """node_count over (B, P) rows: recruit and active read, (B, n_real)
    int32 counts written."""
    return 5 * B * P + 4 * B * n_real


def pac_bytes(R: int, n_pad: int) -> int:
    """pac_eval on (R, n_pad) tiles: up and full read, creps written,
    lark and maj a byte each."""
    return 3 * R * n_pad + 2 * R


def fused_bytes(B: int, W: int, P: int, *, rf: int = 0, n_real: int = 0,
                counts: bool = False) -> int:
    """fused_downtime_eval on (B, W, P) words: upw and fullw read, crepsw
    written, 11 bytes of row outputs; a roster's 4 B P rf bytes (rf > 0);
    with the counts, recruit and active read and (B, n_real) written."""
    nbytes = 12 * B * W * P + 11 * B * P + 4 * B * P * rf
    return nbytes + (5 * B * P + 4 * B * n_real if counts else 0)


def fused_pac_bytes(B: int, W: int, P: int) -> int:
    """fused_pac_eval on (B, W, P) words: upw and fullw read, crepsw
    written, lark and maj a byte each."""
    return 12 * B * W * P + 2 * B * P


def tables_touched(dt, nbits: int) -> int:
    """Decay tables some trial's interval selects: the set bits of the
    OR of dt below nbits."""
    bits = 0
    for d in dt:
        bits |= int(d)
    return bin(bits & ((1 << nbits) - 1)).count("1")


def latency_bytes(B: int, P: int, NB: int, nbins: int, tables: int) -> int:
    """latency_charge over (B, P) rows: dirty, dt, avail, qok, rem, the
    touched tables, kf and lamw read; nd, dup, qhist, qslo, qsum written."""
    R = B * P
    reads = (R * NB * 4 + 4 * B + 2 * R + 4 * R + tables * P * NB * 4
             + NB * 4 + P * 4)
    return reads + 2 * R * NB * 4 + R * nbins * 4 + 2 * R * 4


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def view_at(t, offset: int):
    """A contiguous copy of `t` whose ``data_ptr() % 16 == offset`` (a
    multiple of its element size): a view into a larger byte buffer."""
    nbytes = t.numel() * t.element_size()
    flat = torch.empty(nbytes + 32, dtype=torch.uint8, device=t.device)
    start = (offset - flat.data_ptr()) % 16
    v = flat[start:start + nbytes].view(t.dtype).view(t.shape)
    v.copy_(t)
    return v


def rosters(gen, R, rf, n_real, dev):
    """(R, rf) int32 distinct ranks in [0, n_real), with seats out of
    range (they read as down): n_real + 3 in every 7th row, -1 in every
    11th."""
    ro = torch.argsort(torch.rand((R, n_real), generator=gen, device=dev),
                       dim=1)[:, :rf].to(torch.int32)
    ro[::7, 0] = n_real + 3
    ro[::11, rf - 1] = -1
    return ro.contiguous()


def downtime_inputs(gen, case, rf, dev):
    """(up, full, roster) of a DOWNTIME_CASES entry, each at its offset."""
    _, R, n_pad, n_real, dens, (ou, of, orr) = case
    up = torch.rand((R, n_pad), generator=gen, device=dev) < dens
    full = torch.rand((R, n_pad), generator=gen, device=dev) < 0.5
    up[:5] = False                            # rows with no node up
    roster = rosters(gen, R, rf, n_real, dev)
    return view_at(up, ou), view_at(full, of), view_at(roster, orr)


def words(gen, shape, dens=1):
    """int32-carried words over the whole uint32 range, `dens` of them
    ANDed (about 2^-dens of the bits set)."""
    out = None
    for _ in range(dens):
        w = torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                          device=gen.device, dtype=torch.int64) \
            .to(torch.int32)
        out = w if out is None else out & w
    return out


def counts_inputs(gen, case, rf):
    """(up, full, roster, recruit, active) of a COUNTS_CASES entry: half
    the lanes up, rows with no node up, a roster with seats out of range,
    and the recruit ids and active flags the case names."""
    _, Bq, Pq, n_pad, n_real, ids, act = case
    dev = gen.device
    R = Bq * Pq
    up = torch.rand((R, n_pad), generator=gen, device=dev) < 0.5
    full = torch.rand((R, n_pad), generator=gen, device=dev) < 0.5
    up[:5] = False
    roster = rosters(gen, R, rf, max(n_real, rf), dev)
    active = {"mixed": torch.rand((R,), generator=gen, device=dev) < 0.5,
              "all": torch.ones(R, dtype=torch.bool, device=dev),
              "none": torch.zeros(R, dtype=torch.bool, device=dev)}[act]
    if ids == "zero":
        recruit = torch.zeros(R, dtype=torch.int32, device=dev)
    else:
        recruit = torch.randint(-2, n_real + 3, (R,), generator=gen,
                                device=dev, dtype=torch.int32)
        for k, edge in enumerate(EDGE_IDS):
            recruit[k::13] = edge(n_real)
            if act != "none":
                active[k::13] = True
    return (up, full, roster, recruit.reshape(Bq, Pq),
            active.reshape(Bq, Pq))


def fused_inputs(gen, case, rf):
    """(upw, fullw, roster, recruit, active) of a FUSED_CASES entry: no
    node up in the first partitions of trial 0, the roster at its byte
    offset with seats out of range, recruit ids in [-2, n_real + 3)."""
    _, Bq, W, Pq, n_real, dens, act, off = case
    dev = gen.device
    upw = words(gen, (Bq, W, Pq), dens)
    upw[0, :, :5] = 0
    fullw = words(gen, (Bq, W, Pq))
    roster = view_at(rosters(gen, Bq * Pq, rf, n_real, dev)
                     .reshape(Bq, Pq, rf), off)
    recruit = torch.randint(-2, n_real + 3, (Bq, Pq), generator=gen,
                            device=dev, dtype=torch.int32)
    active = {"mixed": torch.rand((Bq, Pq), generator=gen, device=dev) < 0.5,
              "all": torch.ones((Bq, Pq), dtype=torch.bool, device=dev),
              "none": torch.zeros((Bq, Pq), dtype=torch.bool,
                                  device=dev)}[act]
    return upw, fullw, roster, recruit, active


def latency_inputs(gen, B, P, *, slo_ticks=8):
    """latency_charge arguments: the decay tables of the paper workload
    (zipf keys, 32 requests/tick, 3M-tick horizon: 22 tables), then
    adversarial state — dt with many bits set and 0, rem below 0, inside
    and beyond dt, mixed flags, dirty fractions a few ulps around the
    1e-30 flush floor.  Returns (kwargs, plan)."""
    from ..core import client_latency as cl
    from ..core import downtime_batched as db
    dev = gen.device
    plan = cl.make_latency_plan(0, P, db.DowntimeParams(
        key_zipf=1.0, read_frac=0.8, requests_per_tick=32.0,
        slo_ticks=slo_ticks), 3_000_000)
    NB = plan.kf.shape[0]
    dirty = torch.rand((B, P, NB), generator=gen, device=dev)
    floor = torch.tensor(1e-30, dtype=torch.float32, device=dev)
    ulps = torch.randint(-4, 5, (B, P, NB), generator=gen, device=dev)
    near = (floor.view(torch.int32) + ulps.to(torch.int32)) \
        .view(torch.float32)
    dirty = torch.where(torch.rand((B, P, NB), generator=gen, device=dev)
                        < 0.3, near, dirty)
    dt = torch.randint(0, 3_000_001, (B,), generator=gen, device=dev,
                       dtype=torch.int32)
    dt[:4] = torch.tensor([0, 0x2AAAAA, 0x155555, 2 ** 21 - 1],
                          dtype=torch.int32, device=dev)
    rem = torch.randint(0, 9_000_000, (B, P), generator=gen, device=dev,
                        dtype=torch.int32)
    inside = (dt[:, None] * torch.rand((B, P), generator=gen, device=dev)) \
        .to(torch.int32)
    below = torch.randint(-50, 0, (B, P), generator=gen, device=dev,
                          dtype=torch.int32)
    col = torch.arange(P, device=dev) % 3
    rem = torch.where(col == 0, inside, torch.where(col == 1, below, rem))
    return dict(dirty=dirty, dt_i=dt,
                avail=torch.rand((B, P), generator=gen, device=dev) < 0.7,
                qok=torch.rand((B, P), generator=gen, device=dev) < 0.7,
                rem=rem,
                pow_tables=torch.as_tensor(plan.pow_tables, device=dev),
                kf=torch.as_tensor(plan.kf, device=dev),
                lamw=torch.as_tensor(plan.lamw, device=dev)), plan


# ---------------------------------------------------------------------------
# raw launches on sentinel-filled outputs
# ---------------------------------------------------------------------------

def _ptr(t):
    return None if t is None else t.data_ptr()


def run_downtime(fn, up, full, *, rf, n_real, roster=None,
                 want_repmask=False, want_rleader=False):
    """One raw launch of a downtime launcher `fn` (plain or roster symbol,
    to match `roster`); the outputs start as True / -7, and come back in
    the wrapper's order."""
    R, n_pad = up.shape
    dev = up.device

    def rows(dtype):
        if dtype == torch.bool:
            return torch.ones(R, dtype=dtype, device=dev)
        return torch.full((R,), -7, dtype=dtype, device=dev)

    lark, qmaj, lfull = (rows(torch.bool) for _ in range(3))
    leader, nrep = rows(torch.int32), rows(torch.int32)
    repmask = rows(torch.int32) if want_repmask else None
    rleader = rows(torch.int32) if want_rleader else None
    creps = torch.ones((R, n_pad), dtype=torch.bool, device=dev)
    err = fn(up.data_ptr(), full.data_ptr(), _ptr(roster), lark.data_ptr(),
             qmaj.data_ptr(), leader.data_ptr(), lfull.data_ptr(),
             nrep.data_ptr(), _ptr(repmask), _ptr(rleader), creps.data_ptr(),
             R, n_pad, n_real, rf,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "downtime_eval (raw)")
    extras = tuple(t for t in (repmask, rleader) if t is not None)
    return (lark, qmaj, leader, lfull, nrep) + extras + (creps,)


def counts_out(Bq, n_real, dev):
    """(cnt (Bq, n_real), the GUARD words after it), all SENTINEL."""
    buf = torch.full((Bq * n_real + GUARD,), SENTINEL, dtype=torch.int32,
                     device=dev)
    return buf[:Bq * n_real].view(Bq, n_real), buf[Bq * n_real:]


def run_counts(fn, up, full, *, rf, n_real, recruit, active, roster=None,
               want_repmask=False, want_rleader=False):
    """One raw launch of a counts launcher `fn` (plain or roster, to match
    `roster`) on outputs that start as True / SENTINEL; returns the
    wrapper's outputs, then the guard words past the counts."""
    R, n_pad = up.shape
    Bq, Pq = recruit.shape
    dev = up.device

    def rows(dtype):
        if dtype == torch.bool:
            return torch.ones(R, dtype=dtype, device=dev)
        return torch.full((R,), SENTINEL, dtype=dtype, device=dev)

    lark, qmaj, lfull = (rows(torch.bool) for _ in range(3))
    leader, nrep = rows(torch.int32), rows(torch.int32)
    repmask = rows(torch.int32) if want_repmask else None
    rleader = rows(torch.int32) if want_rleader else None
    creps = torch.ones((R, n_pad), dtype=torch.bool, device=dev)
    cnt, guard = counts_out(Bq, n_real, dev)
    err = fn(up.data_ptr(), full.data_ptr(), _ptr(roster), recruit.data_ptr(),
             active.data_ptr(), lark.data_ptr(), qmaj.data_ptr(),
             leader.data_ptr(), lfull.data_ptr(), nrep.data_ptr(),
             _ptr(repmask), _ptr(rleader), creps.data_ptr(), cnt.data_ptr(),
             R, n_pad, n_real, rf, Bq, Pq,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "downtime_eval counts (raw)")
    extras = tuple(t for t in (repmask, rleader) if t is not None)
    return (lark, qmaj, leader, lfull, nrep) + extras + (creps, cnt, guard)


def run_node_count(fn, recruit, active, *, n_real):
    """One raw launch of a node_count launcher `fn` on SENTINEL counts;
    returns (cnt, the guard words past it)."""
    Bq, Pq = recruit.shape
    cnt, guard = counts_out(Bq, n_real, recruit.device)
    err = fn(recruit.data_ptr(), active.data_ptr(), cnt.data_ptr(), Bq, Pq,
             n_real, torch.cuda.current_stream(recruit.device).cuda_stream)
    _build.check(err, "node_count (raw)")
    return cnt, guard


def run_pac(fn, up, full, *, rf, voters, n_real):
    """One raw launch of a pac_eval launcher `fn` on outputs that start
    True; returns (lark, maj, creps)."""
    R, n_pad = up.shape
    outs = (torch.ones(R, dtype=torch.bool, device=up.device),
            torch.ones(R, dtype=torch.bool, device=up.device),
            torch.ones((R, n_pad), dtype=torch.bool, device=up.device))
    err = fn(up.data_ptr(), full.data_ptr(), *(o.data_ptr() for o in outs),
             R, n_pad, n_real, rf, voters,
             torch.cuda.current_stream(up.device).cuda_stream)
    _build.check(err, "pac_eval (raw)")
    return outs


def run_fused(fn, upw, fullw, *, rf, n_real, roster=None, recruit=None,
              active=None, want_repmask=False, want_rleader=False):
    """One raw launch of a fused_downtime_eval launcher `fn`; the outputs
    start as True / -7 (the counts, which the kernel adds to, as 0), and
    come back in the wrapper's order."""
    Bq, W, Pq = upw.shape
    dev = upw.device

    def rows(dtype):
        if dtype == torch.bool:
            return torch.ones((Bq, Pq), dtype=dtype, device=dev)
        return torch.full((Bq, Pq), -7, dtype=dtype, device=dev)

    lark, qmaj, lfull = (rows(torch.bool) for _ in range(3))
    leader, nrep = rows(torch.int32), rows(torch.int32)
    repmask = rows(torch.int32) if want_repmask else None
    rleader = rows(torch.int32) if want_rleader else None
    crepsw = torch.full((Bq, W, Pq), -7, dtype=torch.int32, device=dev)
    counts = None if recruit is None else \
        torch.zeros((Bq, n_real), dtype=torch.int32, device=dev)
    err = fn(upw.data_ptr(), fullw.data_ptr(), _ptr(roster), _ptr(recruit),
             _ptr(active), lark.data_ptr(), qmaj.data_ptr(),
             leader.data_ptr(), lfull.data_ptr(), nrep.data_ptr(),
             _ptr(repmask), _ptr(rleader), crepsw.data_ptr(), _ptr(counts),
             Bq, W, Pq, n_real, rf,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_downtime_eval (raw)")
    extras = tuple(t for t in (repmask, rleader) if t is not None)
    outs = (lark, qmaj, leader, lfull, nrep) + extras + (crepsw,)
    return outs + ((counts,) if counts is not None else ())


def run_fused_pac(fn, upw, fullw, *, rf, voters, n_real):
    """One raw launch of a fused_pac_eval launcher `fn`; lark and maj
    start True, crepsw -7.  Returns (lark, maj, crepsw)."""
    Bq, W, Pq = upw.shape
    dev = upw.device
    outs = (torch.ones((Bq, Pq), dtype=torch.bool, device=dev),
            torch.ones((Bq, Pq), dtype=torch.bool, device=dev),
            torch.full((Bq, W, Pq), -7, dtype=torch.int32, device=dev))
    err = fn(upw.data_ptr(), fullw.data_ptr(), *(o.data_ptr() for o in outs),
             Bq, W, Pq, n_real, rf, voters,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_pac_eval (raw)")
    return outs


_LC_IN = ("dirty", "dt_i", "avail", "qok", "rem", "pow_tables", "kf", "lamw")


def run_latency(fn, args, *, nbins, slo_ticks):
    """One raw launch of a latency launcher `fn`; the outputs start as
    NaN."""
    Bq, Pq, NB = args["dirty"].shape
    dev = args["dirty"].device
    outs = [torch.full(shape, float("nan"), device=dev)
            for shape in ((Bq, Pq, NB), (Bq, Pq, NB), (Bq, Pq, nbins),
                          (Bq, Pq), (Bq, Pq))]
    err = fn(*(args[k].data_ptr() for k in _LC_IN),
             *(o.data_ptr() for o in outs), Bq, Pq, NB,
             args["pow_tables"].shape[0], nbins, slo_ticks,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "latency_charge (raw)")
    return tuple(outs)


def same(got, want) -> bool:
    return len(got) == len(want) and \
        all(torch.equal(g, w) for g, w in zip(got, want))


def int_err(got, want) -> float:
    return max(float((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               for g, w in zip(got, want))


def float_err(got, want) -> float:
    return max(float((g.double() - w.double()).abs().max())
               for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# the checks: one record per case, each fault's verdict in it
# ---------------------------------------------------------------------------

def downtime_checks(gen, faults, *, entry=None):
    """Run every DOWNTIME_CASES case (rf 2 and 3, first-rf and roster,
    with the extras) through ``entry`` (the wrapper by default; a raw
    launcher pair for another build) and through each fault's pair of
    launchers.  Yields one record per case: kernel name, tags, "equal",
    "max_abs_err" and "faults_failed"."""
    dev = gen.device
    for case in DOWNTIME_CASES:
        name, R, n_pad, n_real = case[:4]
        for rf in (2, 3):
            up, full, roster = downtime_inputs(gen, case, rf, dev)
            for with_roster in (False, True):
                kw = dict(rf=rf, n_real=n_real, want_repmask=True,
                          want_rleader=with_roster,
                          roster=roster if with_roster else None)
                want = pk.downtime_eval_plain(up, full, **kw)
                if entry is None:
                    got = pk.downtime_eval(up, full, **kw)
                else:
                    got = run_downtime(entry[int(with_roster)], up, full,
                                       **kw)
                failed = [f for f, fns in faults.items()
                          if not same(run_downtime(fns[int(with_roster)],
                                                   up, full, **kw), want)]
                torch.cuda.synchronize()
                yield {"kernel": "downtime_eval_roster" if with_roster
                       else "downtime_eval", "case": name, "R": R,
                       "n_pad": n_pad, "n_real": n_real, "rf": rf,
                       "offsets": list(case[5]), "equal": same(got, want),
                       "max_abs_err": int_err(got, want),
                       "faults_failed": failed}


def pac_checks(gen, faults, *, entry=None):
    """Run every DOWNTIME_CASES case with each PAC_KNOBS (rf, voters)
    through ``entry`` (the wrapper by default, else downtime_eval.cu's
    launchers) and each fault's pac launcher; yields one record per case,
    as ``downtime_checks``."""
    dev = gen.device
    for case in DOWNTIME_CASES:
        name, R, n_pad, n_real = case[:4]
        up, full, _ = downtime_inputs(gen, case, 2, dev)
        for rf, voters in PAC_KNOBS:
            kw = dict(rf=rf, voters=voters, n_real=n_real)
            want = pk.pac_eval_plain(up, full, **kw)
            got = pk.pac_eval(up, full, **kw) if entry is None \
                else run_pac(entry[PAC], up, full, **kw)
            failed = [f for f, fns in faults.items()
                      if not same(run_pac(fns[PAC], up, full, **kw), want)]
            torch.cuda.synchronize()
            yield {"kernel": "pac_eval", "case": name, "R": R,
                   "n_pad": n_pad, "n_real": n_real, "rf": rf,
                   "voters": voters, "offsets": list(case[5][:2]),
                   "equal": same(got, want), "max_abs_err": int_err(got, want),
                   "faults_failed": failed}


def counts_checks(gen, faults, *, rf=2):
    """Run every COUNTS_CASES case through the counts mode (first-rf and
    roster, the extras on) and node_count alone, by the wrappers and by
    each fault's launchers, whose raw launches must also leave the guard
    words past the counts alone.  Yields one record per case and kernel,
    as ``downtime_checks``."""
    for case in COUNTS_CASES:
        name, Bq, Pq, n_pad, n_real = case[:5]
        up, full, roster, recruit, active = counts_inputs(gen, case, rf)
        guard = torch.full((GUARD,), SENTINEL, dtype=torch.int32,
                           device=up.device)
        counted = dict(recruit=recruit, active=active)
        want_cnt = pk.node_count_plain(recruit, active, n_real=n_real)
        for kernel in ("downtime_eval_counts", "downtime_eval_roster_counts",
                       "node_count"):
            if kernel == "node_count":
                want = (want_cnt,)
                got = (pk.node_count(recruit, active, n_real=n_real),)

                def run(fns):
                    return run_node_count(fns[NODE_COUNT], recruit, active,
                                          n_real=n_real)
            else:
                with_roster = kernel == "downtime_eval_roster_counts"
                kw = dict(rf=rf, n_real=n_real, want_repmask=True,
                          want_rleader=with_roster,
                          roster=roster if with_roster else None)
                want = pk.downtime_eval_plain(up, full, **kw) + (want_cnt,)
                got = pk.downtime_eval(up, full, **counted, **kw)

                def run(fns, kw=kw, idx=COUNTS + int(with_roster)):
                    return run_counts(fns[idx], up, full, **counted, **kw)
            failed = [f for f, fns in faults.items()
                      if not same(run(fns), want + (guard,))]
            torch.cuda.synchronize()
            yield {"kernel": kernel, "case": name, "B": Bq, "P": Pq,
                   "n_pad": n_pad, "n_real": n_real, "rf": rf,
                   "active": case[6], "ids": case[5],
                   "equal": same(got, want), "max_abs_err": int_err(got, want),
                   "faults_failed": failed}


def fused_checks(gen, faults, *, entry=None):
    """Run every FUSED_CASES case (rf 2 and 3; first-rf and roster, each
    with and without the counts; the extras on) through ``entry`` (the
    wrapper by default, else a raw launcher) and each fault's launcher;
    yields one record per case, as ``downtime_checks``."""
    for case in FUSED_CASES:
        name, Bq, W, Pq, n_real = case[:5]
        for rf in (2, 3):
            upw, fullw, roster, recruit, active = fused_inputs(gen, case, rf)
            for with_roster in (False, True):
                for counts in (False, True):
                    kw = dict(rf=rf, n_real=n_real, want_repmask=True,
                              want_rleader=with_roster,
                              roster=roster if with_roster else None)
                    if counts:
                        kw.update(recruit=recruit, active=active)
                    want = fk.fused_downtime_eval_plain(upw, fullw, **kw)
                    got = fk.fused_downtime_eval(upw, fullw, **kw) \
                        if entry is None else run_fused(entry[0], upw, fullw,
                                                        **kw)
                    failed = [f for f, fns in faults.items()
                              if not same(run_fused(fns[0], upw, fullw, **kw),
                                          want)]
                    torch.cuda.synchronize()
                    yield {"kernel": "fused_downtime_eval", "case": name,
                           "B": Bq, "W": W, "P": Pq, "n_real": n_real,
                           "rf": rf, "roster": with_roster, "counts": counts,
                           "active": case[6], "equal": same(got, want),
                           "max_abs_err": int_err(got, want),
                           "faults_failed": failed}


def fused_pac_checks(gen, faults, *, entry=None):
    """Run every FUSED_PAC_CASES case with each FUSED_PAC_KNOBS (rf,
    voters) through ``entry`` (the wrapper by default, else
    fused_downtime.cu's launchers) and each fault's fused_pac_eval
    launcher; yields one record per case, as ``downtime_checks``."""
    for case in FUSED_PAC_CASES:
        name, Bq, W, Pq, n_real, dens = case
        upw = words(gen, (Bq, W, Pq), dens)
        upw[0, :, :5] = 0
        fullw = words(gen, (Bq, W, Pq))
        for rf, voters in FUSED_PAC_KNOBS:
            kw = dict(rf=rf, voters=voters, n_real=n_real)
            want = fk.fused_pac_eval_plain(upw, fullw, **kw)
            got = fk.fused_pac_eval(upw, fullw, **kw) if entry is None \
                else run_fused_pac(entry[FUSED_PAC], upw, fullw, **kw)
            failed = [f for f, fns in faults.items()
                      if not same(run_fused_pac(fns[FUSED_PAC], upw, fullw,
                                                **kw), want)]
            torch.cuda.synchronize()
            yield {"kernel": "fused_pac_eval", "case": name, "B": Bq,
                   "W": W, "P": Pq, "n_real": n_real, "rf": rf,
                   "voters": voters, "equal": same(got, want),
                   "max_abs_err": int_err(got, want),
                   "faults_failed": failed}


def latency_checks(gen, faults, *, entry=None, nbins=16):
    """Run every LATENCY_CASES case through ``entry`` (the wrapper by
    default, else a raw launcher) and each fault's launcher; yields one
    record per case, as ``downtime_checks``."""
    for name, Bq, Pq, off, slo in LATENCY_CASES:
        args, _ = latency_inputs(gen, Bq, Pq, slo_ticks=slo)
        if off:
            args["dirty"] = view_at(args["dirty"], off)
            args["pow_tables"] = view_at(args["pow_tables"], off)
        want = pk.latency_charge_plain(**args, nbins=nbins, slo_ticks=slo)
        if entry is None:
            got = pk.latency_charge(**args, nbins=nbins, slo_ticks=slo)
        else:
            got = run_latency(entry[0], args, nbins=nbins, slo_ticks=slo)
        failed = [f for f, fns in faults.items()
                  if not same(run_latency(fns[0], args, nbins=nbins,
                                          slo_ticks=slo), want)]
        torch.cuda.synchronize()
        yield {"kernel": "latency_charge", "case": name, "B": Bq, "P": Pq,
               "offset": off, "slo_ticks": slo, "equal": same(got, want),
               "max_abs_err": float_err(got, want),
               "dup_sum": got[1].double().sum().item(),
               "flushed": int((got[0] == 0).sum().item()),
               "faults_failed": failed}


# ---------------------------------------------------------------------------
# device time apart from launch rate
# ---------------------------------------------------------------------------

def device_times(launch, *, reps: int = 200, cold_reps: int = 20,
                 attempts: int = 3, events=None) -> dict:
    """Times of one raw launch; ``launch(stream)`` makes it on the CUDA
    stream whose handle it is given and returns its cudaError_t (the
    first launch's is checked).

    device_ms: the device time per launch under torch.profiler over
    `reps` back-to-back launches (the card's time, no launch gaps: the
    durations of all its kernels and memsets, ``device_ops`` of them a
    launch), read from the profiler's trace events; the profiler now and
    then hands back a trace with no device event at all (or, where a
    launch makes `events` device events, one that lost some), so the pass
    is made up to `attempts` times, and if every trace falls short
    device_ms is the CUDA-event time of the same launches (launch gaps
    included) and device_ops the last trace's count a launch (None when
    it was empty); ``device_ms_by`` says which ("profiler" or
    "cuda_events"), ``profiler_attempts`` how many passes were made;
    graph_ms: per launch, replaying a CUDA graph of `reps` launches (the
    handle is read inside the capture, so they land on its stream);
    cold_ms: the mean time of one launch right after 128 MiB were written
    and another 128 MiB read (the 50 MB L2 holds none of its inputs, and
    no dirty line of the write is left to drain into the launch), the
    write's and read's own time taken out by an event between them and
    the launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def stream():
        return torch.cuda.current_stream().cuda_stream

    _build.check(launch(stream()), "timed launch")
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                launch(stream())
            torch.cuda.synchronize()
        total_ns = count = 0
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                total_ns += e.duration_ns()
                count += 1
        if count and total_ns > 0 and (events is None or
                                       count == reps * events):
            device_ms, device_ops, by = total_ns / reps / 1e6, count / reps, \
                "profiler"
            break
    else:
        device_ms, device_ops, by = event_ms(launch, reps), \
            count / reps if count else None, "cuda_events"

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):             # warm-up off the capture
        launch(stream())
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            launch(stream())
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    graph_ms = t0.elapsed_time(t1) / reps
    del graph

    flush = torch.empty(32 * 2 ** 20, dtype=torch.int32, device="cuda")
    clean = torch.zeros_like(flush)
    pairs = []
    for i in range(cold_reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        flush.fill_(i)
        clean.max()                           # evicts the dirty lines
        a.record()
        launch(stream())
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    cold_ms = sum(a.elapsed_time(b) for a, b in pairs) / cold_reps
    return {"device_ms": device_ms, "device_ops": device_ops,
            "device_ms_by": by, "profiler_attempts": attempt,
            "graph_ms": graph_ms, "cold_ms": cold_ms}


def event_ms(launch, reps: int = 200) -> float:
    """Mean ms per launch over `reps` back-to-back raw launches, by CUDA
    events (launch rate and device time together)."""
    s = torch.cuda.current_stream().cuda_stream
    launch(s)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        launch(s)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# ---------------------------------------------------------------------------
# the paper-tile shapes the main path gives the kernels, for timing
# ---------------------------------------------------------------------------

def raw_launch(fn, ptrs, *tensors):
    """launch(stream) = fn(*ptrs, stream), holding `tensors` (the buffers
    behind the pointers) for as long as it lives: a buffer freed while its
    pointer is still launched on is written after PyTorch's cache has
    handed it on, or, once a CUDA graph capture has emptied the cache,
    after it was freed on the device (an illegal address)."""
    def launch(s):
        return fn(*ptrs, s)
    launch.holds = tensors
    return launch


def paper_downtime(gen):
    """(up, full, roster) at the paper tile in a mostly-up cluster, rf 2."""
    dev = gen.device
    up = torch.rand((B * P, N), generator=gen, device=dev) < 0.99
    full = torch.rand((B * P, N), generator=gen, device=dev) < 0.02
    return up, full, rosters(gen, B * P, 2, N, dev)


def downtime_launch(fn, up, full, roster=None, rf=2):
    """launch(stream) for a raw downtime launcher (the roster one when
    `roster` is given) on fresh outputs (no extras), and those outputs."""
    outs = pk.downtime_eval(up, full, rf=rf, n_real=N, roster=roster)
    ptrs = (up.data_ptr(), full.data_ptr(), _ptr(roster),
            *(o.data_ptr() for o in outs[:5]), None, None,
            outs[5].data_ptr(), up.shape[0], up.shape[1], N, rf)
    return raw_launch(fn, ptrs, up, full, roster, outs), outs


def counts_launch(fn, up, full, roster, recruit, active, rf=2):
    """launch(stream) for a raw counts launcher (the roster one when
    `roster` is given) on fresh outputs (no extras), and those outputs."""
    outs = pk.downtime_eval(up, full, rf=rf, n_real=N, roster=roster,
                            recruit=recruit, active=active)
    Bq, Pq = recruit.shape
    ptrs = (up.data_ptr(), full.data_ptr(), _ptr(roster), recruit.data_ptr(),
            active.data_ptr(), *(o.data_ptr() for o in outs[:5]), None, None,
            outs[5].data_ptr(), outs[6].data_ptr(), up.shape[0], up.shape[1],
            N, rf, Bq, Pq)
    return raw_launch(fn, ptrs, up, full, roster, recruit, active, outs), outs


def node_count_launch(fn, recruit, active):
    """launch(stream) for a raw node_count launcher on fresh counts, and
    those counts."""
    cnt = torch.zeros((recruit.shape[0], N), dtype=torch.int32,
                      device=recruit.device)
    ptrs = (recruit.data_ptr(), active.data_ptr(), cnt.data_ptr(),
            *recruit.shape, N)
    return raw_launch(fn, ptrs, recruit, active, cnt), cnt


def split_step_launch(count_fn, eval_fn, up, full, roster, recruit, active):
    """launch(stream) for an earlier tree's unpacked bandwidth step, whose
    ``node_count_launch`` (`count_fn`) adds to counts its wrapper zeroed:
    the fill, the counts and the row eval (`eval_fn`, the roster launcher
    when `roster` is given), three device ops on the stream."""
    eval_launch, _ = downtime_launch(eval_fn, up, full, roster)
    cnt = torch.empty((recruit.shape[0], N), dtype=torch.int32,
                      device=recruit.device)
    ptrs = (recruit.data_ptr(), active.data_ptr(), cnt.data_ptr(),
            *recruit.shape, N)

    def launch(s):
        cnt.zero_()                           # on the current stream, s
        return count_fn(*ptrs, s) or eval_launch(s)
    return launch


def paper_latency(gen, nbins=16):
    """latency_charge arguments at the main path's shape: dirty fractions
    in [0, 1), intervals of a few to a few hundred ticks, rebuilds under
    128 ticks; and launch(stream) for a raw launcher on them."""
    args, _ = latency_inputs(gen, B, P)
    args["dt_i"] = torch.randint(1, 400, (B,), generator=gen,
                                 device=gen.device, dtype=torch.int32)
    args["rem"] = torch.randint(0, 128, (B, P), generator=gen,
                                device=gen.device, dtype=torch.int32)
    return args


def latency_launch(fn, args, nbins=16, slo_ticks=8):
    outs = pk.latency_charge(**args, nbins=nbins, slo_ticks=slo_ticks)
    Bq, Pq, NB = args["dirty"].shape
    ptrs = (*(args[k].data_ptr() for k in _LC_IN),
            *(o.data_ptr() for o in outs), Bq, Pq, NB,
            args["pow_tables"].shape[0], nbins, slo_ticks)
    return raw_launch(fn, ptrs, args, outs), outs


def pac_launch(fn, up, full, rf=2, voters=3):
    """launch(stream) for a raw pac_eval launcher on fresh outputs, and
    those outputs."""
    outs = pk.pac_eval(up, full, rf=rf, voters=voters, n_real=N)
    ptrs = (up.data_ptr(), full.data_ptr(), *(o.data_ptr() for o in outs),
            up.shape[0], up.shape[1], N, rf, voters)
    return raw_launch(fn, ptrs, up, full, outs), outs


def fused_pac_launch(fn, upw, fullw, rf=2, voters=3):
    """launch(stream) for a raw fused_pac_eval launcher on fresh outputs
    (the §5.1 main path's rf = 2, voters = 3), and those outputs."""
    outs = fk.fused_pac_eval(upw, fullw, rf=rf, voters=voters, n_real=N)
    Bq, W, Pq = upw.shape
    ptrs = (upw.data_ptr(), fullw.data_ptr(), *(o.data_ptr() for o in outs),
            Bq, W, Pq, N, rf, voters)
    return raw_launch(fn, ptrs, upw, fullw, outs), outs


def paper_fused(gen, roster):
    """(upw, fullw, roster, recruit, active) at the paper tile: the words
    of a mostly-up cluster, `roster` (B * P, rf) as the engine carries it,
    5 % of the partitions catching up on a node in [0, N]."""
    dev = gen.device
    up = torch.rand((B, P, N), generator=gen, device=dev) < 0.99
    full = torch.rand((B, P, N), generator=gen, device=dev) < 0.02
    upw = bitpack.pack_words(up).movedim(-1, 1).contiguous()
    fullw = bitpack.pack_words(full).movedim(-1, 1).contiguous()
    recruit = torch.randint(0, N + 1, (B, P), generator=gen, device=dev,
                            dtype=torch.int32)
    active = torch.rand((B, P), generator=gen, device=dev) < 0.05
    return upw, fullw, roster.reshape(B, P, -1), recruit, active


def fused_launch(fn, upw, fullw, roster=None, recruit=None, active=None):
    """launch(stream) for a raw fused_downtime_eval launcher on fresh
    outputs (no extras; the counts when recruit is given), and those
    outputs."""
    rf = 2 if roster is None else roster.shape[-1]
    outs = fk.fused_downtime_eval(upw, fullw, rf=rf, n_real=N, roster=roster,
                                  recruit=recruit, active=active)
    Bq, W, Pq = upw.shape
    ptrs = (upw.data_ptr(), fullw.data_ptr(), _ptr(roster), _ptr(recruit),
            _ptr(active), *(o.data_ptr() for o in outs[:5]), None, None,
            outs[5].data_ptr(), outs[6].data_ptr() if recruit is not None
            else None, Bq, W, Pq, N, rf)
    return raw_launch(fn, ptrs, upw, fullw, roster, recruit, active,
                      outs), outs


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------

#: the launches timed at the paper tile: label -> launcher symbol; the
#: counts launchers at the bandwidth steps' shapes (5 % of the rows in
#: flight), the roster one also with every row counting node 0 (the
#: counts' worst contention), and node_count alone on the same ids; the
#: fused kernel at the reconfig-with-bandwidth shape (rf = 2 roster and
#: the counts), at the fixed model's (neither), and at the first with
#: every row on node 0; its pac mode on the same words
TIMED = {"pac_eval": "pac_eval_launch",
         "fused_pac_eval": "fused_pac_eval_launch",
         "downtime_eval": "downtime_eval_launch",
         "downtime_eval_roster": "downtime_roster_launch",
         "downtime_eval_counts": "downtime_eval_counts_launch",
         "downtime_eval_roster_counts": "downtime_roster_counts_launch",
         "downtime_eval_roster_counts_hot": "downtime_roster_counts_launch",
         "node_count": "node_count_launch",
         "latency_charge": "latency_charge_launch",
         "fused_downtime_eval": "fused_downtime_eval_launch",
         "fused_downtime_eval_fixed": "fused_downtime_eval_launch",
         "fused_downtime_eval_hot": "fused_downtime_eval_launch"}
#: --parent pairs whose two sides make different launches, for a parent
#: without the counts mode: its unpacked bandwidth step (the wrapper's
#: fill, ``node_count_launch`` and the row eval: label -> the parent's
#: row-eval symbol) against this tree's one counts launch (its memset
#: and kernel: the change's symbol)
STEP_PAIRS = {"step_plain_counts": ("downtime_eval_launch",
                                    "downtime_eval_counts_launch"),
              "step_roster_counts": ("downtime_roster_launch",
                                     "downtime_roster_counts_launch")}


def build_fault_copies(out_dir: Path) -> dict:
    """{source: {fault: tuple of its launchers}}: one built copy of each
    source per planted fault."""
    procs = {src: _build.start_variants(src, faults, out_dir,
                                        with_source=False)
             for src, faults in FAULTS.items()}
    return {src: _build.finish_variants(procs[src], SYMBOLS[src],
                                        ARGTYPES[src]) for src in FAULTS}


def paper_state(seed: int) -> dict:
    """The inputs of every TIMED launch at the paper tile."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    up, full, roster = paper_downtime(gen)
    fused = paper_fused(gen, roster)
    return {"up": up, "full": full, "roster": roster,
            "latency": paper_latency(gen), "fused": fused,
            "hot": (torch.zeros_like(fused[3]), torch.ones_like(fused[4]))}


def paper_launches(state: dict, fns: dict) -> dict:
    """{label: (launch(stream), outputs)} for each TIMED label whose
    symbol `fns` ({symbol: ctypes launcher}) holds."""
    up, full, roster = state["up"], state["full"], state["roster"]
    upw, fullw, rost3, recruit, active = state["fused"]
    make = {
        "pac_eval": lambda fn: pac_launch(fn, up, full),
        "fused_pac_eval": lambda fn: fused_pac_launch(fn, upw, fullw),
        "downtime_eval": lambda fn: downtime_launch(fn, up, full),
        "downtime_eval_roster": lambda fn: downtime_launch(fn, up, full,
                                                           roster),
        "downtime_eval_counts": lambda fn: counts_launch(
            fn, up, full, None, recruit, active),
        "downtime_eval_roster_counts": lambda fn: counts_launch(
            fn, up, full, roster, recruit, active),
        "downtime_eval_roster_counts_hot": lambda fn: counts_launch(
            fn, up, full, roster, *state["hot"]),
        "node_count": lambda fn: node_count_launch(fn, recruit, active),
        "latency_charge": lambda fn: latency_launch(fn, state["latency"]),
        "fused_downtime_eval": lambda fn: fused_launch(
            fn, upw, fullw, rost3, recruit, active),
        "fused_downtime_eval_fixed": lambda fn: fused_launch(fn, upw, fullw),
        "fused_downtime_eval_hot": lambda fn: fused_launch(
            fn, upw, fullw, rost3, *state["hot"]),
    }
    return {label: make[label](fns[sym]) for label, sym in TIMED.items()
            if sym in fns}


def ab_times(parent: dict, change: dict) -> list:
    """Each TIMED launch the parent has, and each STEP_PAIRS pair when the
    parent has no counts mode, at the paper tile, parent and change in
    turns (parent, change, change, parent); `parent` and `change` map a
    launcher symbol to its ctypes function.  One record per turn."""
    state = paper_state(3)
    sides = {side: {label: launch for label, (launch, _) in
                    paper_launches(state, fns).items()}
             for side, fns in (("parent", parent), ("change", change))}
    up, full, roster = state["up"], state["full"], state["roster"]
    recruit, active = state["fused"][3:]
    for label, (parent_sym, change_sym) in STEP_PAIRS.items():
        if "downtime_eval_counts_launch" in parent or \
                "node_count_launch" not in parent:
            continue
        ro = roster if "roster" in label else None
        sides["parent"][label] = split_step_launch(
            parent["node_count_launch"], parent[parent_sym], up, full, ro,
            recruit, active)
        sides["change"][label], _ = counts_launch(change[change_sym], up,
                                                  full, ro, recruit, active)
    out = []
    for label in sides["parent"]:
        for side in ("parent", "change", "change", "parent"):
            launch = sides[side][label]
            out.append({"kernel": label, "side": side,
                        "ms": event_ms(launch), **device_times(launch)})
    return out


def ablate(procs: dict, change: dict) -> list:
    """device_times of each ABLATIONS copy (`procs`: {source: the handle
    of ``_build.start_variants``}) at the paper tile, beside the unchanged
    source's, on each of the source's TIMED launches; a copy that cannot
    be timed gets an "error" in place of its times."""
    state = paper_state(4)
    fns = {(src, "source"): {sym: change[sym] for sym in SYMBOLS[src]}
           for src in SYMBOLS}
    for src, handle in procs.items():
        for name, found in _build.finish_variants(
                handle, SYMBOLS[src], ARGTYPES[src]).items():
            fns[(src, name)] = dict(zip(SYMBOLS[src], found))
    out = []
    for (src, name), by_symbol in sorted(fns.items()):
        for label, (launch, _) in paper_launches(state, by_symbol).items():
            try:
                times = device_times(launch)
            except RuntimeError as err:
                times = {"error": str(err)}
            out.append({"kernel": label, "variant": name, **times})
    return out


def parent_sources(csrc: Path) -> dict:
    """{source name: its launcher symbols} of an earlier checkout's csrc/
    for the symbols TIMED names (pac_eval and fused_pac_eval had sources
    of their own)."""
    found = {}
    for cu in sorted(csrc.glob("*.cu")):
        text = cu.read_text()
        syms = tuple(sym for sym in dict.fromkeys(TIMED.values())
                     if f'extern "C" int {sym}(' in text)
        if syms:
            found[cu.stem] = syms
    return found


def argtypes_of(symbol: str):
    """The ctypes argtypes of a launcher symbol of SYMBOLS."""
    for src, syms in SYMBOLS.items():
        if symbol in syms:
            return ARGTYPES[src][syms.index(symbol)]
    raise KeyError(symbol)


def missed_faults(caught: dict) -> list:
    """Faults that failed no case, PAC_FAULTS that failed no pac_eval case
    and FUSED_PAC_FAULTS no fused_pac_eval case (`caught`: {source:
    {fault: ["kernel:case", ...]}})."""
    missed = [f for fl in caught.values() for f, cases in fl.items()
              if not cases]
    for src, kernel, faults in (("downtime_eval", "pac_eval", PAC_FAULTS),
                                ("fused_downtime", "fused_pac_eval",
                                 FUSED_PAC_FAULTS)):
        if src not in caught:
            continue
        missed += [f"{f} ({kernel})" for f in faults
                   if f in caught[src] and f not in missed and not any(
                       c.startswith(f"{kernel}:") for c in caught[src][f])]
    return missed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of the commit to time "
                    "against (its src/repro_torch/kernels/csrc)")
    ap.add_argument("--ablate", action="store_true",
                    help="also time the ABLATIONS copies")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mc_check needs an NVIDIA card", file=sys.stderr)
        return 2
    out_dir = _build.BUILD_DIR / "mc_check"
    out_dir.mkdir(parents=True, exist_ok=True)
    parent_procs = {}
    if args.parent:
        csrc = Path(args.parent) / "src" / "repro_torch" / "kernels" / "csrc"
        for src, syms in parent_sources(csrc).items():
            so = out_dir / f"lib{src}-parent.so"
            parent_procs[src] = (syms, {"parent": (
                _build._nvcc(so, csrc / f"{src}.cu"), so)})
    ablation_procs = {src: _build.start_variants(src, variants, out_dir,
                                                 with_source=False)
                      for src, variants in ABLATIONS.items()} \
        if args.ablate else {}
    faults = build_fault_copies(out_dir)
    _build.build(tuple(SYMBOLS))
    change = {sym: _build.function(src, sym, argtypes_of(sym))
              for src, syms in SYMBOLS.items() for sym in syms}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    ok = True
    caught = {src: {f: [] for f in fl} for src, fl in FAULTS.items()}
    for src, checks in (("downtime_eval", downtime_checks),
                        ("downtime_eval", pac_checks),
                        ("downtime_eval", counts_checks),
                        ("latency_charge", latency_checks),
                        ("fused_downtime", fused_checks),
                        ("fused_downtime", fused_pac_checks)):
        for rec in checks(gen, faults[src]):
            print(json.dumps(rec), flush=True)
            ok = ok and rec["equal"]
            for f in rec["faults_failed"]:
                caught[src][f].append(f"{rec['kernel']}:{rec['case']}")
    missed = missed_faults(caught)
    print(json.dumps({"faults_caught_in": caught, "missed": missed}),
          flush=True)
    if parent_procs:
        parent = {}
        for syms, handle in parent_procs.values():
            found = _build.finish_variants(
                handle, syms, tuple(argtypes_of(s) for s in syms))["parent"]
            parent.update(zip(syms, found))
        for rec in ab_times(parent, change):
            print(json.dumps({"ab": rec}), flush=True)
    for rec in ablate(ablation_procs, change) if ablation_procs else ():
        print(json.dumps({"ablate": rec}), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "kernels_equal": ok, "faults_missed": missed}))
    return 0 if ok and not missed else 1


if __name__ == "__main__":
    sys.exit(main())

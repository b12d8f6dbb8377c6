"""The wl2 convergence loop's carry and control steps (pprx_torch.engine.loop,
K4's plain version) on the CPU.

Each case of the smoke script's table (``chip_smoke.K4_CASES``, the table
the card holds K4 to) is held to values written by hand from the
reference's rules at ``pprx/engine/wl2.py:574-684`` (the prime, ``use_wl``,
the tier index as a count of misses, the emitted list's validity, the
stats-skip, the ``scans_*`` tallies, the loop's condition) and the port's
stats-skip (no stats where no round follows); its ``sharded_*`` cases under
the sharded wl engine's rule from ``pprx/dist/wl.py`` (the first round runs
whatever the list; the stats-skip reads ``ewr``). Then the host loop on those
steps against the JAX package's driver on a stream, f64, both modes: the
same rounds and tallies, p/r at 1e-12, and its round log replays through
``decide``. The host loop runs the steps the loop graph launches: ``prime``,
then a ``turn`` (the last round's ``tally``, the next one's ``decide``) a
round and one more, and ``after_scan`` in scan rounds.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pprx.config import PprConfig, StreamConfig
from pprx.graph.fast_stream import FastStreamDriver as JaxDriver
from pprx.graph.io import synthetic_powerlaw_stream
from pprx_torch.engine import graphs, loop
from pprx_torch.engine.state import FORWARD, REVERSE
from pprx_torch.graph.fast_stream import FastStreamDriver

torch.set_num_threads(1)

L = loop
BIG = loop.BIG
PRIME_KEEPS = (L.MAX_ROUNDS, L.C0OK)

# what each step leaves, written from the reference's rules: prime clears
# the head but for MAX_ROUNDS and C0OK and sets these slots; the other steps
# change these slots (and log rows: {round: {column: value}}) alone
EXPECTED = {
    "prime_invalid_list": {L.CN: 5, L.FED: 10, L.FRE: 1, L.OK: 0, L.NA: 1, L.GO: 1},
    "prime_empty_list": {L.OK: 1, L.NA: 0, L.GO: 0},
    "prime_valid_list": {L.CN: 3, L.FED: 9, L.FRE: 2, L.OK: 1, L.NA: 1, L.GO: 1},
    "prime_no_rounds": {L.CN: 3, L.FED: 9, L.FRE: 2, L.OK: 0, L.NA: 1, L.GO: 0},
    "decide_invalid_list": {L.BRANCH: 3, "log": {2: [3, 0, 1, 1, 1, 0, 0, 0]}},
    "decide_tier0_border": {L.BRANCH: 0, "log": {2: [0, 1, 8, 32, 4, 0, 0, 0]}},
    "decide_cn_past_tier0": {L.BRANCH: 1, "log": {2: [1, 1, 9, 32, 4, 0, 0, 0]}},
    "decide_fed_past_tier0": {L.BRANCH: 1, "log": {2: [1, 1, 8, 33, 4, 0, 0, 0]}},
    "decide_fre_past_tier0": {L.BRANCH: 1, "log": {2: [1, 1, 8, 32, 5, 0, 0, 0]}},
    "decide_tier1_border": {L.BRANCH: 1, "log": {2: [1, 1, 64, 512, 16, 0, 0, 0]}},
    "decide_cn_past_tier1": {L.BRANCH: 2, "log": {2: [2, 1, 65, 512, 16, 0, 0, 0]}},
    "decide_fed_skips_tier1": {L.BRANCH: 2, "log": {2: [2, 1, 9, 600, 0, 0, 0, 0]}},
    "decide_top_border": {L.BRANCH: 2, "log": {2: [2, 1, 256, 2048, 64, 0, 0, 0]}},
    "decide_cn_past_top": {L.BRANCH: 3, "log": {2: [3, 1, 257, 0, 0, 0, 0, 0]}},
    "decide_fed_past_top": {L.BRANCH: 3, "log": {2: [3, 1, 0, 2049, 0, 0, 0, 0]}},
    "decide_fre_past_top": {L.BRANCH: 3, "log": {2: [3, 1, 0, 0, 65, 0, 0, 0]}},
    "decide_skip_sentinel": {L.BRANCH: 3, "log": {2: [3, 1, BIG, BIG, BIG, 0, 0, 0]}},
    "decide_past_the_log": {L.BRANCH: 0},  # round 1024 is not logged
    "after_scan_light": {L.HEAVY: 0, L.STATS: 1},
    "after_scan_heavy": {L.HEAVY: 1, L.STATS: 0},
    "after_scan_no_active": {L.HEAVY: 0, L.STATS: 0},
    "after_scan_last_round": {L.HEAVY: 0, L.STATS: 0},
    "after_scan_next_to_last": {L.HEAVY: 0, L.STATS: 1},
    "after_scan_after_a_tier": {L.STATS: 0},
    "tally_tier_fits_emit": {
        L.CN: 64, L.FED: 100, L.FRE: 3, L.OK: 1, L.NA: 12, L.EW: 400, L.ROUNDS: 3,
        L.PUSHES: 112, L.EDGE_PUSHES: 1400, L.WL_ROUNDS: 2, L.EXECS: 2, L.GO: 1,
        "log": {2: {5: 12, 6: 400, 7: 0}}},
    "tally_tier_past_emit": {
        L.CN: 65, L.FED: 100, L.FRE: 3, L.OK: 0, L.NA: 12, L.EW: 400, L.ROUNDS: 3,
        L.PUSHES: 112, L.EDGE_PUSHES: 1400, L.WL_ROUNDS: 2, L.EXECS: 2, L.GO: 1,
        "log": {2: {5: 12, 6: 400, 7: 0}}},
    "tally_top_tier": {
        L.CN: 300, L.FED: 100, L.FRE: 3, L.OK: 0, L.NA: 12, L.EW: 400, L.ROUNDS: 3,
        L.PUSHES: 112, L.EDGE_PUSHES: 1400, L.WL_ROUNDS: 2, L.EXECS + 2: 1, L.GO: 1,
        "log": {2: {5: 12, 6: 400, 7: 0}}},
    "tally_light_scan_stats": {
        L.CN: 40, L.FED: 50, L.FRE: 6, L.OK: 1, L.NA: 9, L.EW: 100, L.ROUNDS: 3,
        L.PUSHES: 109, L.EDGE_PUSHES: 1100, L.STATS_READS: 1, L.SCANS_CAND: 2,
        L.SCANS_FED: 1, L.SCANS_LIV: 1, L.EXECS + 3: 2, L.EXECS + 4: 1, L.GO: 1,
        "log": {2: {5: 9, 6: 100, 7: 1}}},
    "tally_light_scan_no_stats": {
        L.CN: 0, L.FED: 0, L.FRE: 0, L.OK: 1, L.NA: 0, L.EW: 100, L.ROUNDS: 3,
        L.EDGE_PUSHES: 1100, L.EXECS + 3: 2, L.GO: 0, "log": {2: {5: 0, 6: 100, 7: 0}}},
    "tally_heavy_scan": {
        L.CN: BIG, L.FED: BIG, L.FRE: BIG, L.OK: 0, L.NA: 9, L.EW: 5000, L.ROUNDS: 3,
        L.PUSHES: 109, L.EDGE_PUSHES: 6000, L.SCANS_CAND: 2, L.SCANS_FED: 1,
        L.SCANS_LIV: 1, L.EXECS + 3: 2, L.GO: 1, "log": {2: {5: 9, 6: 5000, 7: 0}}},
    "tally_reaches_max_rounds": {
        L.CN: 1, L.FED: 1, L.FRE: 1, L.OK: 1, L.NA: 9, L.EW: 10, L.ROUNDS: 6,
        L.PUSHES: 109, L.EDGE_PUSHES: 1010, L.WL_ROUNDS: 2, L.EXECS: 2, L.GO: 0,
        "log": {5: {5: 9, 6: 10, 7: 0}}},
    "tally_goes_on": {
        L.CN: 1, L.FED: 1, L.FRE: 1, L.OK: 1, L.NA: 9, L.EW: 10, L.ROUNDS: 5,
        L.PUSHES: 109, L.EDGE_PUSHES: 1010, L.WL_ROUNDS: 2, L.EXECS: 2, L.GO: 1,
        "log": {4: {5: 9, 6: 10, 7: 0}}},
    "tally_no_active": {
        L.CN: 1, L.FED: 1, L.FRE: 1, L.OK: 1, L.NA: 0, L.EW: 0, L.ROUNDS: 3,
        L.WL_ROUNDS: 2, L.EXECS + 1: 1, L.GO: 0, "log": {2: {5: 0, 6: 0, 7: 0}}},
    # a turn: the pending round's tally as above, then the next round's
    # decision from the counts the tally left (logged in the next row, the
    # round pending again), or, where the loop ends, none (nothing pending)
    "turn_tier_then_tier": {
        L.CN: 64, L.FED: 100, L.FRE: 3, L.OK: 1, L.NA: 12, L.EW: 400, L.ROUNDS: 3,
        L.PUSHES: 112, L.EDGE_PUSHES: 1400, L.WL_ROUNDS: 2, L.EXECS: 2, L.GO: 1,
        L.BRANCH: 1, L.PENDING: 1,
        "log": {2: {5: 12, 6: 400, 7: 0}, 3: [1, 1, 64, 100, 3, 0, 0, 0]}},
    "turn_heavy_scan_then_scan": {
        L.CN: BIG, L.FED: BIG, L.FRE: BIG, L.OK: 0, L.NA: 9, L.EW: 5000, L.ROUNDS: 3,
        L.PUSHES: 109, L.EDGE_PUSHES: 6000, L.SCANS_CAND: 2, L.SCANS_FED: 1,
        L.SCANS_LIV: 1, L.EXECS + 3: 2, L.GO: 1, L.BRANCH: 3, L.HEAVY: 0, L.PENDING: 1,
        "log": {2: {5: 9, 6: 5000, 7: 0}, 3: [3, 0, BIG, BIG, BIG, 0, 0, 0]}},
    "turn_light_scan_stats_then_tier": {
        L.CN: 40, L.FED: 50, L.FRE: 6, L.OK: 1, L.NA: 9, L.EW: 100, L.ROUNDS: 3,
        L.PUSHES: 109, L.EDGE_PUSHES: 1100, L.STATS_READS: 1, L.SCANS_CAND: 2,
        L.SCANS_FED: 1, L.SCANS_LIV: 1, L.EXECS + 3: 2, L.EXECS + 4: 1, L.GO: 1,
        L.BRANCH: 1, L.STATS: 0, L.PENDING: 1,
        "log": {2: {5: 9, 6: 100, 7: 1}, 3: [1, 1, 40, 50, 6, 0, 0, 0]}},
    "turn_reaches_max_rounds": {
        L.CN: 1, L.FED: 1, L.FRE: 1, L.OK: 1, L.NA: 9, L.EW: 10, L.ROUNDS: 6,
        L.PUSHES: 109, L.EDGE_PUSHES: 1010, L.WL_ROUNDS: 2, L.EXECS: 2, L.GO: 0,
        L.PENDING: 0, "log": {5: {5: 9, 6: 10, 7: 0}}},
    "turn_no_active": {
        L.CN: 1, L.FED: 1, L.FRE: 1, L.OK: 1, L.NA: 0, L.EW: 0, L.ROUNDS: 3,
        L.WL_ROUNDS: 2, L.EXECS + 1: 1, L.GO: 0, L.PENDING: 0,
        "log": {2: {5: 0, 6: 0, 7: 0}}},
    "turn_nothing_pending": {L.BRANCH: 0, L.PENDING: 1, "log": {2: [0, 1, 8, 32, 4, 0, 0, 0]}},
    # the sharded rule, written from pprx/dist/wl.py: the loop starts with
    # work 1 (:1023), so the first round runs from an empty valid list; the
    # stats-skip reads ewr (:911-917), and the log its count
    "sharded_prime_empty_list": {L.OK: 1, L.NA: 1, L.GO: 1},
    "sharded_prime_valid_list": {L.CN: 3, L.FED: 9, L.FRE: 2, L.OK: 1, L.NA: 1, L.GO: 1},
    "sharded_prime_no_rounds": {L.OK: 1, L.NA: 1, L.GO: 0},
    "sharded_decide_top_border": {L.BRANCH: 2, "log": {2: [2, 1, 256, 2048, 64, 0, 0, 0]}},
    "sharded_after_scan_light_ewr": {L.HEAVY: 0, L.STATS: 1},
    "sharded_after_scan_heavy_ewr": {L.HEAVY: 1, L.STATS: 0},
    "sharded_after_scan_last_round": {L.HEAVY: 0, L.STATS: 0},
    "sharded_tally_tier_list": {
        L.CN: 65, L.FED: 100, L.FRE: 3, L.OK: 1, L.NA: 12, L.EW: 400, L.ROUNDS: 3,
        L.PUSHES: 112, L.EDGE_PUSHES: 1400, L.WL_ROUNDS: 2, L.EXECS: 2, L.GO: 1,
        "log": {2: {5: 12, 6: 0, 7: 0}}},
    "sharded_tally_heavy_scan": {
        L.CN: BIG, L.FED: BIG, L.FRE: BIG, L.OK: 0, L.NA: 9, L.EW: 5000, L.ROUNDS: 3,
        L.PUSHES: 109, L.EDGE_PUSHES: 6000, L.SCANS_CAND: 2, L.SCANS_FED: 1,
        L.SCANS_LIV: 1, L.EXECS + 3: 2, L.GO: 1, "log": {2: {5: 9, 6: 4300, 7: 0}}},
    # wl2's rule would find the list invalid (65 > 64) and scan next
    "sharded_turn_tier_list_then_tier": {
        L.CN: 65, L.FED: 100, L.FRE: 3, L.OK: 1, L.NA: 12, L.EW: 400, L.ROUNDS: 3,
        L.PUSHES: 112, L.EDGE_PUSHES: 1400, L.WL_ROUNDS: 2, L.EXECS: 2, L.GO: 1,
        L.BRANCH: 2, L.PENDING: 1,
        "log": {2: {5: 12, 6: 0, 7: 0}, 3: [2, 1, 65, 100, 3, 0, 0, 0]}},
    # the dense rule, written from pprx/engine/push.py:94-119: prime reads
    # n0 (the counts' n_active) and runs no round from 0, nor at no rounds;
    # the list's counts stay 0. Each round is the one arm, branch 0; its
    # tally adds its active pairs and edge pushes, and the loop goes on
    # while the round found an active pair and the cap is not reached. The
    # base carry's list counts (cn, fed, fre, ok: 1) stay as they are.
    "dense_prime_converged": {L.NA: 0, L.GO: 0},
    "dense_prime_active": {L.NA: 7, L.GO: 1},
    "dense_prime_no_rounds": {L.NA: 7, L.GO: 0},
    "dense_decide": {L.BRANCH: 0, "log": {2: [0, 1, 1, 1, 1, 0, 0, 0]}},
    "dense_tally_goes_on": {
        L.NA: 9, L.EW: 40, L.ROUNDS: 3, L.PUSHES: 109, L.EDGE_PUSHES: 1040, L.EXECS: 2,
        L.GO: 1, "log": {2: {5: 9, 6: 40, 7: 0}}},
    "dense_tally_empty_round": {
        L.NA: 0, L.EW: 0, L.ROUNDS: 3, L.EXECS: 2, L.GO: 0, "log": {2: {5: 0, 6: 0, 7: 0}}},
    "dense_tally_reaches_max_rounds": {
        L.NA: 9, L.EW: 40, L.ROUNDS: 6, L.PUSHES: 109, L.EDGE_PUSHES: 1040, L.EXECS: 2,
        L.GO: 0, "log": {5: {5: 9, 6: 40, 7: 0}}},
    "dense_turn_round_then_round": {
        L.NA: 9, L.EW: 40, L.ROUNDS: 3, L.PUSHES: 109, L.EDGE_PUSHES: 1040, L.EXECS: 2,
        L.GO: 1, L.BRANCH: 0, L.PENDING: 1,
        "log": {2: {5: 9, 6: 40, 7: 0}, 3: [0, 1, 1, 1, 1, 0, 0, 0]}},
    "dense_turn_reverse_round": {
        L.NA: 12, L.EW: 3, L.ROUNDS: 3, L.PUSHES: 112, L.EDGE_PUSHES: 1003, L.EXECS: 2,
        L.GO: 1, L.BRANCH: 0, L.PENDING: 1,
        "log": {2: {5: 12, 6: 3, 7: 0}, 3: [0, 1, 1, 1, 1, 0, 0, 0]}},
    "dense_turn_empty_round_ends": {
        L.NA: 0, L.EW: 0, L.ROUNDS: 3, L.EXECS: 2, L.GO: 0, L.PENDING: 0,
        "log": {2: {5: 0, 6: 0, 7: 0}}},
    "dense_turn_reaches_max_rounds": {
        L.NA: 9, L.EW: 40, L.ROUNDS: 6, L.PUSHES: 109, L.EDGE_PUSHES: 1040, L.EXECS: 2,
        L.GO: 0, L.PENDING: 0, "log": {5: {5: 9, 6: 40, 7: 0}}},
    "dense_turn_nothing_pending": {L.BRANCH: 0, L.PENDING: 1,
                                   "log": {2: [0, 1, 1, 1, 1, 0, 0, 0]}},
    # the proportional rule, written from pprx/dist/wl.py:1177-1214: the
    # loop starts with work 1 and the corrections' pending carry; a pending
    # carry drains (branch 3), a valid list takes its tier (the top one
    # takes any), an invalid one rescans (4); a round goes on while its
    # count (a drain's: cn2 > 0, :1169) or the pending carry is not zero; a
    # drain keeps ok, a compact round or rescan sets it; every round is a
    # wl round. The log keeps the pending carry each decision read (col 6).
    "prop_prime_valid_list": {L.CN: 3, L.FED: 9, L.FRE: 2, L.OK: 1, L.NA: 1, L.GO: 1},
    "prop_prime_first_round_forced": {L.OK: 1, L.NA: 1, L.GO: 1},
    "prop_prime_carry_pending": {L.CN: 3, L.FED: 9, L.FRE: 2, L.OK: 1, L.PEND: 5, L.NA: 1,
                                 L.GO: 1},
    "prop_prime_no_rounds": {L.NA: 1, L.GO: 0},
    "prop_decide_drain_over_valid_list": {L.BRANCH: 3, "log": {2: [3, 1, 8, 32, 4, 0, 4, 0]}},
    "prop_decide_rescan": {L.BRANCH: 4, "log": {2: [4, 0, 1, 1, 1, 0, 0, 0]}},
    "prop_decide_tier0_border": {L.BRANCH: 0, "log": {2: [0, 1, 8, 32, 4, 0, 0, 0]}},
    "prop_decide_past_the_top_border": {L.BRANCH: 2, "log": {2: [2, 1, 257, 0, 0, 0, 0, 0]}},
    "prop_tally_tier_goes_on": {
        L.CN: 65, L.FED: 100, L.FRE: 3, L.OK: 1, L.NA: 12, L.EW: 400, L.ROUNDS: 3,
        L.PUSHES: 112, L.EDGE_PUSHES: 1400, L.WL_ROUNDS: 2, L.EXECS: 2, L.GO: 1,
        "log": {2: {5: 12, 6: 0, 7: 0}}},
    "prop_tally_tier_leaves_carry": {
        L.CN: 10, L.FED: 20, L.FRE: 2, L.OK: 1, L.NA: 0, L.EW: 0, L.ROUNDS: 3,
        L.WL_ROUNDS: 2, L.EXECS + 1: 1, L.PEND: 3, L.GO: 1, "log": {2: {5: 0, 6: 0, 7: 0}}},
    "prop_tally_drain_goes_on": {
        L.CN: 5, L.FED: 6, L.FRE: 1, L.OK: 1, L.NA: 0, L.EW: 0, L.ROUNDS: 3, L.WL_ROUNDS: 2,
        L.EXECS + 3: 2, L.PEND: 0, L.GO: 1, "log": {2: {5: 0, 6: 2, 7: 0}}},
    "prop_tally_drain_ends_loop": {
        L.CN: 0, L.FED: 0, L.FRE: 0, L.OK: 0, L.NA: 0, L.EW: 0, L.ROUNDS: 3, L.WL_ROUNDS: 2,
        L.EXECS + 3: 2, L.PEND: 0, L.GO: 0, "log": {2: {5: 0, 6: 2, 7: 0}}},
    "prop_tally_rescan": {
        L.CN: 40, L.FED: 50, L.FRE: 6, L.OK: 1, L.NA: 9, L.EW: 100, L.ROUNDS: 3,
        L.PUSHES: 109, L.EDGE_PUSHES: 1100, L.WL_ROUNDS: 2, L.EXECS + 4: 1, L.GO: 1,
        "log": {2: {5: 9, 6: 0, 7: 0}}},
    "prop_tally_reaches_max_rounds": {
        L.CN: 1, L.FED: 1, L.FRE: 1, L.OK: 1, L.NA: 9, L.EW: 10, L.ROUNDS: 6,
        L.PUSHES: 109, L.EDGE_PUSHES: 1010, L.WL_ROUNDS: 2, L.EXECS: 2, L.GO: 0,
        "log": {5: {5: 9, 6: 0, 7: 0}}},
    "prop_turn_tier_then_drain": {
        L.CN: 65, L.FED: 100, L.FRE: 3, L.OK: 1, L.NA: 12, L.EW: 400, L.ROUNDS: 3,
        L.PUSHES: 112, L.EDGE_PUSHES: 1400, L.WL_ROUNDS: 2, L.EXECS: 2, L.PEND: 7, L.GO: 1,
        L.BRANCH: 3, L.PENDING: 1,
        "log": {2: {5: 12, 6: 0, 7: 0}, 3: [3, 1, 65, 100, 3, 0, 7, 0]}},
    "prop_turn_drain_ends": {
        L.CN: 0, L.FED: 0, L.FRE: 0, L.OK: 1, L.NA: 0, L.EW: 0, L.ROUNDS: 3, L.WL_ROUNDS: 2,
        L.EXECS + 3: 2, L.PEND: 0, L.GO: 0, L.PENDING: 0, "log": {2: {5: 0, 6: 2, 7: 0}}},
    "prop_turn_reaches_max_rounds": {
        L.CN: 1, L.FED: 1, L.FRE: 1, L.OK: 1, L.NA: 9, L.EW: 10, L.ROUNDS: 6,
        L.PUSHES: 109, L.EDGE_PUSHES: 1010, L.WL_ROUNDS: 2, L.EXECS: 2, L.GO: 0,
        L.PENDING: 0, "log": {5: {5: 9, 6: 0, 7: 0}}},
    "prop_turn_nothing_pending": {L.BRANCH: 4, L.PENDING: 1,
                                  "log": {2: [4, 0, 1, 1, 1, 0, 0, 0]}},
    # the hybrid rule, written from pprx/engine/sparse.py:457-559 and
    # :153-201: a valid list goes while it has a candidate (:547), else the
    # first count (:550); use_wl is the list's validity and the top tier's
    # fit (:480), the tier a count of misses (:498-504); a scan's arm the
    # smallest scan tier that holds the exact frontier where worth it
    # (:176, :187-200), else dense (arms 3-5, 6); a scan counts the
    # frontier first (arm 7, not a round) where a worklist round left
    # bounds; a tier past its own w pushes cn past wcap (:484); a scan
    # tallies its reasons on the counts that sent it there (:531-533) and
    # leaves the reseed's exact counts, valid where they fit wcap (:539)
    "hybrid_prime_valid_list": {L.CN: 3, L.FED: 9, L.FRE: 2, L.OK: 1, L.NA: 1, L.XN: -1,
                                L.GO: 1},
    "hybrid_prime_empty_list": {L.OK: 1, L.NA: 0, L.XN: -1, L.GO: 0},
    "hybrid_prime_counted": {L.OK: 0, L.XN: 5, L.XF: 70, L.NA: 5, L.GO: 1},
    "hybrid_prime_counted_converged": {L.NA: 0, L.GO: 0},
    "hybrid_prime_list_overflowed": {L.CN: 256, L.FED: 900, L.FRE: 30, L.OK: 0, L.NA: 1,
                                     L.XN: -1, L.GO: 1},
    "hybrid_prime_no_rounds": {L.CN: 3, L.FED: 9, L.FRE: 2, L.OK: 1, L.NA: 1, L.XN: -1,
                               L.GO: 0},
    "hybrid_decide_tier0": {L.BRANCH: 0, "log": {2: [0, 1, 8, 32, 4, 0, -1, 0]}},
    "hybrid_decide_fed_skips_tier1": {L.BRANCH: 2, "log": {2: [2, 1, 9, 600, 0, 0, -1, 0]}},
    "hybrid_decide_count_past_top": {L.BRANCH: 7, "log": {2: [7, 1, 257, 1, 1, 0, -1, 0]}},
    "hybrid_decide_count_invalid_list": {L.BRANCH: 7, "log": {2: [7, 0, 1, 1, 1, 0, -1, 0]}},
    "hybrid_decide_scan_tier0": {L.BRANCH: 3, "log": {2: [3, 0, 1, 1, 1, 0, 8, 32]}},
    "hybrid_decide_scan_tier1": {L.BRANCH: 4, "log": {2: [4, 0, 1, 1, 1, 0, 9, 32]}},
    "hybrid_decide_worth_border": {L.BRANCH: 5, "log": {2: [5, 0, 1, 1, 1, 0, 5, 4900]}},
    "hybrid_decide_not_worth": {L.BRANCH: 6, "log": {2: [6, 0, 1, 1, 1, 0, 5, 4901]}},
    "hybrid_decide_rows_past_top": {L.BRANCH: 6, "log": {2: [6, 0, 1, 1, 1, 0, 1002, 10]}},
    "hybrid_decide_valid_list_over_top_edges": {
        L.BRANCH: 5, "log": {2: [5, 1, 40, 3000, 5, 0, 40, 3000]}},
    "hybrid_decide_past_the_log": {L.BRANCH: 0},
    "hybrid_tally_tier_list": {
        L.CN: 8, L.FED: 100, L.FRE: 3, L.OK: 1, L.NA: 12, L.EW: 400, L.ROUNDS: 3,
        L.PUSHES: 112, L.EDGE_PUSHES: 1400, L.WL_ROUNDS: 2, L.EXECS: 2, L.GO: 1,
        "log": {2: {5: 12}}},
    "hybrid_tally_tier_cut": {
        L.CN: 257, L.FED: 100, L.FRE: 3, L.OK: 0, L.NA: 12, L.EW: 400, L.ROUNDS: 3,
        L.PUSHES: 112, L.EDGE_PUSHES: 1400, L.WL_ROUNDS: 2, L.EXECS: 2, L.GO: 1,
        "log": {2: {5: 12}}},
    "hybrid_tally_top_tier_cut": {
        L.CN: 257, L.FED: 100, L.FRE: 3, L.OK: 0, L.NA: 12, L.EW: 400, L.ROUNDS: 3,
        L.PUSHES: 112, L.EDGE_PUSHES: 1400, L.WL_ROUNDS: 2, L.EXECS + 2: 1, L.GO: 1,
        "log": {2: {5: 12}}},
    "hybrid_tally_sparse_scan": {
        L.CN: 30, L.FED: 200, L.FRE: 5, L.OK: 1, L.XN: 30, L.XF: 200, L.NA: 9, L.EW: 100,
        L.ROUNDS: 3, L.PUSHES: 109, L.EDGE_PUSHES: 1100, L.SCANS_CAND: 2, L.SCANS_FED: 1,
        L.SCANS_LIV: 1, L.EXECS + 4: 1, L.GO: 1, "log": {2: {5: 9}}},
    "hybrid_tally_dense_scan": {
        L.CN: 300, L.FED: 9000, L.FRE: 70, L.OK: 0, L.XN: 300, L.XF: 9000, L.NA: 50,
        L.EW: 800, L.ROUNDS: 3, L.PUSHES: 150, L.EDGE_PUSHES: 1800, L.SCANS_FED: 1,
        L.EXECS + 6: 1, L.GO: 1, "log": {2: {5: 50}}},
    "hybrid_tally_count": {L.XN: 40, L.XF: 50, L.EXECS + 7: 1},
    "hybrid_tally_prime_count": {L.XN: 12, L.XF: 90, L.NA: 12, L.GO: 1, L.EXECS + 7: 1},
    "hybrid_tally_prime_count_converged": {L.XN: 0, L.XF: 0, L.NA: 0, L.GO: 0,
                                           L.EXECS + 7: 1},
    "hybrid_tally_reaches_max_rounds": {
        L.CN: 1, L.FED: 1, L.FRE: 1, L.OK: 1, L.NA: 9, L.EW: 10, L.ROUNDS: 6,
        L.PUSHES: 109, L.EDGE_PUSHES: 1010, L.WL_ROUNDS: 2, L.EXECS: 2, L.GO: 0,
        "log": {5: {5: 9}}},
    "hybrid_tally_no_active": {
        L.CN: 0, L.FED: 0, L.FRE: 0, L.OK: 1, L.XN: 0, L.XF: 0, L.NA: 0, L.EW: 0,
        L.ROUNDS: 3, L.EXECS + 3: 2, L.GO: 0, "log": {2: {5: 0}}},
    "hybrid_turn_tier_then_count": {
        L.CN: 257, L.FED: 100, L.FRE: 3, L.OK: 0, L.NA: 12, L.EW: 400, L.ROUNDS: 3,
        L.PUSHES: 112, L.EDGE_PUSHES: 1400, L.WL_ROUNDS: 2, L.EXECS: 2, L.GO: 1,
        L.BRANCH: 7, L.PENDING: 1,
        "log": {2: {5: 12}, 3: [7, 0, 257, 100, 3, 0, -1, 0]}},
    "hybrid_turn_count_then_scan": {
        L.XN: 40, L.XF: 50, L.EXECS + 7: 1, L.BRANCH: 4, L.PENDING: 1,
        "log": {2: [4, 0, 257, 100, 3, 0, 40, 50]}},
    "hybrid_turn_prime_count_ends": {L.XN: 0, L.XF: 0, L.NA: 0, L.GO: 0, L.EXECS + 7: 1,
                                     L.PENDING: 0},
    "hybrid_turn_scan_then_tier": {
        L.CN: 6, L.FED: 20, L.FRE: 2, L.OK: 1, L.XN: 6, L.XF: 20, L.NA: 9, L.EW: 50,
        L.ROUNDS: 3, L.PUSHES: 109, L.EDGE_PUSHES: 1050, L.SCANS_CAND: 2, L.EXECS + 3: 2,
        L.GO: 1, L.BRANCH: 0, L.PENDING: 1,
        "log": {2: {5: 9}, 3: [0, 1, 6, 20, 2, 0, 6, 20]}},
    "hybrid_turn_nothing_pending": {L.BRANCH: 3, L.PENDING: 1,
                                    "log": {2: [3, 0, 1, 1, 1, 0, 8, 32]}},
    # without a worklist (pprx/engine/sparse.py:562-586): the first count,
    # then scans alone, each leaving the next exact counts; no reasons
    "nowl_prime_counted": {L.OK: 0, L.XN: 5, L.XF: 70, L.NA: 5, L.GO: 1},
    "nowl_decide_sparse": {L.BRANCH: 0, "log": {2: [0, 0, 1, 1, 1, 0, 5, 70]}},
    "nowl_decide_dense": {L.BRANCH: 1, "log": {2: [1, 0, 1, 1, 1, 0, 1002, 70]}},
    "nowl_tally_scan": {
        L.CN: 4, L.FED: 60, L.FRE: 0, L.OK: 0, L.XN: 4, L.XF: 60, L.NA: 9, L.EW: 100,
        L.ROUNDS: 3, L.PUSHES: 109, L.EDGE_PUSHES: 1100, L.EXECS: 2, L.GO: 1,
        "log": {2: {5: 9}}},
    "nowl_turn_scan_then_dense": {
        L.CN: 2000, L.FED: 100, L.FRE: 0, L.OK: 0, L.XN: 2000, L.XF: 100, L.NA: 9, L.EW: 100,
        L.ROUNDS: 3, L.PUSHES: 109, L.EDGE_PUSHES: 1100, L.EXECS: 2, L.GO: 1, L.BRANCH: 1,
        L.PENDING: 1, "log": {2: {5: 9}, 3: [1, 0, 2000, 100, 0, 0, 2000, 100]}},
}

CASES = {case[0]: case for case in chip_smoke.K4_CASES}


def test_the_table_covers_every_case():
    assert set(EXPECTED) == set(CASES)
    assert chip_smoke.K4_TABLE.emit == (64, 256, 256)  # no tier reseeds by rescan
    assert chip_smoke.K4_TABLE.heavy_ew == 4224


@pytest.mark.parametrize("name", list(CASES))
def test_plain_step_on_the_table(name):
    """Each step leaves the carry as the reference's rules say, and returns
    the decision it wrote (a turn: the next round's branch, or the table's
    ``stop`` where the loop ends)."""
    _, step, _, counts = CASES[name]
    carry, counts_t = chip_smoke.k4_case(CASES[name])
    want = carry.clone()
    if step == "prime":
        want[:L.HEAD] = 0
        for slot in PRIME_KEEPS:
            want[slot] = carry[slot]
    exp = dict(EXPECTED[name])
    for rnd, row in exp.pop("log", {}).items():
        cols = row.items() if isinstance(row, dict) else enumerate(row)
        for col, v in cols:
            want[L.HEAD + rnd * L.LOG_W + col] = v
    for slot, v in exp.items():
        want[slot] = v
    # the plain steps take the counts as a tensor or as the host's read
    table = chip_smoke.k4_table(CASES[name])
    for given in (counts_t, list(counts)):
        got = carry.clone()
        out = loop.step_(step, got, given, table)
        assert torch.equal(got, want), (got != want).nonzero().flatten().tolist()
        if step == "turn":
            assert out == (int(want[L.BRANCH]) if want[L.GO] else table.stop)
        else:
            decision = {"prime": L.GO, "decide": L.BRANCH, "after_scan": L.STATS,
                        "tally": L.GO}[step]
            assert int(out) == int(want[decision])


def test_slots_match_the_kernel_source():
    """``csrc/loop.cu``'s enums and constants name the same slots as
    ``loop.py``: K4 and the plain steps read one layout."""
    src = (Path(loop.__file__).resolve().parent.parent / "csrc" / "loop.cu").read_text()
    enums = dict((k, int(v)) for k, v in re.findall(r"\bk(\w+) = (\d+)", src))
    pairs = {"Cn": L.CN, "Fed": L.FED, "Fre": L.FRE, "Ok": L.OK, "Na": L.NA, "Ew": L.EW,
             "Rounds": L.ROUNDS, "MaxRounds": L.MAX_ROUNDS, "C0ok": L.C0OK,
             "Pushes": L.PUSHES, "EdgePushes": L.EDGE_PUSHES, "WlRounds": L.WL_ROUNDS,
             "ScansCand": L.SCANS_CAND, "ScansFed": L.SCANS_FED, "ScansLiv": L.SCANS_LIV,
             "StatsReads": L.STATS_READS, "Branch": L.BRANCH, "Heavy": L.HEAVY,
             "Stats": L.STATS, "Go": L.GO, "Execs": L.EXECS, "Pending": L.PENDING,
             "Pend": L.PEND, "Head": L.HEAD, "Xn": L.XN, "Xf": L.XF,
             "Tiers": L.T_TIERS, "HeavyEw": L.T_HEAVY, "Rule": L.T_RULE, "W": L.T_W}
    assert {k: enums[k] for k in pairs} == pairs
    consts = dict(re.findall(r"constexpr int k(\w+) = (\d+);", src))
    assert {k: int(consts[k]) for k in ("MaxTiers", "LogW", "LogCap", "Ewr")} == {
        "MaxTiers": L.MAX_TIERS, "LogW": L.LOG_W, "LogCap": L.LOG_CAP, "Ewr": L.EWR}
    assert "(1LL << 31) / 2 - 1" in src and BIG == (1 << 31) // 2 - 1
    assert L.EXECS + L.MAX_BRANCHES <= L.PENDING < L.HEAD
    # pprx_loop_step's numbering of the kernels
    assert {k: enums[k] for k in ("Prime", "Turn", "AfterScan")} == {
        "Prime": L.STEPS.index("prime"), "Turn": L.STEPS.index("turn"),
        "AfterScan": L.STEPS.index("after_scan")}
    assert (L.T_E, L.T_G, L.T_EMIT, L.T_F, L.T_SE, L.T_SCANS) == tuple(
        L.T_W + i * L.MAX_TIERS for i in (1, 2, 3, 4, 5, 6))
    assert (L.T_OV, L.T_WIN, L.TAB) == (L.T_SCANS + 1, L.T_SCANS + 2, L.T_SCANS + 3)
    assert ("kF = kEmit + kMaxTiers, kSE = kF + kMaxTiers, kScans = kSE + kMaxTiers, "
            "kOv = kScans + 1,\n  kWin = kOv + 1,\n  kTabLen = kWin + 1,") in src
    # the rules a table names
    assert {k: enums[k] for k in ("Wl2", "Sharded", "Dense", "Proportional", "Hybrid")} == {
        "Wl2": L.WL2, "Sharded": L.SHARDED, "Dense": L.DENSE, "Proportional": L.PROPORTIONAL,
        "Hybrid": L.HYBRID}
    assert L.N_PEND == L.EWR  # the proportional rule's pending carry takes ewr's slot
    # and the hybrid rule's first list's validity
    assert L.C0V == L.EWR and "constexpr int kC0v = kEwr;" in src
    assert "constexpr int kMaxBranches = kMaxTiers + 2;" in src
    assert L.MAX_BRANCHES == L.MAX_TIERS + 2
    assert L.DENSE_TABLE.values()[L.T_RULE] == L.DENSE


@pytest.mark.parametrize("name", [n for n, case in CASES.items()
                                  if case[1] in ("decide", "tally")])
def test_turn_is_tally_then_decide(name):
    """The loop graph runs each ``decide`` and ``tally`` case as a turn
    (``chip_smoke.k4_launch``, as the card holds the kernel to it): with no
    round pending a turn is ``decide``, the round then pending; with one
    pending it is ``tally``, then ``decide`` where the loop goes on, or,
    where it ends, nothing more: no round pending, and the branch past the
    SWITCH's arms."""
    case = CASES[name]
    table = chip_smoke.k4_table(case)
    step, carry, counts = chip_smoke.k4_launch(case)
    assert step == "turn" and int(carry[L.PENDING]) == (case[1] == "tally")
    got = carry.clone()
    arm = loop.step_("turn", got, counts, table)
    want = carry.clone()
    if case[1] == "tally":
        loop.step_("tally", want, counts, table)
    go = bool(want[L.GO])
    want[L.PENDING] = int(go)
    assert arm == (loop.step_("decide", want, counts, table) if go else table.stop)
    assert torch.equal(got, want), (got != want).nonzero().flatten().tolist()


def test_table_refuses_a_ladder_it_cannot_hold():
    with pytest.raises(ValueError, match="tiers"):
        loop.Table(tiers=((1, 1, 1),) * 9, emit=(1,) * 9, heavy_ew=1)
    with pytest.raises(ValueError, match="tiers"):
        loop.Table(tiers=((1, 1, 1),), emit=(), heavy_ew=1)
    with pytest.raises(ValueError, match="carry"):
        loop.step_("decide", torch.zeros(8, dtype=torch.int64), [0] * 5, chip_smoke.K4_TABLE)
    with pytest.raises(ValueError, match="dense rule takes no tiers"):
        loop.Table(tiers=((1, 1, 1),), emit=(1,), heavy_ew=1, rule=loop.DENSE)
    with pytest.raises(ValueError, match="no loop rule"):
        loop.Table(tiers=((1, 1, 1),), emit=(1,), heavy_ew=1, rule=5)
    assert (L.DENSE_TABLE.scan, L.DENSE_TABLE.stop, L.DENSE_TABLE.n_branches) == (0, 1, 1)
    # the proportional rule: the tiers, the drain and the rescan, no stats
    prop = chip_smoke.K4_PROPORTIONAL
    assert (prop.scan, prop.stop, prop.n_branches, prop.has_stats, prop.n_counts) == (
        3, 5, 5, False, 6)
    # the hybrid rule: the worklist tiers, the scan tiers, the dense scan
    # and the count, no stats; a ladder whose arms a loop cannot hold
    hyb, nowl = chip_smoke.K4_HYBRID, chip_smoke.K4_NOWL
    assert (hyb.scan, hyb.dense_arm, hyb.count_arm, hyb.stop, hyb.n_branches,
            hyb.has_stats, hyb.n_counts) == (3, 6, 7, 8, 8, False, 6)
    assert (nowl.dense_arm, nowl.count_arm, nowl.stop, nowl.n_branches) == (1, 2, 3, 3)
    assert loop.hybrid_table(((1, 1, 1),) * 4, ((1, 1),) * 4, 1, 1).n_branches == 10
    with pytest.raises(ValueError, match="need 11 branches: a loop holds 10"):
        loop.hybrid_table(((1, 1, 1),) * 4, ((1, 1),) * 5, 1, 1)
    with pytest.raises(ValueError, match="1 to 8 scan tiers"):
        loop.hybrid_table(((1, 1, 1),), (), 1, 1)
    with pytest.raises(ValueError, match="only the hybrid rule takes scan tiers"):
        loop.Table(tiers=((1, 1, 1),), emit=(1,), heavy_ew=1, scans=((1, 1),))


@pytest.mark.parametrize("c0ok, max_rounds, rounds", [
    (False, 1, 1), (False, 2, 2), (False, 7, 7), (True, 7, 0), (False, 0, 0)])
def test_host_loop_takes_a_turn_a_round_and_one_more(monkeypatch, c0ok, max_rounds, rounds):
    """The host loop walks the loop graph's sequence on the smoke script's
    fill-kernel branches (every round leaves an active pair, so a loop ends
    at its cap): from an invalid list a scan, its stats where a round
    follows, then tier rounds; R rounds take R + 1 turns and ``after_scan``
    once, and a loop that ``prime`` stops (a valid empty list, or no round
    allowed) takes none; a read after each round and each stats run."""
    calls = {"turn": 0, "after_scan": 0}

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    for name in calls:
        monkeypatch.setattr(loop, name, counted(name, getattr(loop, name)))
    g = graphs.RoundGraphs(8, 8, "cpu")
    values, reads = g.loop(None, chip_smoke.fill_branches(g), chip_smoke.FILL_TABLE, c0ok,
                           max_rounds)
    assert values[L.ROUNDS] == rounds and not values[L.PENDING]
    assert calls == {"turn": rounds + 1 if rounds else 0, "after_scan": int(rounds > 0)}
    execs = [rounds - 1, 1, int(rounds > 1)] if rounds else [0, 0, 0]
    assert values[L.EXECS:L.EXECS + 3] == execs
    assert reads == 1 + rounds + execs[2]


@pytest.mark.parametrize("na0, max_rounds, rounds", [
    (1, 1, 1), (1, 5, 5), (0, 5, 0), (1, 0, 0)])
def test_dense_host_loop_turns(monkeypatch, na0, max_rounds, rounds):
    """The dense rule's loop on the host: ``prime`` stops it from a first
    count of 0 or at no rounds; else R rounds of its one arm take R + 1
    turns and no ``after_scan``, a read after the prologue and each round,
    each round's counts tallied, and its log replays (the smoke script's
    ``dense_fill`` branches, which phase 3c runs as loop graphs)."""
    calls = {"turn": 0, "after_scan": 0}

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    for name in calls:
        monkeypatch.setattr(loop, name, counted(name, getattr(loop, name)))
    sink = []
    monkeypatch.setattr(graphs, "LOG_SINK", sink)
    g = graphs.RoundGraphs(8, 1, "cpu")
    first, branches = chip_smoke.dense_fill(g, na0)
    values, reads = g.loop(first, branches, loop.DENSE_TABLE, True, max_rounds)
    assert values[L.ROUNDS] == rounds and not values[L.PENDING]
    assert calls == {"turn": rounds + 1 if rounds else 0, "after_scan": 0}
    assert (values[L.EXECS], values[L.EXECS + 1]) == (rounds, 0)
    assert (values[L.PUSHES], values[L.EDGE_PUSHES], values[L.WL_ROUNDS]) == (rounds, 3 * rounds, 0)
    assert reads == 1 + rounds
    assert sink[0]["rounds"] == rounds and len(sink[0]["rows"]) == rounds
    assert loop.replay_log(sink[0]["rows"], loop.DENSE_TABLE, max_rounds) == [(0, 0)] * rounds


@pytest.mark.parametrize("c0ok, pend0, max_rounds, rounds, execs", [
    (False, 0, 3, 3, [2, 0, 1]), (True, 2, 5, 1, [0, 1, 0]), (True, 0, 4, 4, [4, 0, 0]),
    (True, 0, 0, 0, [0, 0, 0])])
def test_prop_host_loop_turns(monkeypatch, c0ok, pend0, max_rounds, rounds, execs):
    """The proportional rule's loop on the host (the smoke script's
    ``prop_fill`` arms, which phase 3c runs as loop graphs): an invalid list
    rescans, then tiers run to the cap; a pending carry drains first (here
    a drain that ends the loop); ``prime`` stops none but at no rounds. R
    rounds take R + 1 turns and no ``after_scan``, a read after the
    prologue and each round, every round a wl round, and the log
    replays."""
    calls = {"turn": 0, "after_scan": 0}

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    for name in calls:
        monkeypatch.setattr(loop, name, counted(name, getattr(loop, name)))
    sink = []
    monkeypatch.setattr(graphs, "LOG_SINK", sink)
    g = graphs.RoundGraphs(8, 8, "cpu", n_counts=loop.N_COUNTS)
    table = chip_smoke.PROP_FILL_TABLE
    first, branches = chip_smoke.prop_fill(g, pend0)
    values, reads = g.loop(first, branches, table, c0ok, max_rounds)
    assert values[L.ROUNDS] == rounds == values[L.WL_ROUNDS] and not values[L.PENDING]
    assert calls == {"turn": rounds + 1 if rounds else 0, "after_scan": 0}
    assert values[L.EXECS:L.EXECS + 3] == execs
    assert reads == 1 + rounds
    rows = sink[0]["rows"]
    assert [row[6] for row in rows[:1]] == [pend0] * min(rounds, 1)
    assert loop.replay_log(rows, table, max_rounds) == [(row[0], 0) for row in rows]


@pytest.mark.parametrize("case", chip_smoke.HYBRID_FILL_LOOPS)
def test_hybrid_host_loop_turns(monkeypatch, case):
    """The hybrid rule's loop on the host (the smoke script's
    ``hybrid_fill`` arms, which phase 3c runs as loop graphs): a valid list
    takes its tier; a tier that cut its list is followed by a count, then
    a scan; the state's first count starts with a scan, and stops the loop
    where it is 0; a list that overflowed is counted first, and that count
    stands for the prime. R rounds and C counts take R + C + 1 turns and no
    ``after_scan``, a read after the prologue and each arm; the scans tally
    their reasons, and the log replays."""
    (c0ok, c0v, first, count, max_rounds), execs = case
    calls = {"turn": 0, "after_scan": 0}

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    for name in calls:
        monkeypatch.setattr(loop, name, counted(name, getattr(loop, name)))
    sink = []
    monkeypatch.setattr(graphs, "LOG_SINK", sink)
    g = graphs.RoundGraphs(8, 8, "cpu", n_counts=loop.N_COUNTS)
    table = chip_smoke.HYBRID_FILL_TABLE
    pro, arms = chip_smoke.hybrid_fill(g, c0v, first, count)
    values, reads = g.loop(pro, arms, table, c0ok, max_rounds)
    rounds, counts = values[L.ROUNDS], values[L.EXECS + table.count_arm]
    assert values[L.EXECS:L.EXECS + 4] == execs and not values[L.PENDING]
    assert rounds == execs[0] + execs[1] + execs[2] and values[L.WL_ROUNDS] == execs[0]
    assert calls == {"turn": rounds + counts + 1 if rounds + counts else 0, "after_scan": 0}
    assert reads == 1 + rounds + counts
    # every scan followed a list that was not valid (none, or a cut one)
    assert values[L.SCANS_CAND] == execs[1]
    rows = sink[0]["rows"]
    assert len(rows) == rounds
    assert loop.replay_log(rows, table, max_rounds) == loop.logged(rows, table)


def test_hybrid_replay_finds_a_wrong_branch():
    """A hybrid log row whose arm its counts do not give is not replayed
    as made: the scan tier its exact frontier fits, or the count where it
    is not known."""
    table = chip_smoke.K4_HYBRID
    rows = [[3, 0, 1, 1, 1, 9, 40, 50], [3, 0, 1, 1, 1, 9, -1, 0], [0, 1, 8, 32, 4, 9, -1, 0]]
    assert loop.replay_log(rows, table, 6) == [(4, 0), (7, 0), (0, 0)]
    assert loop.logged(rows, table) == [(3, 0), (3, 0), (0, 0)]


CFG = PprConfig(alpha=0.2, eps=1e-8, max_rounds=10_000)
SCFG = StreamConfig(window=250, slide=25)
QUERIES = [0, 6, 17]
N = 35
TALLIES = ("rounds", "wl_rounds", "scans_cand", "scans_fed", "scans_liv")


@pytest.mark.parametrize("mode", [FORWARD, REVERSE])
def test_host_loop_matches_jax_and_its_log_replays(monkeypatch, mode):
    """The port's host loop on the plain steps against the JAX driver: a
    seed, 10 slides (three rebuilds), a refine and a refine cut at 6
    rounds, f64; every loop's rounds, wl rounds and scans by reason equal,
    p/r at 1e-12 at the end; each loop's log holds its rounds, its branches
    count its compact rounds, and it replays through the plain ``decide``
    and ``after_scan``."""
    src, dst, _ = synthetic_powerlaw_stream(N, 500, seed=11)
    kw = dict(mode=mode, rebuild_every=3, e_top=64, n_tiers=3)
    a = JaxDriver(src, dst, N, QUERIES, CFG, SCFG, dtype=jnp.float64, segsum=False, **kw)
    b = FastStreamDriver(src, dst, N, QUERIES, CFG, SCFG, dtype=torch.float64, device="cpu",
                         **kw)
    sink = []
    monkeypatch.setattr(graphs, "LOG_SINK", sink)
    ja = [a.seed(), *a.run(10), a.refine(1e-10), a.refine(1e-11, rounds=6)]
    tb = [b.seed(), *b.run(10), b.refine(1e-10), b.refine(1e-11, rounds=6)]
    for sa, sb in zip(ja, tb, strict=True):
        assert tuple(getattr(sb, k) for k in TALLIES) == tuple(
            int(getattr(sa, k)) for k in TALLIES)
        assert sb.syncs == sb.rounds + 1 + sb.stats_reads
    assert tb[-1].rounds == 6
    assert sum(st.rounds - st.wl_rounds for st in tb) > 0 and sum(st.wl_rounds for st in tb) > 0
    np.testing.assert_allclose(b.state.p.numpy(), np.asarray(a.state.p), rtol=0, atol=1e-12)
    np.testing.assert_allclose(b.state.r.numpy(), np.asarray(a.state.r), rtol=0, atol=1e-12)
    assert len(sink) == len(tb)
    for rec, st in zip(sink, tb):
        rows = rec["rows"]
        assert len(rows) == st.rounds
        assert sum(row[0] < len(b.tiers) for row in rows) == st.wl_rounds
        assert sum(row[7] for row in rows) == st.stats_reads
        assert loop.replay_log(rows, rec["table"], rec["max_rounds"]) == [
            (row[0], row[7]) for row in rows]


def test_replay_finds_a_wrong_branch():
    """A log whose branch the counts do not give is not replayed as made."""
    rows = [[1, 1, 8, 32, 4, 3, 40, 0]]  # tier-0 counts logged as tier 1
    assert loop.replay_log(rows, chip_smoke.K4_TABLE, 6) == [(0, 0)]
    assert loop.log_rows([0] * loop.ROUNDS + [1] + [0] * (loop.SIZE - loop.ROUNDS - 1)) == [
        [0] * loop.LOG_W]

"""The convergence loops' carry and their control steps (K4's plain
version): the wl2 engine's and, in a world of one shard, the sharded wl
engine's compact-frontier loops, the dense loop of the dense engine and
of the sharded dense engine in a world of one shard, that world's
memory-proportional loop (``wlp``), and the hybrid engine's two loops.

The reference runs a whole convergence loop on the device: a
``lax.while_loop`` whose body picks a capacity tier with ``lax.switch`` and
worklist or scan with ``lax.cond``, and skips a heavy scan's stats with
another ``lax.cond`` (``pprx/engine/wl2.py:574-687``; the sharded engine's
``pprx/dist/wl.py:954-1025``). The port keeps what those decisions read and
write in one small int64 tensor, the *carry*, and writes each decision as a
step on it:

- ``prime``: the loop's start, from the first list's exact counts;
- ``turn``: the last round's ``tally``, where one is pending (its
  statistics, the next round's counts and whether the loop goes on), then,
  where the loop goes on, the next round's ``decide``: its branch, a
  compact tier (its index is the number of lower tiers whose capacities
  the counts miss) or the scan;
- ``after_scan``: whether a scan's next-frontier stats run (the port's
  stats-skip: not for a heavy scan, nor where no round follows).

A loop of R rounds takes R + 1 turns (none where ``prime`` stops it).

A table's ``rule`` picks one of five loops. The two compact-frontier
loops differ in two rules (``pprx/dist/wl.py:1023``, ``:911-917``):

- the sharded loop's first round always runs (the reference starts its
  work at 1), where wl2's runs none from a valid empty list;
- its scan skips the stats when ``ewr`` is heavy: the window and fresh
  edges of every row with an active pair (the counts' sixth slot), where
  wl2 weighs a row by its active pairs (``ew``, the fifth).

The dense rule is the dense engine's loop (``pprx/engine/push.py:94-119``;
the sharded dense engine's at ``pprx/dist/sharded.py:378-398``, where in a
world of one shard under ``dense_rs`` nothing is ever pending):
no tiers, one arm (the dense round, branch 0) and no stats. ``prime``
reads the first active count (the counts' ``n_active``, the reference's
``n0``) and runs no round from a converged state; a turn tallies the
pending round (its rounds, pushes and edge pushes) and goes on while that
round found an active pair and the cap is not reached, as the reference's
``cond`` reads the last round's count. Its loops call no ``after_scan``
(the loop graph holds none; the host loop and ``replay_log`` skip it), so
that step has no dense case.

The proportional rule is the sharded engine's memory-proportional loop
(``wlp``, ``pprx/dist/wl.py:1177-1214``): its SWITCH has the ``k`` compact
tiers ``0 .. k-1``, the drain ``k`` and the rescan ``k + 1``, and no
stats. A pending carry (the counts' sixth slot, ``N_PEND``, kept in the
carry's ``PEND``) takes the drain; otherwise a valid list takes the tier
that counts the lower tiers the counts miss (the top tier covers any
frontier), and an invalid one the rescan. A round's tally goes on while
its own count (its active pairs; a drain's: whether it left a list) or a
pending carry is not zero, and the cap is not reached; a drain keeps the
list's validity, a compact round or a rescan makes it valid. Its first
round always runs, and every round counts as a wl round, as the
reference's ``stats[3]``.

The hybrid rule is the hybrid engine's loops (``pprx/engine/sparse.py:
457-559``, ``:153-201``, ``:562-586``). Its SWITCH has the ``k`` worklist
tiers ``0 .. k-1``, the ``ks`` sparse scan arms ``k .. k+ks-1`` (the scan
tiers, ``Table.scans``), the dense scan ``k + ks`` (``dense_arm``) and an
arm that counts the frontier and pushes nothing (``count_arm``); no stats.
A valid list whose counts fit the top tier takes its tier, as wl2's. Any
other round is a scan, whose arm needs the exact frontier's rows and
snapshot edges: ``XN`` and ``XF``, which take the stats-skip's slots (the
rule has no stats), ``XN`` -1 where they are not known. A scan's reseed
leaves them, and so does a prologue that counted the state; after a
worklist round they are not known, and the count arm runs first (not a
round: its tally counts its execution alone). The scan's arm is then the
smallest scan tier that holds them, where the reference's ``worth`` holds
(``(XF + overlay capacity) * 2 <= window capacity``), and the dense scan
otherwise. A worklist tier's list is valid where it marked at most its own
``w`` rows (else ``cn`` goes past the top tier's ``w``), a scan's where
its exact count fits the top tier. A scan's tally counts its reasons on
the counts that sent it to a scan (the count arm leaves them): the
reference's ``not ok or cn > wcap``, ``fed > ecap`` and ``liv > ovacap``.
``prime`` reads the list's counts and its validity on the device (the
counts' sixth slot, ``C0V``): a valid list goes while it has a candidate;
without one (``C0OK`` 0) the prologue counted the state, and the loop goes
while that count is not 0; a list the caller passed that is not valid (it
overflowed its buffer) goes to a count first, whose tally then stands for
the prime's (no round has run and the list is not valid) and ends the
loop where it counts no row. With no worklist tier (``push_to_convergence_
hybrid``) every round is a scan and the reasons are not counted.

The compact-frontier loops keep the port's test that the stats run only
where a round follows.
The sharded reference has none, and needs none: the stats read ``r`` and
write only the next list and its counts, and where no round follows
(``n_active`` 0, or the round cap) nothing reads those. So ``p``, ``r``
and the rounds are the reference's.

On CUDA ``prime``, ``turn`` and ``after_scan`` are the one-warp kernels of
``pprx_torch/csrc/loop.cu`` (K4) inside one conditional CUDA graph per loop
(``pprx_torch.engine.graphs.RoundGraphs.loop``), where each also sets the
graph's branch and loop conditions. On the CPU the host loops of
``pprx_torch.engine.wl2``, ``pprx_torch.dist.wl``,
``pprx_torch.engine.push`` and ``pprx_torch.engine.sparse`` call the plain
steps below, which nothing on CUDA calls; ``step_`` runs one step on a
carry where it lies, the kernel on a card or the plain step on the CPU. Both write the same carry. ``decide``
and ``tally`` have no kernel of their own: they are ``turn``'s parts, and
``replay_log``'s.

Branches are numbered: the ``k`` tiers ``0 .. k-1``, the scan ``k`` and its
stats ``k + 1`` (under the proportional rule the drain ``k`` and the
rescan ``k + 1``; under the hybrid rule as above). The carry also counts
each branch's executions (what a loop graph's kernels launched follows
from them) and logs each round's branch with the counts its decisions
read, so that a run on the card can be replayed through ``decide``
(``replay_log``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import time

import torch

from pprx_torch import _ext

# ---- the carry's slots (int64; csrc/loop.cu's enum Slot holds the same)
CN, FED, FRE, OK, NA, EW = range(6)  # the counts the next decision reads
ROUNDS, MAX_ROUNDS, C0OK = 6, 7, 8  # MAX_ROUNDS and C0OK: set before a loop
PUSHES, EDGE_PUSHES, WL_ROUNDS, SCANS_CAND, SCANS_FED, SCANS_LIV, STATS_READS = range(9, 16)
BRANCH, HEAVY, STATS, GO = 16, 17, 18, 19  # the round's decisions
EXECS = 20  # executions of each branch, MAX_BRANCHES slots
PENDING = 30  # a round decided and not yet tallied
PEND = 31  # the proportional rule's pending carry, which the next decision reads
HEAD = 32  # the slots above; the round log follows
# the hybrid rule's exact frontier rows and snapshot edges (XN -1: not
# known), in the stats-skip's slots, which it has no use for
XN, XF = HEAVY, STATS

MAX_TIERS = 8
MAX_BRANCHES = MAX_TIERS + 2
# a round: branch, ok, cn, fed, fre (what decide read), na, the heavy test's
# count (ew; ewr under the sharded rule; under the proportional rule the
# pending carry decide read), stats (under the hybrid rule the XN and XF
# that decide read)
LOG_W = 8
LOG_CAP = 1024  # rounds logged; later rounds are not
SIZE = HEAD + LOG_CAP * LOG_W

# ---- the round's counts: cn, fed, fre, n_active, edge_work, and the
# sharded rule's heavy count ewr, whose slot the proportional rule's
# pending carry takes, and the hybrid rule's first list's validity
N_COUNTS = 6
EWR = 5
N_PEND = C0V = EWR

# ---- the table of a tier ladder (int64; csrc/loop.cu's enum Tab)
T_TIERS, T_HEAVY, T_RULE, T_W = 0, 1, 2, 3
# the rules a table's T_RULE names (the module docstring)
WL2, SHARDED, DENSE, PROPORTIONAL, HYBRID = 0, 1, 2, 3, 4
T_E, T_G, T_EMIT = T_W + MAX_TIERS, T_W + 2 * MAX_TIERS, T_W + 3 * MAX_TIERS
# the hybrid rule's scan tiers (rows, snapshot edges), their number, and
# the overlay's and the window's capacities
T_F, T_SE = T_W + 4 * MAX_TIERS, T_W + 5 * MAX_TIERS
T_SCANS, T_OV, T_WIN = T_W + 6 * MAX_TIERS, T_W + 6 * MAX_TIERS + 1, T_W + 6 * MAX_TIERS + 2
TAB = T_WIN + 1

BIG = 2**31 // 2 - 1  # the reference's "skip" sentinel (int32 max // 2)

# K4's kernels, as ``pprx_loop_step`` numbers them
STEPS = ("prime", "turn", "after_scan")
# K4's launches since the last reset, by step (as ``segsum.LAUNCHES``); a
# loop graph's are counted from its carry when it is read
LAUNCHES = {step: 0 for step in STEPS}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def launches(entry: str | None = None, since: dict | None = None) -> int:
    """Launches counted since the last reset, or since ``since`` (an earlier
    ``dict(LAUNCHES)``): of one step or of all."""
    return sum(count - (since[key] if since else 0)
               for key, count in LAUNCHES.items() if entry in (None, key))


@dataclasses.dataclass(frozen=True)
class Table:
    """What the decisions know of a loop besides its carry: the tier ladder
    ``tiers`` ((w, e, g), smallest first), the list width each tier's round
    emits (``emit``: its next tier's, or ``n + 1`` where the round reseeds
    by a rescan), ``heavy_ew``, the edge work above which a scan skips
    its stats, and ``rule``: ``WL2``, ``SHARDED`` (the sharded engine's),
    ``DENSE`` (the dense engine's: no tiers; ``DENSE_TABLE``),
    ``PROPORTIONAL`` (the sharded engine's memory-proportional loop: no
    stats, the emit widths and ``heavy_ew`` unread) or ``HYBRID`` (the
    hybrid engine's: ``tiers`` its worklist ladder, none without a
    worklist, each tier emitting its own ``w``; ``scans`` its scan tiers
    (rows, snapshot edges), smallest first; ``overlay`` and ``window`` the
    capacities its ``worth`` test reads; ``heavy_ew`` unread), as the
    module docstring says."""

    tiers: tuple[tuple[int, int, int], ...]
    emit: tuple[int, ...]
    heavy_ew: int
    rule: int = WL2
    scans: tuple[tuple[int, int], ...] = ()
    overlay: int = 0
    window: int = 0

    def __post_init__(self):
        if self.rule == DENSE:
            if self.tiers or self.emit:
                raise ValueError(f"the dense rule takes no tiers: {self.tiers}")
        elif self.rule == HYBRID:
            if (len(self.tiers) > MAX_TIERS or len(self.emit) != len(self.tiers)
                    or not 1 <= len(self.scans) <= MAX_TIERS):
                raise ValueError(f"the hybrid rule takes 0 to {MAX_TIERS} worklist tiers, each "
                                 f"with its emit width, and 1 to {MAX_TIERS} scan tiers: "
                                 f"{self.tiers}, {self.emit}, {self.scans}")
            if self.n_branches > MAX_BRANCHES:
                raise ValueError(
                    f"the hybrid rule's {len(self.tiers)} worklist tiers and {len(self.scans)} "
                    f"scan tiers, with its dense and count arms, need {self.n_branches} "
                    f"branches: a loop holds {MAX_BRANCHES}")
        elif self.rule not in (WL2, SHARDED, PROPORTIONAL):
            raise ValueError(f"no loop rule {self.rule}")
        elif not 1 <= len(self.tiers) <= MAX_TIERS or len(self.emit) != len(self.tiers):
            raise ValueError(f"a loop takes 1 to {MAX_TIERS} tiers, each with its emit width: "
                             f"{self.tiers}, {self.emit}")
        if self.scans and self.rule != HYBRID:
            raise ValueError("only the hybrid rule takes scan tiers")

    @property
    def sharded(self) -> bool:
        return self.rule == SHARDED

    @property
    def dense(self) -> bool:
        return self.rule == DENSE

    @property
    def proportional(self) -> bool:
        return self.rule == PROPORTIONAL

    @property
    def hybrid(self) -> bool:
        return self.rule == HYBRID

    @property
    def has_stats(self) -> bool:
        """Whether the scan's arm runs ``after_scan`` and the stats: the
        compact-frontier rules'."""
        return self.rule in (WL2, SHARDED)

    @property
    def scan(self) -> int:
        """The scan's branch (under the dense rule the round's, 0; under
        the proportional rule the drain's, the rescan's is ``scan + 1``;
        under the hybrid rule the first sparse scan's); its stats' is
        ``scan + 1``."""
        return len(self.tiers)

    @property
    def dense_arm(self) -> int:
        """The hybrid rule's dense scan."""
        return len(self.tiers) + len(self.scans)

    @property
    def count_arm(self) -> int:
        """The hybrid rule's count of the frontier, which pushes nothing."""
        return self.dense_arm + 1

    @property
    def stop(self) -> int:
        """The branch ``turn`` gives where the loop ends: past the
        SWITCH's arms (the tiers and the scan; the tiers, the drain and
        the rescan; the hybrid rule's tiers, scans and count), so that it
        runs none."""
        if self.hybrid:
            return self.count_arm + 1
        return self.scan + 1 + self.proportional

    @property
    def n_branches(self) -> int:
        """The branches a loop takes: the SWITCH's arms, and the scan's
        stats where ``has_stats``."""
        return self.stop + self.has_stats

    @property
    def heavy_at(self) -> int:
        """The counts' slot the heavy test reads."""
        return EWR if self.sharded else 4

    @property
    def n_counts(self) -> int:
        """The counts a step reads."""
        return N_PEND + 1 if self.proportional or self.hybrid else self.heavy_at + 1

    def values(self) -> list[int]:
        """The table as K4 reads it: ``TAB`` int64 values."""
        out = [0] * TAB
        out[T_TIERS], out[T_HEAVY], out[T_RULE] = len(self.tiers), self.heavy_ew, self.rule
        for i, ((w, e, g), emit) in enumerate(zip(self.tiers, self.emit)):
            out[T_W + i], out[T_E + i], out[T_G + i], out[T_EMIT + i] = w, e, g, emit
        for i, (f, e) in enumerate(self.scans):
            out[T_F + i], out[T_SE + i] = f, e
        out[T_SCANS], out[T_OV], out[T_WIN] = len(self.scans), self.overlay, self.window
        return out


def hybrid_table(tiers: tuple[tuple[int, int, int], ...], scans: tuple[tuple[int, int], ...],
                 overlay: int, window: int) -> Table:
    """The hybrid rule's table: the worklist ladder ``tiers`` (none for the
    loop without a worklist), each tier emitting its own ``w``, and the scan
    tiers ``scans``; ``overlay`` and ``window`` the capacities of the
    ``worth`` test."""
    return Table(tiers=tuple(tiers), emit=tuple(w for w, _, _ in tiers), heavy_ew=0,
                 rule=HYBRID, scans=tuple(scans), overlay=overlay, window=window)


# the dense engine's loop: one arm, the dense round
DENSE_TABLE = Table(tiers=(), emit=(), heavy_ew=0, rule=DENSE)


def new_carry(device: torch.device | str) -> torch.Tensor:
    return torch.zeros(SIZE, dtype=torch.int64, device=device)


def set_inputs(carry: torch.Tensor, c0ok: bool, max_rounds: int) -> None:
    """What a loop takes from its caller, on a CPU carry: whether the first
    list is valid, and the most rounds it runs."""
    carry[MAX_ROUNDS], carry[C0OK] = int(max_rounds), int(bool(c0ok))


# ---- the plain steps, on a list of the carry's head (``c``) and the
# round's counts (cn, fed, fre, na, ew[, ewr]): what each K4 kernel computes

def _prime(c: list[int], counts, t: Table) -> None:
    max_rounds, c0ok = c[MAX_ROUNDS], c[C0OK]
    c[:] = [0] * HEAD
    c[MAX_ROUNDS], c[C0OK] = max_rounds, c0ok
    if t.dense:
        # the first active count: no round from a converged state
        c[NA] = counts[3]
    elif t.hybrid:
        # the list's counts, and its validity on the device
        c[CN], c[FED], c[FRE] = counts[0], counts[1], counts[2]
        c[OK] = int(c0ok != 0 and counts[C0V] != 0)
        if c[OK]:
            c[NA], c[XN] = int(c[CN] > 0), -1
        elif c0ok == 0:
            # no list: the prologue counted the state, the first scan's counts
            c[XN], c[XF] = counts[3], counts[4]
            c[NA] = counts[3]
        else:
            # a list that overflowed its buffer: a count first, which
            # stands for the prime's
            c[NA], c[XN] = 1, -1
    elif t.proportional:
        # the first round runs whatever the list; a carry left by the
        # corrections is pending
        c[CN], c[FED], c[FRE] = counts[0], counts[1], counts[2]
        c[OK] = int(c0ok != 0)
        c[PEND] = counts[N_PEND]
        c[NA] = 1
    else:
        c[CN], c[FED], c[FRE] = counts[0], counts[1], counts[2]
        c[OK] = int(c0ok != 0)
        # zero candidates in a valid list means zero active rows (candidates
        # are a frontier superset); otherwise force one scan round. The
        # sharded rule runs the first round whatever the list.
        c[NA] = int(c[CN] > 0) if c[OK] and not t.sharded else 1
    c[GO] = int(c[NA] > 0 and 0 < max_rounds)


def _decide_hybrid(c: list[int], t: Table) -> int:
    cn, fed, fre = c[CN], c[FED], c[FRE]
    k = len(t.tiers)
    if k and c[OK] and cn <= t.tiers[-1][0] and fed <= t.tiers[-1][1] and fre <= t.tiers[-1][2]:
        return sum(not (cn <= w and fed <= e and fre <= g) for (w, e, g) in t.tiers[:-1])
    if c[XN] < 0:
        return t.count_arm  # a scan needs the exact frontier: count it first
    xn, xf = c[XN], c[XF]
    # the reference's worth test, then the smallest scan tier that holds
    # the frontier
    worth = (xf + t.overlay) * 2 <= t.window
    i = sum(not (xn <= f and xf <= e) for (f, e) in t.scans)
    return k + i if worth and i < len(t.scans) else t.dense_arm


def _decide(c: list[int], t: Table) -> int:
    cn, fed, fre = c[CN], c[FED], c[FRE]
    if t.hybrid:
        c[BRANCH] = b = _decide_hybrid(c, t)
        return b
    if t.dense:
        b = 0  # the round, the one arm
    elif t.proportional:
        # a pending carry drains; a valid list takes its tier (the top one
        # covers any frontier); else the rescan
        if c[PEND] > 0:
            b = t.scan
        elif c[OK]:
            b = sum(not (cn <= w and fed <= e and fre <= g) for (w, e, g) in t.tiers[:-1])
        else:
            b = t.scan + 1
    elif c[OK] and cn <= t.tiers[-1][0] and fed <= t.tiers[-1][1] and fre <= t.tiers[-1][2]:
        b = sum(not (cn <= w and fed <= e and fre <= g) for (w, e, g) in t.tiers[:-1])
    else:
        b = t.scan
    c[BRANCH], c[HEAVY], c[STATS] = b, 0, 0
    return b


def _after_scan(c: list[int], counts, t: Table) -> bool:
    stats = False
    if c[BRANCH] == t.scan:
        na = counts[3]
        heavy = counts[t.heavy_at] > t.heavy_ew
        # the stats only where a round follows and may use them
        stats = not heavy and na > 0 and c[ROUNDS] + 1 < c[MAX_ROUNDS]
        c[HEAVY] = int(heavy)
    c[STATS] = int(stats)
    return stats


def _tally_hybrid(c: list[int], counts, t: Table) -> bool:
    b = c[BRANCH]
    k = len(t.tiers)
    c[EXECS + b] += 1
    if b == t.count_arm:
        # not a round: the exact frontier for the scan that follows; before
        # any round from a list that is not valid, the prime's count
        c[XN], c[XF] = counts[3], counts[4]
        if c[ROUNDS] == 0 and not c[OK]:
            c[NA] = counts[3]
            c[GO] = int(c[NA] > 0)
        return bool(c[GO])
    na, ew = counts[3], counts[4]
    w_top = t.tiers[-1][0] if k else 0
    if b < k:
        # a tier that marked more rows than its own w cut its list
        cn2 = counts[0] if counts[0] <= t.emit[b] else w_top + 1
        c[CN], c[FED], c[FRE] = cn2, counts[1], counts[2]
        c[OK] = int(cn2 <= w_top)
        c[XN] = -1
        c[WL_ROUNDS] += 1
    else:
        if k:
            # the reasons, on the counts that sent the round to a scan
            _, e_top, g_top = t.tiers[-1]
            c[SCANS_CAND] += int(not c[OK] or c[CN] > w_top)
            c[SCANS_FED] += int(c[FED] > e_top)
            c[SCANS_LIV] += int(c[FRE] > g_top)
        # the reseed's exact counts
        c[CN], c[FED], c[FRE] = counts[0], counts[1], counts[2]
        c[OK] = int(k > 0 and c[CN] <= w_top)
        c[XN], c[XF] = c[CN], c[FED]
    c[ROUNDS] += 1
    c[PUSHES] += na
    c[EDGE_PUSHES] += ew
    c[NA], c[EW] = na, ew
    c[GO] = int(na > 0 and c[ROUNDS] < c[MAX_ROUNDS])
    return bool(c[GO])


def _tally(c: list[int], counts, t: Table) -> bool:
    b = c[BRANCH]
    na, ew = counts[3], counts[4]
    if t.hybrid:
        return _tally_hybrid(c, counts, t)
    if t.proportional:
        # a drain pushes nothing: its count is whether it left a list, and
        # it keeps the list's validity
        drain = b == t.scan
        pend = counts[N_PEND]
        work = (counts[0] > 0 if drain else na) + (pend > 0)
        c[ROUNDS] += 1
        c[PUSHES] += na
        c[EDGE_PUSHES] += ew
        c[WL_ROUNDS] += 1
        c[EXECS + b] += 1
        c[CN], c[FED], c[FRE], c[NA], c[EW] = counts[0], counts[1], counts[2], na, ew
        c[OK] = c[OK] if drain else 1
        c[PEND] = pend
        c[GO] = int(work > 0 and c[ROUNDS] < c[MAX_ROUNDS])
        return bool(c[GO])
    if t.dense:
        cn2, fed2, fre2, ok2 = c[CN], c[FED], c[FRE], c[OK]
    elif b < t.scan:
        cn2, fed2, fre2 = counts[0], counts[1], counts[2]
        ok2 = int(cn2 <= t.emit[b])
    else:
        if c[STATS]:
            cn2, fed2, fre2 = counts[0], counts[1], counts[2]
            c[STATS_READS] += 1
        else:
            cn2 = fed2 = fre2 = 0
        ok2 = 1
        if c[HEAVY]:
            # stats-skip: the successor round is another scan
            cn2 = fed2 = fre2 = BIG
            ok2 = 0
        _, e_top, g_top = t.tiers[-1]
        c[SCANS_CAND] += int(not c[OK])
        c[SCANS_FED] += int(c[FED] > e_top)
        c[SCANS_LIV] += int(c[FRE] > g_top)
    c[ROUNDS] += 1
    c[PUSHES] += na
    c[EDGE_PUSHES] += ew
    c[WL_ROUNDS] += int(b < t.scan)
    c[EXECS + b] += 1
    c[EXECS + t.scan + 1] += c[STATS]
    c[CN], c[FED], c[FRE], c[OK], c[NA], c[EW] = cn2, fed2, fre2, ok2, na, ew
    c[GO] = int(na > 0 and c[ROUNDS] < c[MAX_ROUNDS])
    return bool(c[GO])


def _log_at(carry: torch.Tensor, rnd: int, at: int, values: list[int]) -> None:
    if rnd < LOG_CAP:
        o = HEAD + rnd * LOG_W + at
        carry[o:o + len(values)] = torch.tensor(values, dtype=torch.int64)


def _ints(counts) -> list[int]:
    return counts.tolist() if isinstance(counts, torch.Tensor) else [int(x) for x in counts]


def _on_head(carry: torch.Tensor, fn, *args):
    c = carry[:HEAD].tolist()
    out = fn(c, *args)
    carry[:HEAD] = torch.tensor(c, dtype=torch.int64)
    return out


def prime(carry: torch.Tensor, counts, table: Table) -> bool:
    """Start a loop from the first list's exact counts (cn, fed, fre):
    every slot but the inputs cleared; returns whether a round runs."""
    _on_head(carry, _prime, _ints(counts), table)
    return bool(carry[GO])


def decide(carry: torch.Tensor, table: Table) -> int:
    """The round's branch (``BRANCH``), logged with the counts it read."""
    ok, cn, fed, fre, pend, xn, xf = (int(carry[i]) for i in (OK, CN, FED, FRE, PEND, XN, XF))
    b = _on_head(carry, _decide, table)
    last = [xn, xf] if table.hybrid else [pend if table.proportional else 0, 0]
    _log_at(carry, int(carry[ROUNDS]), 0, [b, ok, cn, fed, fre, 0, *last])
    return b


def after_scan(carry: torch.Tensor, counts, table: Table) -> bool:
    """Whether the round's stats run (``STATS``): after a light scan that
    another round follows. The loop runs it in scan rounds alone (after a
    tier's round it writes what ``decide`` wrote)."""
    return _on_head(carry, _after_scan, _ints(counts), table)


def tally(carry: torch.Tensor, counts, table: Table) -> bool:
    """The round's statistics and the next round's counts from the round's
    (with a scan's stats where they ran); returns whether the loop goes
    on (``GO``)."""
    counts = _ints(counts)
    rnd = int(carry[ROUNDS])
    if table.hybrid:
        # a count is not a round: the next decision writes the row; a
        # round's row keeps the XN and XF its decision read
        counted = int(carry[BRANCH]) == table.count_arm
        go = _on_head(carry, _tally, counts, table)
        if not counted:
            _log_at(carry, rnd, 5, [counts[3]])
        return go
    # the proportional rule's log keeps the pending carry its decision read
    heavy = int(carry[PEND]) if table.proportional else counts[table.heavy_at]
    go = _on_head(carry, _tally, counts, table)
    _log_at(carry, rnd, 5, [counts[3], heavy, int(carry[STATS])])
    return go


def turn(carry: torch.Tensor, counts, table: Table) -> int:
    """The loop body's first step: ``tally`` of the round pending, if one
    is (``PENDING``), then, if the loop goes on (``GO``), ``decide`` of the
    next; returns that round's branch, or ``table.stop`` where the loop
    ends."""
    if carry[PENDING]:
        tally(carry, counts, table)
    go = bool(carry[GO])
    carry[PENDING] = int(go)
    return decide(carry, table) if go else table.stop


PLAIN = {"prime": prime, "decide": decide, "after_scan": after_scan, "tally": tally,
         "turn": turn}


# ---- K4 on the card

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built ``loop`` library, its entries typed."""
    lib = _ext.load("loop")
    # which, carry, counts, table (host int64[TAB]), stream
    lib.pprx_loop_step.argtypes = [_INT, _PTR, _PTR, _PTR, _PTR]
    # prologue, branches, n_branches, carry, counts, table, ring, tags, out
    lib.pprx_loop_build.argtypes = [_PTR, _PTR, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR]
    lib.pprx_loop_launch.argtypes = [_PTR, _PTR]
    lib.pprx_loop_free.argtypes = [_PTR]
    lib.pprx_loop_versions.argtypes = [_PTR]
    # ring (or a pinned host slot), tag, stream
    lib.pprx_stamp.argtypes = [_PTR, ctypes.c_longlong, _PTR]
    lib.pprx_stamp_host.argtypes = [_PTR, ctypes.c_longlong, _PTR]
    for fn in (lib.pprx_loop_step, lib.pprx_loop_build, lib.pprx_loop_launch,
               lib.pprx_loop_free, lib.pprx_loop_versions, lib.pprx_stamp,
               lib.pprx_stamp_host):
        fn.restype = _INT
    return lib


def _table_arg(table: Table):
    return (ctypes.c_longlong * TAB)(*table.values())


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError {err}")


def versions() -> dict:
    """The CUDA driver's and the runtime's versions the loop library sees
    (e.g. 12090 for 12.9): a loop graph's SWITCH node needs 12.8 of both."""
    out = (ctypes.c_int * 2)()
    _check(_lib().pprx_loop_versions(out), "cudaDriverGetVersion")
    return {"driver": out[0], "runtime": out[1]}


def _check_operands(carry: torch.Tensor, counts, table: Table) -> None:
    if carry.dtype != torch.int64 or carry.shape != (SIZE,) or not carry.is_contiguous():
        raise ValueError(f"a carry is int64 [{SIZE}], contiguous")
    n = table.n_counts
    if isinstance(counts, torch.Tensor) and (
            counts.dtype != torch.int64 or counts.numel() < n or counts.device != carry.device
            or not counts.is_contiguous()):
        raise ValueError(f"counts are int64 [{n}] on the carry's device, contiguous")


def step_(name: str, carry: torch.Tensor, counts, table: Table):
    """One step on ``carry`` where it lies: on a card the K4 kernel (one of
    ``STEPS``, with no graph around it: it writes the carry and sets no
    condition), on the CPU the plain step (any of ``PLAIN``), which returns
    the decision."""
    _check_operands(carry, counts, table)
    if carry.device.type == "cpu":
        args = (carry, table) if name == "decide" else (carry, counts, table)
        return PLAIN[name](*args)
    if name not in STEPS:
        raise ValueError(f"K4 has no kernel {name!r}: its kernels are {STEPS}")
    if not isinstance(counts, torch.Tensor):
        raise ValueError("K4 reads its counts from a tensor on the card")
    with torch.cuda.device(carry.device):
        err = _lib().pprx_loop_step(STEPS.index(name), carry.data_ptr(), counts.data_ptr(),
                                    _table_arg(table),
                                    torch.cuda.current_stream(carry.device).cuda_stream)
    _check(err, f"K4 {name} launch")
    LAUNCHES[name] += 1
    return None


def stamp_(ring: torch.Tensor, tag: int, stream: int | None = None) -> int:
    """One stamp of the card's clock with ``tag`` into ``ring`` (``loop.cu``'s
    ``stamp``: int64 ``[2 + 2 * slots]`` on the card) on ``stream`` (a
    handle; ``None``: the current stream); inside a capture, a kernel node
    of the graph. Returns the host's ``perf_counter_ns`` just before the
    launch: the stamp cannot precede it."""
    if stream is None:
        stream = torch.cuda.current_stream(ring.device).cuda_stream
    lib, ptr = _lib(), ring.data_ptr()
    now = time.perf_counter_ns()
    _check(lib.pprx_stamp(ptr, int(tag), stream), "a stamp's launch")
    return now


def stamp_host_(slot: torch.Tensor, tag: int, stream: int) -> None:
    """One stamp of the card's clock with ``tag`` into ``slot``, two int64 of
    pinned host memory, on ``stream``: readable on the host once an event
    recorded after it has fired."""
    if slot.device.type != "cpu" or not slot.is_pinned() or slot.numel() < 2:
        raise ValueError("a host stamp's slot is two int64 of pinned host memory")
    _check(_lib().pprx_stamp_host(slot.data_ptr(), int(tag), stream), "a host stamp's launch")


class LoopGraph:
    """One convergence loop as an instantiated CUDA graph (``loop.cu``'s
    ``pprx_loop_build``): ``[prologue] -> prime -> WHILE { turn -> SWITCH
    { tier_0 | .. | tier_k-1 | scan -> after_scan -> IF { stats } } }``,
    or under the dense rule ``WHILE { turn -> SWITCH { round } }``, under
    the proportional rule ``WHILE { turn -> SWITCH { tier_0 | .. |
    tier_k-1 | drain | rescan } }``, under the hybrid rule ``WHILE { turn
    -> SWITCH { tier_0 | .. | tier_k-1 | scan_0 | .. | scan_ks-1 | dense |
    count } }``, each arm a clone of the branch's captured graph.
    ``prologue`` and ``branches`` are raw ``cudaGraph_t`` handles (torch's
    ``CUDAGraph(keep_graph=True).raw_cuda_graph()``); the graph reads the
    carry, the counts and the table's values baked in at build. ``ring``
    (a ring of stamps, ``stamp_``'s) gets a stamp of ``tags[0]`` before the
    prologue and one of ``tags[1]`` after the WHILE."""

    def __init__(self, prologue: int | None, branches: list[int], carry: torch.Tensor,
                 counts: torch.Tensor, table: Table, ring: torch.Tensor, tags: tuple[int, int]):
        if len(branches) != table.n_branches:
            raise ValueError(f"{len(branches)} branch graphs for a loop of {table.n_branches}")
        _check_operands(carry, counts, table)
        lib = _lib()
        arr = (ctypes.c_void_p * len(branches))(*branches)
        out = ctypes.c_void_p()
        _check(lib.pprx_loop_build(prologue, arr, len(branches), carry.data_ptr(),
                                   counts.data_ptr(), _table_arg(table), ring.data_ptr(),
                                   (ctypes.c_longlong * 2)(*tags), ctypes.byref(out)),
               "building the loop graph")
        self._handle = out.value
        self._free = lib.pprx_loop_free

    def launch(self, stream: int) -> None:
        _check(_lib().pprx_loop_launch(self._handle, stream), "cudaGraphLaunch of a loop")

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            try:
                self._free(handle)
            except Exception:
                pass  # at interpreter exit the library may be gone


def log_rows(values: list[int]) -> list[list[int]]:
    """The logged rounds of a carry read whole (``SIZE`` values)."""
    n = min(values[ROUNDS], LOG_CAP)
    return [values[HEAD + i * LOG_W: HEAD + (i + 1) * LOG_W] for i in range(n)]


def logged(rows: list[list[int]], table: Table) -> list[tuple[int, int]]:
    """Each logged round's (branch, stats) as the loop made them: what
    ``replay_log`` gives where the plain steps decide alike (a rule
    without stats logs other counts in the stats' column)."""
    return [(row[0], row[7] if table.has_stats else 0) for row in rows]


def replay_log(rows: list[list[int]], table: Table, max_rounds: int) -> list[tuple[int, int]]:
    """Each logged round's (branch, stats) as the plain ``decide`` and
    ``after_scan`` choose them from the counts the round logged: equal to
    ``logged(rows, table)`` where the device decided alike."""
    out = []
    for rnd, (_, ok, cn, fed, fre, na, heavy, last) in enumerate(rows):
        c = [0] * HEAD
        c[OK], c[CN], c[FED], c[FRE], c[ROUNDS], c[MAX_ROUNDS] = ok, cn, fed, fre, rnd, max_rounds
        # the proportional rule logs the pending carry its decision read,
        # the hybrid rule the exact frontier's counts
        c[PEND] = heavy if table.proportional else 0
        if table.hybrid:
            c[XN], c[XF] = heavy, last
        b = _decide(c, table)
        counts = [0, 0, 0, na, 0, 0]
        counts[table.heavy_at] = heavy
        # the dense and proportional rules have no stats arm: their loops
        # call no after_scan
        out.append((b, int(_after_scan(c, counts, table)) if table.has_stats else 0))
    return out

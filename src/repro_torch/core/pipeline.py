"""Pipeline schedule compiler: a pure-Python copy of ``SCHEDULES``,
``Timetable`` and ``compile_timetable`` from ``repro/core/pipeline.py``.

The serve plane uses the forward-only ``"decode"`` timetable: micro-batch
slots are request lanes, and stage s acts on lane m at slot s + m of each
round.  The training schedules compile here too, so the port's timetables
equal the reference's for every schedule; the slot executor that runs them
on devices waits for the pipeline slice.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

SCHEDULES = ("gpipe", "1f1b", "interleaved", "zerobubble", "decode")
WIRE_CODECS = ("none", "int8")

# Timetable roles: every (stage, slot) cell does exactly one of these.
ROLE_IDLE, ROLE_F, ROLE_B, ROLE_W = 0, 1, 2, 3
ROLE_NAMES = ("idle", "F", "B", "W")

_NEVER = 1 << 30


class ScheduleError(ValueError):
    """A (schedule, P, M, V) combination the compiler rejects."""


@dataclasses.dataclass(frozen=True, eq=False)
class Timetable:
    """Compiled slot program for one pipeline schedule.

    All per-slot tables are (P, K) int32, indexed [stage, slot].  ``role``
    says what the stage does that slot; ``micro``/``vstage`` which
    (microbatch, local chunk) the unit works on (0 when idle).  The ring
    plan: ``z_arrive[d, t]`` is the forward-ring slot an arriving wire code
    is written to at slot t (-1: no arrival); ``z_src[d, t]`` the ring slot
    this slot's unit reads its input code from.  ``g_arrive``/``g_src``
    are the same for the backward (cotangent) ring — for ``zerobubble`` a
    cotangent stays live from its B until its W consumes it.

    ``f_slot``/``b_slot``/``w_slot`` are the raw (C, M) slot maps (w_slot
    is -1 outside zerobubble) kept for tests and accounting.
    """
    schedule: str
    n_stages: int
    n_virtual: int
    n_micro: int
    n_slots: int
    role: np.ndarray
    micro: np.ndarray
    vstage: np.ndarray
    z_ring: int
    g_ring: int
    z_arrive: np.ndarray
    z_src: np.ndarray
    g_arrive: np.ndarray
    g_src: np.ndarray
    f_slot: np.ndarray
    b_slot: np.ndarray
    w_slot: np.ndarray

    @property
    def n_chunks(self) -> int:
        return self.n_stages * self.n_virtual

    def work_units(self) -> int:
        return int((self.role != ROLE_IDLE).sum())

    def bubble_fraction(self) -> float:
        """Measured idle fraction of the executed timetable (not a closed
        form): 1 - work cells / (P * K)."""
        return 1.0 - self.work_units() / (self.n_stages * self.n_slots)


def _interleaved_slots(Pn: int, M: int, V: int):
    """Megatron-order virtual-stage schedule: per device, M//P groups of P
    microbatches walk the V chunks (forward: shallow->deep, backward:
    deep->shallow) with a depth-staggered warmup of (V-1)*P + (P-d)
    forwards, then strict B/F alternation; units dispatch in list order as
    soon as their producer's hand-off (one-slot transit) has arrived.
    Hits the ideal K = 2(VM + P - 1), i.e. bubble (P-1)/(VM+P-1)."""
    C = Pn * V
    orders = []
    for d in range(Pn):
        fseq = [("F", v * Pn + d, g * Pn + i)
                for g in range(M // Pn) for v in range(V) for i in range(Pn)]
        bseq = [("B", v * Pn + d, g * Pn + i)
                for g in range(M // Pn) for v in reversed(range(V))
                for i in range(Pn)]
        warm = min((V - 1) * Pn + (Pn - d), len(fseq))
        order = list(fseq[:warm])
        fi, bi = warm, 0
        while fi < len(fseq) or bi < len(bseq):
            if bi < len(bseq):
                order.append(bseq[bi])
                bi += 1
            if fi < len(fseq):
                order.append(fseq[fi])
                fi += 1
        orders.append(order)

    f: dict = {}
    b: dict = {}
    ptr = [0] * Pn
    t = 0
    while any(ptr[d] < len(orders[d]) for d in range(Pn)):
        for d in range(Pn):
            if ptr[d] >= len(orders[d]):
                continue
            kind, c, m = orders[d][ptr[d]]
            if kind == "F":
                ready = c == 0 or f.get((c - 1, m), _NEVER) + 1 <= t
            elif c == C - 1:
                ready = f.get((c, m), _NEVER) + 1 <= t
            else:
                ready = ((c, m) in f
                         and b.get((c + 1, m), _NEVER) + 1 <= t)
            if ready:
                (f if kind == "F" else b)[(c, m)] = t
                ptr[d] += 1
        t += 1
        if t > 4 * (V * M + Pn) + 8:
            raise ScheduleError(
                f"interleaved dispatch deadlocked at P={Pn} M={M} V={V}")
    return f, b, max(b.values()) + 1


def _slot_maps(schedule: str, Pn: int, M: int, V: int):
    """(f, b, w) slot dicts keyed (chunk, micro) plus loop length K."""
    f: dict = {}
    b: dict = {}
    w: dict = {}
    if schedule == "gpipe":
        Kf = M + Pn - 1
        for s in range(Pn):
            for m in range(M):
                f[(s, m)] = s + m
                b[(s, m)] = Kf + (Pn - 1 - s) + m
        K = 2 * Kf
    elif schedule == "decode":
        # Forward-only token round: micro-batch slots are request lanes,
        # each lane advances one token per round.  Lane m enters stage s
        # at slot s + m; there is no backward/weight pass, so the round
        # closes after the last lane drains the last stage.
        for s in range(Pn):
            for m in range(M):
                f[(s, m)] = s + m
        K = M + Pn - 1
    elif schedule in ("1f1b", "zerobubble"):
        for s in range(Pn):
            for m in range(M):
                f[(s, m)] = s + m if m < Pn - s else 2 * m + s
                b[(s, m)] = 2 * Pn - 1 - s + 2 * m
        K = 2 * (M + Pn - 1)
        if schedule == "zerobubble":
            # W(s, m) fills the first idle slot after its own B(s, m) —
            # in-order per stage, so the cotangent ring frees FIFO
            for s in range(Pn):
                used = ({f[(s, m)] for m in range(M)}
                        | {b[(s, m)] for m in range(M)})
                t = 0
                for m in range(M):
                    t = max(t, b[(s, m)] + 1)
                    while t in used:
                        t += 1
                    w[(s, m)] = t
                    used.add(t)
            K = max(K, max(w.values()) + 1)
    else:
        f, b, K = _interleaved_slots(Pn, M, V)
    return f, b, w, K


def _greedy_ring(entries: dict):
    """First-free interval allocation: {key: (arrive, last_use)} ->
    ({key: ring_slot}, capacity).  A ring slot frees the slot after its
    entry's last consumer."""
    free_at: list = []
    assign: dict = {}
    for key, (arrive, last) in sorted(entries.items(),
                                      key=lambda kv: (kv[1][0], kv[0])):
        for i, fa in enumerate(free_at):
            if fa <= arrive:
                assign[key] = i
                free_at[i] = last + 1
                break
        else:
            assign[key] = len(free_at)
            free_at.append(last + 1)
    return assign, max(1, len(free_at))


def _check_timetable(tt: "Timetable"):
    """Self-check: one unit per cell, F < B < W per (chunk, micro) with
    one-slot transit between neighbours, every send matched by a receive,
    and ring lifetimes within the declared capacities."""
    Pn, V, M, K = tt.n_stages, tt.n_virtual, tt.n_micro, tt.n_slots
    C = Pn * V
    # forward-only timetables (the decode schedule) have no B/W cells:
    # skip the backward-ordering/transit checks and expect zero B/W roles
    fwd_only = bool((tt.b_slot < 0).all())
    for c in range(C):
        d = c % Pn
        for m in range(M):
            fs, bs = int(tt.f_slot[c, m]), int(tt.b_slot[c, m])
            if fwd_only:
                if not 0 <= fs < K:
                    raise ScheduleError(
                        f"F slot out of range: chunk {c} micro {m}")
            elif not 0 <= fs < bs < K:
                raise ScheduleError(f"F/B order broken: chunk {c} micro {m}")
            if c > 0 and fs < int(tt.f_slot[c - 1, m]) + 1:
                raise ScheduleError(f"F transit broken: chunk {c} micro {m}")
            if not fwd_only and c < C - 1 \
                    and bs < int(tt.b_slot[c + 1, m]) + 1:
                raise ScheduleError(f"B transit broken: chunk {c} micro {m}")
            ws = int(tt.w_slot[c, m])
            if ws >= 0 and not bs < ws < K:
                raise ScheduleError(f"W order broken: chunk {c} micro {m}")
            if c > 0:
                # the code sent at f(c-1, m) must be received into the ring
                # one slot later on this chunk's device
                if int(tt.z_arrive[d, int(tt.f_slot[c - 1, m]) + 1]) < 0:
                    raise ScheduleError(
                        f"unmatched F send: chunk {c - 1} micro {m}")
            if not fwd_only and c < C - 1:
                if int(tt.g_arrive[d, int(tt.b_slot[c + 1, m]) + 1]) < 0:
                    raise ScheduleError(
                        f"unmatched B send: chunk {c + 1} micro {m}")
    counts = [(tt.role == r).sum() for r in (ROLE_F, ROLE_B, ROLE_W)]
    expect_b = 0 if fwd_only else C * M
    expect_w = C * M if (tt.w_slot >= 0).any() else 0
    if counts[0] != C * M or counts[1] != expect_b or counts[2] != expect_w:
        raise ScheduleError(f"role counts off: {counts}")
    if (tt.z_arrive >= tt.z_ring).any() or (tt.z_src >= tt.z_ring).any():
        raise ScheduleError("z ring index out of capacity")
    if (tt.g_arrive >= tt.g_ring).any() or (tt.g_src >= tt.g_ring).any():
        raise ScheduleError("g ring index out of capacity")


@functools.lru_cache(maxsize=None)
def compile_timetable(schedule: str, n_stages: int, n_micro: int,
                      n_virtual: int = 1) -> Timetable:
    """Compile + validate the slot program for one schedule point."""
    if schedule not in SCHEDULES:
        raise ScheduleError(
            f"unknown schedule {schedule!r}; registry: {SCHEDULES}")
    Pn, M, V = int(n_stages), int(n_micro), int(n_virtual)
    if Pn < 1 or M < 1:
        raise ScheduleError(f"need n_stages, n_micro >= 1: {Pn}, {M}")
    if schedule == "interleaved":
        if V < 2:
            raise ScheduleError(
                "interleaved needs virtual_stages >= 2 (V=1 is exactly "
                "1f1b; use that)")
        if Pn < 2:
            raise ScheduleError("interleaved needs n_stages >= 2")
        if M % Pn != 0:
            raise ScheduleError(
                f"interleaved walks microbatches in groups of P: need "
                f"n_microbatches % n_stages == 0, got {M} % {Pn}")
    elif V != 1:
        raise ScheduleError(
            f"{schedule} runs one chunk per device (virtual_stages=1)")

    C = Pn * V
    f, b, w, K = _slot_maps(schedule, Pn, M, V)

    role = np.zeros((Pn, K), np.int32)
    micro = np.zeros((Pn, K), np.int32)
    vstage = np.zeros((Pn, K), np.int32)
    for tbl, r in ((f, ROLE_F), (b, ROLE_B), (w, ROLE_W)):
        for (c, m), t in tbl.items():
            d = c % Pn
            if role[d, t] != ROLE_IDLE:
                raise ScheduleError(
                    f"slot conflict: stage {d} slot {t} "
                    f"({ROLE_NAMES[role[d, t]]} vs {ROLE_NAMES[r]})")
            role[d, t] = r
            micro[d, t] = m
            vstage[d, t] = c // Pn

    # ring plans: a stashed input code lives arrival -> last recompute
    # (W if the schedule splits backward, else B); a cotangent lives
    # arrival -> its consumer (B, and W for zerobubble)
    def last_use(c, m):
        if w:
            return w[(c, m)]
        if b:
            return b[(c, m)]
        return f[(c, m)]       # forward-only: consumed at its own F slot

    z_assign: dict = {}
    g_assign: dict = {}
    z_cap = g_cap = 1
    for d in range(Pn):
        z_entries = {(c, m): (f[(c - 1, m)] + 1, last_use(c, m))
                     for c in range(C) for m in range(M)
                     if c % Pn == d and c > 0}
        g_entries = {(c, m): (b[(c + 1, m)] + 1, last_use(c, m))
                     for c in range(C) for m in range(M)
                     if c % Pn == d and c < C - 1} if b else {}
        za, zc = _greedy_ring(z_entries)
        ga, gc = _greedy_ring(g_entries)
        z_assign.update(za)
        g_assign.update(ga)
        z_cap, g_cap = max(z_cap, zc), max(g_cap, gc)

    z_arrive = np.full((Pn, K), -1, np.int32)
    z_src = np.zeros((Pn, K), np.int32)
    g_arrive = np.full((Pn, K), -1, np.int32)
    g_src = np.zeros((Pn, K), np.int32)
    for (c, m), ring_i in z_assign.items():
        d = c % Pn
        z_arrive[d, f[(c - 1, m)] + 1] = ring_i
        z_src[d, f[(c, m)]] = ring_i
        if b:
            z_src[d, b[(c, m)]] = ring_i
        if w:
            z_src[d, w[(c, m)]] = ring_i
    for (c, m), ring_i in g_assign.items():
        d = c % Pn
        g_arrive[d, b[(c + 1, m)] + 1] = ring_i
        g_src[d, b[(c, m)]] = ring_i
        if w:
            g_src[d, w[(c, m)]] = ring_i

    def slot_arr(tbl):
        out = np.full((C, M), -1, np.int32)
        for (c, m), t in tbl.items():
            out[c, m] = t
        return out

    tt = Timetable(
        schedule=schedule, n_stages=Pn, n_virtual=V, n_micro=M, n_slots=K,
        role=role, micro=micro, vstage=vstage,
        z_ring=z_cap, g_ring=g_cap,
        z_arrive=z_arrive, z_src=z_src, g_arrive=g_arrive, g_src=g_src,
        f_slot=slot_arr(f), b_slot=slot_arr(b), w_slot=slot_arr(w))
    _check_timetable(tt)
    return tt


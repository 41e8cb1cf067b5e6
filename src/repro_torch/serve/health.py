"""Fleet health for grid serving: heartbeats, failover policy, faults.

Counterpart of ``repro.serve.health`` (pure Python; the port keeps its
own copy).  The reference's grid serving path runs one program per host
group and one k-wide candidate exchange per query; this module is its
health layer:

* :class:`FleetMonitor` — per-group liveness built on the training
  elasticity primitives in ``repro_torch.train.elastic`` (one
  vocabulary for fleet state across train and serve): its snapshot
  type is ``elastic.FleetView`` and its latency flagger is
  ``elastic.StragglerMonitor`` keyed by group id.  Tracks per-group
  heartbeats, consecutive exchange failures (``strike``), and
  permanently demotes a group after ``max_strikes``.
* :class:`FaultPlan` / :class:`Fault` — the serve-time injection
  harness: kill a group before dispatch or after compute
  (mid-exchange), or delay its candidate fetch, at one round or from a
  round onward.  Faults surface as :class:`GroupFailure`.
* :class:`CrashPlan` — the mutation-time counterpart: a SIGKILL at a
  named durability point of ``serve.mutation``.

The grid exchange (``serve.retrieval._topk_search_grid``) threads a
``FaultPlan`` and a ``FleetMonitor`` through its rounds: a group's fetch
is timed from its dispatch until its candidate block has arrived on the
root device, so a straggler's deadline sees the real arrival.  Timing
is injected (``clock=``, ``sleep=``) so every policy is unit-testable
with a fake clock, as ``train/elastic.py``'s are.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from collections import defaultdict

from repro_torch.train.elastic import FleetView, StragglerMonitor

__all__ = ["CrashPlan", "FleetMonitor", "FaultPlan", "Fault",
           "GroupFailure", "DegradedCoverage"]


class GroupFailure(RuntimeError):
    """A host group failed to answer an exchange round (transport
    error, injected kill, or deadline overrun)."""


class DegradedCoverage(RuntimeError):
    """Raised by grid serving under ``--on-group-loss fail`` when a
    result would cover less than the full stored index
    (``serve.retrieval.RetrievalServer(on_group_loss="fail")``)."""


# -- fault injection -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected fault against ``group``.

    ``kind`` is one of:
      * ``"kill_before"`` — group unreachable at dispatch (host down).
      * ``"kill_after"``  — group computes, then dies mid-exchange
        (candidates never arrive).
      * ``"delay"``       — group answers ``delay`` seconds late (a
        straggler; with an exchange deadline this becomes a timeout).

    ``round`` fires the fault at exactly that exchange round,
    ``from_round`` from that round onward; both ``None`` means every
    round (a permanently dead/slow group).
    """

    group: int
    kind: str
    round: int | None = None
    from_round: int | None = None
    delay: float = 0.0

    def __post_init__(self):
        if self.kind not in ("kill_before", "kill_after", "delay"):
            raise ValueError(f"unknown fault kind {self.kind!r}")

    def active(self, round_i: int) -> bool:
        if self.round is not None and round_i != self.round:
            return False
        if self.from_round is not None and round_i < self.from_round:
            return False
        return True


def kill_group(group: int, *, round: int | None = None,
               from_round: int | None = None,
               when: str = "before") -> Fault:
    """A kill fault; ``when`` is ``"before"`` (at dispatch) or
    ``"after"`` (mid-exchange, post-compute)."""
    if when not in ("before", "after"):
        raise ValueError(f"when={when!r} not in ('before', 'after')")
    return Fault(group=group, kind=f"kill_{when}", round=round,
                 from_round=from_round)


def delay_group(group: int, seconds: float, *, round: int | None = None,
                from_round: int | None = None) -> Fault:
    """A straggler fault: the group's candidate fetch sleeps
    ``seconds`` before answering."""
    return Fault(group=group, kind="delay", round=round,
                 from_round=from_round, delay=float(seconds))


@dataclasses.dataclass(frozen=True)
class CrashPlan:
    """SIGKILL the calling process the moment the mutation path reaches
    the named durability point (``serve.mutation.CRASH_POINTS``
    enumerates them: after the WAL intent fsync, after each atomic
    artifact rename, after the commit record, ...).

    SIGKILL, not an exception: no ``finally`` blocks, no ``atexit``, no
    buffered-write flush runs — what a power loss or an OOM kill leaves
    behind.  The crash harness runs the mutation in a spawned child
    process with one plan per point and checks that
    ``index_io.recover()`` lands on a bitwise-valid epoch with zero
    orphaned files."""

    kill_at: str

    def check(self, point: str) -> None:
        """Called by the mutation path as it passes ``point``."""
        if point == self.kill_at:
            os.kill(os.getpid(), signal.SIGKILL)


class FaultPlan:
    """A scripted schedule of :class:`Fault`\\ s, threaded through the
    grid exchange (``serve.retrieval.topk_search(..., faults=...)``).
    The exchange calls
    ``begin_round()`` once per query and ``check(group, stage)`` at
    each dispatch (``stage="dispatch"``) and candidate fetch
    (``stage="exchange"``); matching kills raise
    :class:`GroupFailure`, matching delays sleep."""

    def __init__(self, faults=(), *, sleep=time.sleep):
        self.faults = tuple(faults)
        self._sleep = sleep
        self._round = -1

    @property
    def round(self) -> int:
        return self._round

    def begin_round(self) -> int:
        self._round += 1
        return self._round

    def check(self, group: int, stage: str):
        if stage not in ("dispatch", "exchange"):
            raise ValueError(f"stage={stage!r}")
        for f in self.faults:
            if f.group != group or not f.active(self._round):
                continue
            if f.kind == "kill_before" and stage == "dispatch":
                raise GroupFailure(
                    f"injected: group {group} down at dispatch "
                    f"(round {self._round})")
            if f.kind == "kill_after" and stage == "exchange":
                raise GroupFailure(
                    f"injected: group {group} died mid-exchange "
                    f"(round {self._round})")
            if f.kind == "delay" and stage == "exchange":
                self._sleep(f.delay)


# -- fleet monitor -------------------------------------------------------


class FleetMonitor:
    """Liveness + failover policy for ``n_groups`` host groups.

    A group is **live** when it is not demoted and (if
    ``heartbeat_timeout`` is set) its last heartbeat is fresh.  The
    exchange only dispatches live groups; a failed exchange is a
    ``strike``, ``max_strikes`` consecutive strikes demote the group
    permanently.  A successful exchange heartbeats the group, clears
    its strikes, and feeds its latency to the shared
    ``StragglerMonitor`` (slow groups surface via ``stragglers()``
    before they ever time out).

    ``exchange_timeout`` (seconds, ``None`` = no deadline) bounds each
    candidate fetch; ``backoff(attempt)`` is the pause before failover
    attempt ``attempt`` (exponential, capped at ``backoff_max``).

    **Thread safety.**  The concurrent serving loop dispatches group
    programs from a worker pool, so strikes and heartbeats arrive from
    multiple threads at once.  All monitor state (``_beat``,
    ``_strikes``, ``_demoted``) is mutated under ONE reentrant monitor
    lock — a heartbeat racing a strike can otherwise lose a demotion
    (``_strikes[g] += 1`` is read-modify-write) or resurrect a demoted
    group.  The ordering law is **strike-then-check**: ``strike()``
    increments and compares against ``max_strikes`` inside one locked
    region, so the thread that lands the fatal strike is the one (and
    the only one) told the group just crossed the threshold; demotion
    is permanent, so a concurrent ``record_exchange`` that slips in
    *before* the fatal strike merely resets the count (a genuinely
    successful exchange), never undoes a demotion — ``heartbeat`` and
    strike-clearing are no-ops on demoted groups.
    """

    def __init__(self, n_groups: int, *,
                 heartbeat_timeout: float | None = None,
                 exchange_timeout: float | None = None,
                 retries: int = 1,
                 max_strikes: int = 3,
                 backoff_base: float = 0.05,
                 backoff_max: float = 2.0,
                 straggler_threshold: float = 1.5,
                 straggler_window: int = 8,
                 straggler_patience: int = 3,
                 clock=time.monotonic):
        if n_groups < 1:
            raise ValueError(f"n_groups={n_groups} < 1")
        if retries < 0:
            raise ValueError(f"retries={retries} < 0")
        if max_strikes < 1:
            raise ValueError(f"max_strikes={max_strikes} < 1")
        self.n_groups = n_groups
        self.heartbeat_timeout = heartbeat_timeout
        self.exchange_timeout = exchange_timeout
        self.retries = retries
        self.max_strikes = max_strikes
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.clock = clock
        # ONE lock for all monitor state; reentrant because
        # record_exchange -> heartbeat nests, and strike -> demote.
        self._lock = threading.RLock()
        # Groups start live: construction is the first heartbeat.
        self._beat = {g: clock() for g in range(n_groups)}
        self._strikes: dict[int, int] = defaultdict(int)
        self._demoted: set[int] = set()
        self.latency = StragglerMonitor(threshold=straggler_threshold,
                                        window=straggler_window,
                                        patience=straggler_patience)

    # -- liveness --------------------------------------------------------

    def heartbeat(self, group: int):
        self._check_group(group)
        with self._lock:
            if group in self._demoted:
                return          # demotion is permanent: no resurrection
            self._beat[group] = self.clock()

    def is_live(self, group: int) -> bool:
        self._check_group(group)
        with self._lock:
            if group in self._demoted:
                return False
            if self.heartbeat_timeout is None:
                return True
            return self.clock() - self._beat[group] <= self.heartbeat_timeout

    def live(self) -> frozenset:
        """Groups the exchange may dispatch right now."""
        with self._lock:
            return frozenset(g for g in range(self.n_groups)
                             if self.is_live(g))

    @property
    def demoted(self) -> frozenset:
        with self._lock:
            return frozenset(self._demoted)

    def fleet(self) -> FleetView:
        """The fleet snapshot in the training-side vocabulary: one
        'device' per host group, demoted/stale groups failed."""
        live = self.live()
        return FleetView(
            n_devices=self.n_groups,
            failed=frozenset(g for g in range(self.n_groups)
                             if g not in live))

    # -- failure accounting ----------------------------------------------

    def strike(self, group: int) -> bool:
        """Record one failed exchange; returns True when the group just
        crossed ``max_strikes`` and is now permanently demoted.

        Strike-then-check is the law: the increment and the threshold
        comparison share one locked region, so exactly one thread — the
        one that landed the fatal strike — observes the crossing and
        performs the demotion."""
        self._check_group(group)
        with self._lock:
            if group in self._demoted:
                return False
            self._strikes[group] += 1
            if self._strikes[group] >= self.max_strikes:
                self.demote(group)
                return True
            return False

    def demote(self, group: int):
        self._check_group(group)
        with self._lock:
            self._demoted.add(group)

    def record_exchange(self, group: int, seconds: float):
        """A successful exchange: heartbeat, clear strikes, feed the
        straggler window.  Atomic, and a no-op for the liveness state of
        a demoted group — a success that raced in after the fatal
        strike must not resurrect it."""
        self._check_group(group)
        with self._lock:
            self.heartbeat(group)
            if group not in self._demoted:
                self._strikes[group] = 0
            self.latency.record(group, seconds)

    def stragglers(self) -> list:
        """Live-but-slow groups (``StragglerMonitor`` policy over
        exchange latencies)."""
        with self._lock:
            return [g for g in self.latency.stragglers()
                    if g not in self._demoted]

    def backoff(self, attempt: int) -> float:
        """Pause before failover attempt ``attempt`` (0-based)."""
        return min(self.backoff_base * (2 ** max(attempt, 0)),
                   self.backoff_max)

    def _check_group(self, group: int):
        if not 0 <= group < self.n_groups:
            raise ValueError(
                f"group {group} outside [0, {self.n_groups})")

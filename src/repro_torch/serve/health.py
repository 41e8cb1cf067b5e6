"""Fault injection for the mutation paths: :class:`CrashPlan`.

Counterpart of the reference's ``serve/health.py``, holding only its
``CrashPlan`` (a SIGKILL at a named durability point of
``serve.mutation``).  The serve-time health layer of that module —
``FleetMonitor``, ``FaultPlan``, ``Fault``, ``GroupFailure`` and
``DegradedCoverage`` — comes with the port of the serving loop and
grid failover.
"""

from __future__ import annotations

import dataclasses
import os
import signal

__all__ = ["CrashPlan"]


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

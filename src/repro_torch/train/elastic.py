"""Elastic scaling, node-failure recovery, straggler mitigation.

A copy of ``repro.train.elastic`` (pure Python; the port keeps its own
copy rather than importing the reference).  The port's training driver
uses :class:`StragglerMonitor`, and the serving-side health layer
named below (``serve/health.py``) builds on both classes here.

On a real multi-pod deployment these hooks wire into the cluster manager;
here every decision is pure over an explicit `FleetView`, which makes the
policies unit-testable with fake clocks and synthetic failure sets (see
tests/test_elastic.py and tests/test_torch_train.py).

These primitives are shared with the *serving* side: its
`serve.health.FleetMonitor` snapshots grid host-group liveness as a
`FleetView` (one "device" per host group) and flags slow groups with a
`StragglerMonitor` over cross-group exchange latencies — one fleet
vocabulary across train and serve, not two.

Policies implemented:
  * `plan_mesh`     — biggest (data, model) mesh buildable from survivors,
    preserving the model-parallel degree (TP size changes would reshard
    every weight; DP resize only remaps batch shards).
  * `rescale`       — batch/LR rescale rules after a resize (linear-LR).
  * `StragglerMonitor` — per-host heartbeats; a host slower than
    `threshold x median` over a sliding window is flagged; the runner
    reroutes its microbatches (work-stealing) or requests eviction.
  * Checkpoints are logical (see train/checkpoint.py), so any new mesh
    restores transparently -> elastic restart = restore + plan_mesh.
"""

from __future__ import annotations

import dataclasses
import statistics
from collections import defaultdict, deque


@dataclasses.dataclass(frozen=True)
class FleetView:
    n_devices: int
    failed: frozenset = frozenset()

    @property
    def healthy(self) -> int:
        return self.n_devices - len(self.failed)

    def survivors(self) -> tuple[int, ...]:
        """Healthy device (or serving host-group) ids, ascending."""
        return tuple(i for i in range(self.n_devices)
                     if i not in self.failed)


def plan_mesh(fleet: FleetView, model_parallel: int,
              *, min_data: int = 1) -> tuple[int, int]:
    """Largest (data, model) shape with fixed TP degree from survivors."""
    if model_parallel <= 0:
        raise ValueError("model_parallel must be positive")
    data = fleet.healthy // model_parallel
    if data < min_data:
        raise RuntimeError(
            f"not enough healthy devices ({fleet.healthy}) for "
            f"model_parallel={model_parallel}")
    return data, model_parallel


def rescale(old_data: int, new_data: int, *, batch: int, lr: float,
            keep_global_batch: bool = True) -> dict:
    """After a DP resize: keep the global batch (grad-accumulate) or scale
    LR linearly with the actual batch."""
    if keep_global_batch:
        accum = -(-old_data // new_data)  # ceil
        return {"global_batch": batch, "grad_accum": accum, "lr": lr}
    new_batch = batch * new_data // old_data
    return {"global_batch": new_batch, "grad_accum": 1,
            "lr": lr * new_batch / batch}


class StragglerMonitor:
    """Flag hosts whose step time exceeds threshold x median repeatedly."""

    def __init__(self, threshold: float = 1.5, window: int = 8,
                 patience: int = 3):
        self.threshold = threshold
        self.window = window
        self.patience = patience
        self._times: dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window))
        self._strikes: dict[str, int] = defaultdict(int)

    def record(self, host: str, step_time: float):
        self._times[host].append(step_time)

    def _medians(self) -> dict[str, float]:
        return {h: statistics.median(ts) for h, ts in self._times.items()
                if len(ts) >= max(2, self.window // 2)}

    def stragglers(self) -> list[str]:
        med = self._medians()
        if len(med) < 2:
            return []
        fleet_median = statistics.median(med.values())
        out = []
        for host, m in med.items():
            if m > self.threshold * fleet_median:
                self._strikes[host] += 1
            else:
                self._strikes[host] = 0
            if self._strikes[host] >= self.patience:
                out.append(host)
        return out

    def plan_rebalance(self, microbatches: dict[str, int]) -> dict[str, int]:
        """Steal one microbatch from each straggler, give to the fastest."""
        slow = set(self.stragglers())
        if not slow:
            return dict(microbatches)
        med = self._medians()
        fast = min((h for h in microbatches if h not in slow),
                   key=lambda h: med.get(h, float("inf")), default=None)
        out = dict(microbatches)
        for h in slow:
            if h in out and out[h] > 1 and fast is not None:
                out[h] -= 1
                out[fast] += 1
        return out

"""The port's serving health layer (``repro_torch.serve.health``) against
the reference's (``repro.serve.health``).

Every scenario of ``tests/test_health.py`` runs once against each
package with the same fake clock and the same calls, and returns what
the caller can observe (return values, live/demoted sets, fleet views,
backoffs, stragglers, exceptions by class name and message).  The two
records must be equal, and each must show what the reference's test
asserts.
"""

import threading
import time

import pytest

from repro.serve import health as j_health
from repro.train import elastic as j_elastic
from repro_torch.serve import health as t_health
from repro_torch.train import elastic as t_elastic

PACKAGES = {"repro": (j_health, j_elastic), "repro_torch": (t_health,
                                                             t_elastic)}


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def raised(fn, *a, **kw):
    """``("raised", class name, message)`` of what ``fn`` raises, or
    ``("returned", value)``."""
    try:
        return ("returned", fn(*a, **kw))
    except Exception as e:           # the scenario records the exception
        return ("raised", type(e).__name__, str(e))


def view(fleet):
    return (fleet.n_devices, sorted(fleet.failed), fleet.survivors())


# -- scenarios: each takes (health module, elastic module), returns a record


def fault_unknown_kind(h, el):
    return [raised(h.Fault, group=0, kind="explode"),
            raised(h.kill_group, 0, when="sometime")]


def fault_round_matching(h, el):
    always, exact = h.kill_group(1), h.kill_group(1, round=2)
    onward = h.kill_group(1, from_round=2)
    return [[f.active(i) for i in range(4)] for f in (always, exact, onward)]


def plan_kill_before(h, el):
    plan = h.FaultPlan([h.kill_group(0, when="before")])
    return [plan.begin_round(), raised(plan.check, 0, "dispatch"),
            raised(plan.check, 0, "exchange"),
            raised(plan.check, 1, "dispatch")]


def plan_kill_after(h, el):
    plan = h.FaultPlan([h.kill_group(0, when="after")])
    plan.begin_round()
    return [raised(plan.check, 0, "dispatch"),
            raised(plan.check, 0, "exchange")]


def plan_round_gating(h, el):
    plan = h.FaultPlan([h.kill_group(0, round=1)])
    out = []
    for _ in range(3):
        out += [plan.begin_round(), plan.round,
                raised(plan.check, 0, "dispatch")]
    return out


def plan_delay_sleeps_injected(h, el):
    slept = []
    plan = h.FaultPlan([h.delay_group(2, 0.25)], sleep=slept.append)
    plan.begin_round()
    plan.check(2, "dispatch")
    before = list(slept)
    plan.check(2, "exchange")
    return [before, slept, plan.faults[0].delay, plan.faults[0].kind]


def plan_bad_stage(h, el):
    return [raised(h.FaultPlan().check, 0, "compute")]


def monitor_validation(h, el):
    mon = h.FleetMonitor(2)
    return [raised(h.FleetMonitor, 0),
            raised(h.FleetMonitor, 2, retries=-1),
            raised(h.FleetMonitor, 2, max_strikes=0),
            raised(mon.is_live, 2), raised(mon.strike, -1)]


def monitor_groups_start_live(h, el):
    mon = h.FleetMonitor(3, clock=FakeClock())
    return [sorted(mon.live()), sorted(mon.demoted)]


def monitor_heartbeat_staleness(h, el):
    clk = FakeClock()
    mon = h.FleetMonitor(2, heartbeat_timeout=1.0, clock=clk)
    out = []
    clk.advance(0.9)
    out.append(sorted(mon.live()))
    clk.advance(0.2)
    out.append(sorted(mon.live()))
    mon.heartbeat(1)
    out.append(sorted(mon.live()))
    return out


def monitor_no_timeout(h, el):
    clk = FakeClock()
    mon = h.FleetMonitor(2, clock=clk)
    clk.advance(1e9)
    return [sorted(mon.live())]


def monitor_strikes_demote(h, el):
    mon = h.FleetMonitor(3, max_strikes=3, clock=FakeClock())
    out = [mon.strike(1), mon.strike(1), mon.strike(1)]
    return out + [sorted(mon.demoted), sorted(mon.live()), mon.strike(1)]


def monitor_success_clears(h, el):
    mon = h.FleetMonitor(2, max_strikes=2, clock=FakeClock())
    mon.strike(0)
    mon.record_exchange(0, 0.01)
    return [mon.strike(0), sorted(mon.demoted)]


def monitor_record_exchange_heartbeats(h, el):
    clk = FakeClock()
    mon = h.FleetMonitor(2, heartbeat_timeout=1.0, clock=clk)
    clk.advance(2.0)
    out = [sorted(mon.live())]
    mon.record_exchange(0, 0.01)
    return out + [sorted(mon.live())]


def monitor_fleet_view(h, el):
    mon = h.FleetMonitor(4, clock=FakeClock())
    mon.demote(2)
    fleet = mon.fleet()
    return [view(fleet), fleet == el.FleetView(n_devices=4,
                                               failed=frozenset({2}))]


def monitor_backoff(h, el):
    mon = h.FleetMonitor(2, backoff_base=0.05, backoff_max=0.4,
                         clock=FakeClock())
    return [mon.backoff(a) for a in (0, 1, 2, 10, -3)]


def monitor_stragglers_exclude_demoted(h, el):
    mon = h.FleetMonitor(3, straggler_threshold=1.5, straggler_window=4,
                         straggler_patience=1, clock=FakeClock())
    for _ in range(4):
        mon.record_exchange(0, 0.01)
        mon.record_exchange(1, 0.01)
        mon.record_exchange(2, 0.10)
    out = [mon.stragglers()]
    mon.demote(2)
    return out + [mon.stragglers()]


def monitor_stale_group_in_fleet(h, el):
    """Staleness and demotion both fail a group in the fleet view."""
    clk = FakeClock()
    mon = h.FleetMonitor(3, heartbeat_timeout=0.5, clock=clk)
    mon.demote(0)
    clk.advance(0.4)
    mon.heartbeat(1)
    mon.heartbeat(0)                  # no resurrection
    clk.advance(0.3)
    return [view(mon.fleet()), mon.is_live(0), mon.is_live(1),
            mon.is_live(2)]


def concurrent_strikes_demote_once(h, el):
    mon = h.FleetMonitor(1, max_strikes=8, clock=FakeClock())
    crossings = []

    def striker():
        for _ in range(4):
            if mon.strike(0):
                crossings.append(1)

    _run_threads([threading.Thread(target=striker) for _ in range(4)])
    return [sorted(mon.demoted), len(crossings)]


def racing_successes_never_resurrect(h, el):
    mon = h.FleetMonitor(1, max_strikes=2, clock=FakeClock())
    mon.strike(0)
    mon.strike(0)

    def success():
        for _ in range(50):
            mon.record_exchange(0, 0.01)

    _run_threads([threading.Thread(target=success) for _ in range(4)])
    return [sorted(mon.demoted), mon.is_live(0)]


def concurrent_mixed_traffic(h, el):
    mon = h.FleetMonitor(4, max_strikes=3, clock=FakeClock())
    stop = threading.Event()

    def hammer(g):
        while not stop.is_set():
            mon.record_exchange(g, 0.01)
            mon.strike(g)
            mon.is_live(g)
            mon.live()

    threads = [threading.Thread(target=hammer, args=(g,)) for g in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.2)
    stop.set()
    _run_threads(threads, started=True)
    # whichever interleaving ran: no torn state
    return [all(mon.is_live(g) == (g not in mon.demoted)
                and 0 <= mon._strikes[g] <= mon.max_strikes
                for g in range(4))]


def _run_threads(threads, started=False):
    if not started:
        for t in threads:
            t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)


# what tests/test_health.py asserts, per scenario
EXPECTED = {
    fault_round_matching: [[True] * 4, [False, False, True, False],
                           [False, False, True, True]],
    plan_delay_sleeps_injected: [[], [0.25], 0.25, "delay"],
    monitor_groups_start_live: [[0, 1, 2], []],
    monitor_heartbeat_staleness: [[0, 1], [], [1]],
    monitor_no_timeout: [[0, 1]],
    monitor_strikes_demote: [False, False, True, [1], [0, 2], False],
    monitor_success_clears: [False, []],
    monitor_record_exchange_heartbeats: [[], [0]],
    monitor_fleet_view: [(4, [2], (0, 1, 3)), True],
    monitor_stragglers_exclude_demoted: [[2], []],
    concurrent_strikes_demote_once: [[0], 1],
    racing_successes_never_resurrect: [[0], False],
    concurrent_mixed_traffic: [True],
}

SCENARIOS = [fault_unknown_kind, fault_round_matching, plan_kill_before,
             plan_kill_after, plan_round_gating, plan_delay_sleeps_injected,
             plan_bad_stage, monitor_validation, monitor_groups_start_live,
             monitor_heartbeat_staleness, monitor_no_timeout,
             monitor_strikes_demote, monitor_success_clears,
             monitor_record_exchange_heartbeats, monitor_fleet_view,
             monitor_backoff, monitor_stragglers_exclude_demoted,
             monitor_stale_group_in_fleet, concurrent_strikes_demote_once,
             racing_successes_never_resurrect, concurrent_mixed_traffic]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_port_observes_what_reference_observes(scenario):
    records = {name: scenario(*mods) for name, mods in PACKAGES.items()}
    assert records["repro_torch"] == records["repro"]
    if scenario in EXPECTED:
        assert records["repro_torch"] == EXPECTED[scenario]


def test_raised_messages_are_the_reference_assertions():
    """The exception records carry what tests/test_health.py matches."""
    h = t_health
    assert fault_unknown_kind(h, None)[0][1:] == (
        "ValueError", "unknown fault kind 'explode'")
    assert "when=" in fault_unknown_kind(h, None)[1][2]
    before = plan_kill_before(h, None)
    assert before[1][:2] == ("raised", "GroupFailure")
    assert "down at dispatch" in before[1][2]
    assert before[2] == before[3] == ("returned", None)
    after = plan_kill_after(h, None)
    assert after[0] == ("returned", None)
    assert "mid-exchange" in after[1][2]
    gating = plan_round_gating(h, None)
    assert [gating[i][0] for i in (2, 5, 8)] == ["returned", "raised",
                                                 "returned"]
    assert "stage=" in plan_bad_stage(h, None)[0][2]
    val = monitor_validation(h, None)
    for rec, needle in zip(val, ("n_groups", "retries", "max_strikes",
                                 "outside", "outside")):
        assert rec[1] == "ValueError" and needle in rec[2]
    assert monitor_backoff(h, None) == pytest.approx(
        [0.05, 0.1, 0.2, 0.4, 0.05])
    assert monitor_stale_group_in_fleet(h, None) == [
        (3, [0, 2], (1,)), False, True, False]


def test_exports_match():
    assert sorted(t_health.__all__) == sorted(j_health.__all__)
    assert issubclass(t_health.GroupFailure, RuntimeError)
    assert issubclass(t_health.DegradedCoverage, RuntimeError)
    assert t_health.FleetMonitor(2).fleet().__class__ is t_elastic.FleetView

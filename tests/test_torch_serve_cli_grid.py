"""The port's serving CLI on a grid of four CPU positions
(``launch.mesh.local_devices`` monkeypatched, the one source of the
CLI's devices): the legs of ``--mesh host|grid`` (sharded pruning,
sharded and grid serving, routed serving over host groups, failover and
the loss policies), each answer equal to the unsharded run's; the
``fail`` policy raises; with one device ``--mesh grid`` serves
unsharded and says so, and ``--hosts`` that does not divide the
devices raises.  A file apart from ``test_torch_serve_cli.py`` so that
the suite's ``--dist loadfile`` workers can take the two files' slow
legs at once.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import colbert_base
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve

FOUR = [torch.device("cpu")] * 4

_UNSHARDED = {}


def _unsharded(n_first=64):
    """The unsharded run's top-10 at the smoke config (cached)."""
    if n_first not in _UNSHARDED:
        r = serve.serve_retrieval(colbert_base.SMOKE, n_first=n_first,
                                  device="cpu")
        _UNSHARDED[n_first] = (r.idx, r.scores)
    return _UNSHARDED[n_first]


def _four_devices(monkeypatch):
    monkeypatch.setattr(mesh_lib, "local_devices", lambda device=None: FOUR)


GRID_LEGS = {
    ("--mesh", "grid", "--kill-group", "0"):
        ["grid serving mesh: {'hosts': 2, 'candidates': 2}",
         "injected loss of host group 0"],
    ("--mesh", "host"): ["sharded serving mesh", "(4 candidate shards)"],
    ("--mesh", "grid", "--replicas", "2", "--on-group-loss", "fail"):
        ["replicas=2", "coverage: 1.000"],
    ("--route", "bounded", "--index-dir", "x", "--mesh", "grid"):
        ["host groups consulted", "routed recall@10 vs exhaustive: 1.000",
         "(2 host-group bodies)"],
    ("--hosts", "2"): ["[serve] route: two-stage"],
}


@pytest.mark.parametrize("argv", [list(a) for a in GRID_LEGS], ids=" ".join)
def test_grid_legs_serve(argv, monkeypatch, tmp_path, capsys):
    """On four CPU positions each grid leg's top-10 equals the unsharded
    run's (the routed leg's: the e2e sweep's); every multi-device run
    prunes over data=4."""
    _four_devices(monkeypatch)
    monkeypatch.chdir(tmp_path)
    res = serve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    for line in GRID_LEGS[tuple(argv)]:
        assert line in out, (line, out)
    assert ("sharded pruning over data=4" in out) == ("--mesh" in argv)
    want = _unsharded(0 if "--route" in argv else 64)
    np.testing.assert_array_equal(res.idx, want[0])
    np.testing.assert_array_equal(res.scores, want[1])


@pytest.mark.parametrize("replicas,policy,coverage", [
    (2, "degrade", 1.0), (1, "degrade", None), (1, "rebalance", 1.0)])
def test_kill_group_on_the_grid(replicas, policy, coverage, monkeypatch,
                                capsys):
    """E2e on a 2 x 2 grid with group 1 lost: replicas or ``rebalance``
    answer in full, bit-equal to the unsharded sweep; one replica under
    ``degrade`` answers with coverage < 1."""
    _four_devices(monkeypatch)
    res = serve.serve_retrieval(colbert_base.SMOKE, n_first=0, mesh="grid",
                                hosts=2, replicas=replicas,
                                on_group_loss=policy, kill_group=1,
                                device="cpu")
    assert "injected loss of host group 1" in capsys.readouterr().out
    if coverage is None:
        assert res.coverage < 1.0
        assert res.server.monitor.demoted == frozenset({1})
        return
    assert res.coverage == coverage
    want = _unsharded(n_first=0)
    np.testing.assert_array_equal(res.idx, want[0])
    np.testing.assert_array_equal(res.scores, want[1])


def test_kill_group_fail_policy_raises(monkeypatch):
    from repro_torch.serve.health import DegradedCoverage
    _four_devices(monkeypatch)
    with pytest.raises(DegradedCoverage, match="demoted groups: \\[1\\]"):
        serve.main(["--mesh", "grid", "--on-group-loss", "fail",
                    "--kill-group", "1", "--n-first", "0", "--device",
                    "cpu"])


def test_grid_mesh_validation(monkeypatch, capsys):
    # one device: too few for two groups, so --mesh grid serves unsharded
    res = serve.main(["--mesh", "grid", "--device", "cpu"])
    assert "serving unsharded" in capsys.readouterr().out
    assert res.server.monitor is None
    _four_devices(monkeypatch)
    with pytest.raises(ValueError, match="divide"):
        serve.main(["--mesh", "grid", "--hosts", "3", "--device", "cpu"])
    with pytest.raises(ValueError, match="replicas"):
        serve.serve_retrieval(colbert_base.SMOKE, replicas=0, device="cpu")

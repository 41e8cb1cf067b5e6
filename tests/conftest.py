"""Suite-wide hang protection.

The concurrency tests (serving loop, fleet monitor, tuning-cache
dumps) exercise real locks; a regression there deadlocks instead of
failing.  Two layers keep that from hanging the run forever:

- CI installs pytest-timeout (requirements.txt) and this conftest sets
  a per-test default, so a hung test dumps its stacks and FAILS.
- Environments without the plugin (pinned images, no network) get a
  faulthandler watchdog re-armed around every test: a test that
  exceeds the budget dumps every thread's stack to stderr and aborts
  the process — diagnosable, never silent.

The budget is generous: tier-1 includes 4-device subprocess grid
cases and kill -9 crash sweeps that legitimately take tens of
seconds.  Per-test timeouts passed on the command line or via marks
still override the default.
"""

import faulthandler

import pytest

TIMEOUT_S = 300

_have_timeout_plugin = False


def pytest_configure(config):
    global _have_timeout_plugin
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where there is none")
    _have_timeout_plugin = config.pluginmanager.hasplugin("timeout")
    if _have_timeout_plugin and getattr(config.option, "timeout", None) is None:
        config.option.timeout = TIMEOUT_S


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    if not _have_timeout_plugin:
        # exit=True: a deadlocked test can't be un-hung from inside the
        # process, so after the stack dump the only useful move is out.
        faulthandler.dump_traceback_later(TIMEOUT_S, exit=True)
    try:
        yield
    finally:
        if not _have_timeout_plugin:
            faulthandler.cancel_dump_traceback_later()

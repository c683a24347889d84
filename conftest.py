"""Limits of the whole test run: which tests are `slow`, and how long a
default test may take.

`pytest tests/ -m 'not slow'` is the default run; `pytest tests/ -m slow`
runs what is listed in SLOW below, unchanged.  Each phase (setup, call,
teardown) of a default test gets LIMIT seconds.
"""

import faulthandler
import os
import signal
import tempfile

import pytest

# The JAX reference's minutes-long runs.  Each exercises only that
# package, the reference, nearly all of it in XLA compiles; the port's
# default tests hold the same circuits against it (tests/test_torch_cli.py,
# tests/test_torch_circuit*.py, tests/test_torch_boot.py,
# tests/test_torch_parallel.py).  Each took over 120 s on an empty compile
# cache on 8 CPU cores: the e2e wrappers 584-976 s and the 8-device dry
# run 1419 s (two to four such runs at a time), test_bootstrap_batch_
# chunking 123-124 s alone.  The packed units' wrapper (80 s) and
# test_bootstrap_wide (112-114 s alone) stay in the default run.
SLOW = frozenset({
    "tests/test_e2e_subproc.py::test_cli_e2e_isolated",
    "tests/test_e2e_subproc.py::test_circuit_stages_isolated",
    "tests/test_e2e_subproc.py::test_circuit_packed_forward_isolated",
    "tests/test_e2e_subproc.py::test_circuit_packed_rechunked_isolated",
    "tests/test_e2e_subproc.py::test_circuit_packed_boot_forward_isolated",
    "tests/test_e2e_subproc.py::test_circuit_boot_isolated",
    "tests/test_parallel.py::test_dryrun_multichip_8",
    "tests/test_bootstrap.py::test_bootstrap_batch_chunking",
})

# Seconds each phase of a default test under tests/ may take (the
# benchmark's own tests under port_bench/ get none).  The longest default
# phase, test_bootstrap_refreshes's call, took 129 s on an empty compile
# cache under `-n 6` on 8 cores; 360 s is about twice that and above the
# 300 s that tests/test_torch_parallel.py's rank launches may wait, so
# their own timeouts fire first.  No limit for tests marked `slow`, nor
# for the tests that a wrapper of tests/test_e2e_subproc.py runs in its
# own interpreter (_FHE_SUBPROC): the wrapper is timed.
LIMIT = 360

# A phase past LIMIT is stopped by SIGALRM, which Python handles between
# bytecodes of the main thread: a hang in Python code or in an
# interruptible wait (sleep, a subprocess, a lock) fails under its test's
# name with every thread's stack, and the worker goes on.  A main thread
# stuck in native code (an XLA compile, a C++ collective) never runs the
# handler; GRACE seconds later faulthandler writes every stack to the
# run's stderr and ends the process, so that xdist reports the test as
# crashed and goes on in a new worker.
GRACE = 60

_stderr = None  # the run's own stderr, which test capture leaves alone


class PhaseTimeout(BaseException):
    """A test phase ran past LIMIT.  Not an Exception, so that the code
    under test cannot swallow it in an `except Exception`."""


def pytest_configure(config):
    global _stderr
    _stderr = os.dup(2)


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)


def _past_limit(signum, frame):
    with tempfile.TemporaryFile("w+") as f:
        faulthandler.dump_traceback(f, all_threads=True)
        f.seek(0)
        stacks = f.read()
    raise PhaseTimeout(f"test phase ran past its {LIMIT} s limit "
                       f"(conftest.py LIMIT); every thread:\n{stacks}")


def _limited(item):
    if not item.nodeid.startswith("tests/") or \
            item.get_closest_marker("slow") or \
            os.environ.get("_FHE_SUBPROC") == "1":
        return (yield)
    previous = signal.signal(signal.SIGALRM, _past_limit)
    signal.setitimer(signal.ITIMER_REAL, LIMIT)
    faulthandler.dump_traceback_later(LIMIT + GRACE, exit=True,
                                      file=_stderr)
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    return (yield from _limited(item))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    return (yield from _limited(item))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    return (yield from _limited(item))

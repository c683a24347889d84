"""The per-test time limit of the root conftest.py.

A child pytest loads that conftest as a plugin and runs a throwaway file
whose autouse fixture cuts `LIMIT` and `GRACE` to about a second.  A test
that sleeps past the limit, even inside an `except Exception`, fails
under its own name with every thread's stack, the tests after it still
run, and a `slow` test is not limited: once in the child's main process
and once in an xdist worker.  A test whose main thread cannot take the
alarm, as in native code, ends its xdist worker after the grace with
every thread's stack, and the run goes on in a new worker."""

import os
import re
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_LIMIT = """
    import signal
    import time

    import pytest

    import conftest


    @pytest.fixture(autouse=True)
    def tiny_limit(monkeypatch):
        monkeypatch.setattr(conftest, "LIMIT", 0.5)
        monkeypatch.setattr(conftest, "GRACE", 1)
"""

PAST_LIMIT = TINY_LIMIT + """

    def test_sleeps_past_the_limit():
        try:
            time.sleep(30)
        except Exception:
            pass


    def test_runs_after_it():
        assert True


    @pytest.mark.slow
    def test_slow_has_no_limit():
        time.sleep(1.5)
"""

NATIVE_HANG = TINY_LIMIT + """

    def test_alarm_cannot_reach():
        signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
        time.sleep(30)


    def test_runs_after_it():
        assert True
"""


def _child_pytest(tmp_path, source, *args):
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_throwaway.py").write_text(
        textwrap.dedent(source))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [REPO, os.environ.get("PYTHONPATH")])))
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_throwaway.py",
         "--rootdir", ".", "-p", "conftest", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-rA", *args],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    return r.returncode, r.stdout + r.stderr


@pytest.mark.parametrize("workers", [[], ["-p", "xdist", "-n", "1"]],
                         ids=["main-process", "xdist-worker"])
def test_phase_past_limit_fails_by_name_and_the_run_goes_on(tmp_path,
                                                            workers):
    rc, out = _child_pytest(tmp_path, PAST_LIMIT, *workers)
    assert rc == 1, out
    assert "FAILED tests/test_throwaway.py::test_sleeps_past_the_limit" \
        in out, out
    assert "ran past its 0.5 s limit" in out, out
    assert "(most recent call first)" in out, out
    assert re.search(r'test_throwaway.py", line \d+ in '
                     r'test_sleeps_past_the_limit', out), out
    assert "PASSED tests/test_throwaway.py::test_runs_after_it" in out, out
    assert "PASSED tests/test_throwaway.py::test_slow_has_no_limit" in out, out
    assert "1 failed, 2 passed" in out, out


def test_phase_stuck_past_the_grace_ends_its_worker_and_the_run_goes_on(
        tmp_path):
    rc, out = _child_pytest(tmp_path, NATIVE_HANG, "-p", "xdist", "-n", "1")
    assert rc == 1, out
    assert "crashed while running 'tests/test_throwaway.py::" \
           "test_alarm_cannot_reach'" in out, out
    assert re.search(r'test_throwaway.py", line \d+ in '
                     r'test_alarm_cannot_reach', out), out
    assert "PASSED tests/test_throwaway.py::test_runs_after_it" in out, out
    assert "1 failed, 1 passed" in out, out

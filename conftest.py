"""Tier-1 scheduling and a time limit for each test under ``tests/``.

pytest loads this file for every run under the repository root, before
``tests/conftest.py`` (the CPU platform set-up). What it does acts only on the
tests under ``tests/``; ``benchmark/tests`` runs as before.

The tier-1 command runs ``tests/`` under ``-p xdist --dist loadfile``, where
each file is one unit of work. xdist hands those units out by their number of
tests, most first, which left the heaviest files (a few slow tests each) to the
end of the run. Here they go out longest first instead, by the seconds in
``tests/file_seconds.json``; a file missing from it comes after the listed
ones, in collection order.
"""

import faulthandler
import json
import signal
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import pytest

TESTS = Path(__file__).parent / "tests"
FILE_SECONDS = TESTS / "file_seconds.json"
# Tests of files this project keeps as they are, left to the slow tier
# (``-m slow``) by node id.
SLOW = {
    # The JAX package's radius-8 Pallas kernel traced in interpret mode: still
    # running after 900 s alone, more than half of the tier-1 run's limit.
    "tests/test_dcn_pallas.py::TestPallasDCN::test_wide_radius_auto_rps",
}
# One limit for each tier-1 test, its setup, call and teardown together: a
# little over twice the slowest tier-1 test (a Pallas interpret trace, 270 s).
TEST_SECONDS = 600
# Once over its limit, a test is interrupted again this often, so code that
# catches the first TimeoutError does not end the limit.
REFIRE_SECONDS = 10
# faulthandler ends the process this long after the limit when the alarm could
# not interrupt the test (a hang inside C code that never returns to Python).
HANG_GRACE_SECONDS = 60

_DEADLINE = pytest.StashKey[float]()


def longest_first(seconds):
    """Sort key over test file names: files listed in ``seconds`` longest
    first, then unlisted files; a stable sort keeps ties in their given order."""

    def key(name):
        s = seconds.get(name)
        return (0, -s) if s is not None else (1, 0)

    return key


@contextmanager
def time_limit(seconds, message=None, every=REFIRE_SECONDS):
    """Raise ``TimeoutError`` in the block once it has run ``seconds``, and
    again each ``every`` seconds while it goes on.

    Through ``SIGALRM``, so in the main thread (pytest-xdist runs its workers'
    tests there). A limit around this one is put back on the way out, less the
    time spent here.
    """

    def _expire(signum, frame):
        raise TimeoutError(message or f"over the time limit of {seconds:g} s")

    start = time.monotonic()
    handler = signal.signal(signal.SIGALRM, _expire)
    outer, outer_every = signal.setitimer(signal.ITIMER_REAL, seconds, every)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, handler)
        if outer:
            left = max(outer - (time.monotonic() - start), 1e-3)
            signal.setitimer(signal.ITIMER_REAL, left, outer_every)


def _in_tests(item):
    return item.path.parent == TESTS


def pytest_configure(config):
    # Keep the order pytest_collection_modifyitems gives; under xdist's
    # loadfile scheduling that is the order the files are handed out in.
    config.option.loadscopereorder = False


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    # First, so that ``-m`` selects by the marks set here.
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)
    key = longest_first(json.loads(FILE_SECONDS.read_text()))
    items.sort(key=lambda item: key(item.path.name) if _in_tests(item) else (1, 0))


@contextmanager
def _until_deadline(item, teardown=False):
    """The rest of the item's time limit around one of its phases, so that
    the limit's exception lands inside that phase's own report."""
    deadline = item.stash.get(_DEADLINE, None)
    left = None if deadline is None else deadline - time.monotonic()
    if left is None or (teardown and left <= 0):
        # No limit, or the test has run out: its teardown runs all the same,
        # under the faulthandler backstop alone.
        yield
        return
    with time_limit(max(left, 1e-3), f"over the time limit of {TEST_SECONDS} s",
                    every=REFIRE_SECONDS):
        yield


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    if _in_tests(item) and item.get_closest_marker("slow") is None:
        item.stash[_DEADLINE] = time.monotonic() + TEST_SECONDS
        faulthandler.dump_traceback_later(
            TEST_SECONDS + HANG_GRACE_SECONDS, exit=True, file=sys.__stderr__)
    with _until_deadline(item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _until_deadline(item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    try:
        with _until_deadline(item, teardown=True):
            return (yield)
    finally:
        if _DEADLINE in item.stash:
            faulthandler.cancel_dump_traceback_later()

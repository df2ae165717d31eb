"""The tier-1 harness in the repository's root ``conftest.py``: the order test
files are handed out in, the table of their seconds that sets it, the tests it
leaves to the slow tier, and the per-test time limit."""

import ast
import importlib.util
import json
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT_CONFTEST = Path(__file__).resolve().parents[1] / "conftest.py"
# tests/conftest.py holds the module name ``conftest``, so load this one by path.
_spec = importlib.util.spec_from_file_location("tier1_conftest", ROOT_CONFTEST)
harness = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(harness)


def test_listed_files_go_longest_first_then_unlisted_in_given_order():
    seconds = {"c.py": 9.0, "b.py": 1.0, "e.py": 4.5}
    items = [("a.py", "t1"), ("a.py", "t2"), ("b.py", "t1"), ("c.py", "t1"),
             ("c.py", "t2"), ("d.py", "t1"), ("e.py", "t1")]
    key = harness.longest_first(seconds)
    assert sorted(items, key=lambda it: key(it[0])) == [
        ("c.py", "t1"), ("c.py", "t2"), ("e.py", "t1"), ("b.py", "t1"),
        ("a.py", "t1"), ("a.py", "t2"), ("d.py", "t1")]


def test_no_stale_entry_in_the_file_table_or_the_slow_set():
    seconds = json.loads(harness.FILE_SECONDS.read_text())
    missing = sorted(n for n in seconds if not (harness.TESTS / n).is_file())
    assert missing == [], "stale in file_seconds.json"
    for nodeid in harness.SLOW:
        path, *names = nodeid.split("::")
        scope = ast.parse((ROOT_CONFTEST.parent / path).read_text())
        for name in names:
            scope = next((n for n in scope.body if getattr(n, "name", None) == name), None)
            assert scope is not None, f"stale in SLOW: {nodeid}"


def test_time_limit_fails_a_block_that_sleeps_past_it_and_nests():
    handler = signal.getsignal(signal.SIGALRM)
    with harness.time_limit(30):
        start = time.monotonic()
        with pytest.raises(TimeoutError, match="time limit of 1 s"):
            with harness.time_limit(1):
                time.sleep(5)
        assert time.monotonic() - start < 3
        assert 25 < signal.getitimer(signal.ITIMER_REAL)[0] <= 30  # the outer one, back
    assert signal.getsignal(signal.SIGALRM) is handler


def test_time_limit_fires_again_when_the_first_timeout_is_caught():
    start = time.monotonic()
    with pytest.raises(TimeoutError):
        with harness.time_limit(0.2, every=0.2):
            try:
                time.sleep(5)
            except TimeoutError:
                pass
            time.sleep(5)
    assert time.monotonic() - start < 3


INNER_CONFTEST = f"""
import importlib.util
from pathlib import Path

spec = importlib.util.spec_from_file_location("tier1", {str(ROOT_CONFTEST)!r})
tier1 = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tier1)
tier1.TESTS = Path(__file__).parent
tier1.TEST_SECONDS, tier1.REFIRE_SECONDS = 1, 1


def pytest_configure(config):
    config.pluginmanager.register(tier1, "tier1")
"""

INNER_TESTS = """
import time

import pytest


def test_sleeps_past_the_limit():
    time.sleep(30)


def test_catches_the_first_timeout():
    try:
        time.sleep(30)
    except Exception:
        pass
    time.sleep(30)


@pytest.mark.slow
def test_slow_tier_has_no_limit():
    time.sleep(1.5)


def test_after_them():
    pass
"""


def test_a_test_over_the_limit_fails_and_the_run_goes_on(tmp_path):
    (tmp_path / "pytest.ini").write_text("[pytest]\nmarkers =\n    slow: slow\n")
    (tmp_path / "conftest.py").write_text(INNER_CONFTEST)
    (tmp_path / "test_inner.py").write_text(INNER_TESTS)
    start = time.monotonic()
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", str(tmp_path)],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    out = run.stdout + run.stderr
    assert time.monotonic() - start < 30, out
    assert run.returncode == 1, out
    assert "2 failed, 2 passed" in out, out
    assert out.count("TimeoutError: over the time limit of 1 s") >= 2, out

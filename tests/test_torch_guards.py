"""The guards that every port test file imports from `_torch_guards`:
each xdist worker's share of the CPUs, and the time limit on each test."""

import os
import signal
import time

import _torch_guards
import pytest
import torch
from _torch_guards import (  # noqa: F401
    TEST_TIME_LIMIT_S,
    thread_share,
    time_limit,
    time_limited,
)


@pytest.mark.parametrize(
    "cpus, workers, share",
    [(8, 6, 1), (8, 2, 4), (8, 1, 8), (2, 6, 1), (None, 1, 1)],
)
def test_thread_share(cpus, workers, share):
    assert thread_share(cpus, workers) == share


def test_a_worker_runs_torch_on_its_share():
    if "PYTEST_XDIST_WORKER" in os.environ:
        assert torch.get_num_threads() == int(os.environ["OMP_NUM_THREADS"])


def test_every_port_test_runs_under_the_time_limit():
    left, _ = signal.getitimer(signal.ITIMER_REAL)
    assert 0 < left <= TEST_TIME_LIMIT_S


def test_time_limit_fails_what_runs_past_it(request):
    nodeid = request.node.nodeid
    with pytest.raises(pytest.fail.Exception, match="time limit of 1 s") as e:
        with time_limit(nodeid, 1):
            time.sleep(5)
    assert nodeid in str(e.value)


def test_time_limit_leaves_alone_what_ends_in_time(capfd):
    handler = signal.getsignal(signal.SIGALRM)
    with time_limit("tests/test_x.py::test_quick", 1):
        pass
    assert signal.getsignal(signal.SIGALRM) is handler
    time.sleep(1.5)  # neither the alarm nor the stack dump goes off
    assert "Timeout" not in capfd.readouterr().err


def test_time_limit_gives_back_the_enclosing_limit():
    with time_limit("tests/test_x.py::test_outer", 100):
        with time_limit("tests/test_x.py::test_inner", 1):
            assert signal.getitimer(signal.ITIMER_REAL)[0] <= 1
        assert 99 < signal.getitimer(signal.ITIMER_REAL)[0] <= 100
    left, _ = signal.getitimer(signal.ITIMER_REAL)
    assert TEST_TIME_LIMIT_S - 10 < left <= TEST_TIME_LIMIT_S


def test_time_limit_disarms_when_nothing_encloses_it(monkeypatch):
    monkeypatch.setattr(_torch_guards, "_deadlines", [])  # as if outside a test
    with time_limit("tests/test_x.py::test_alone", 100):
        assert signal.getitimer(signal.ITIMER_REAL)[0] > 99
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)

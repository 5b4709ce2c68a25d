"""Guards shared by the port's test files (`tests/test_torch_*.py`), which
each import `time_limited` from here.

Importing this module caps an xdist worker at its share of the CPUs
(`thread_share`): workers that each run torch's pool and the native
leaves on every core spin against each other (6 workers on 8 CPUs ran
one port test over 100 times slower).  The outputs are the same at any
thread count.  pytest's workers collect every test file before running
any, so the cap holds for every test a worker runs.  A run without xdist
keeps every core.

`time_limited` is an autouse fixture: each port test's call, and its
function-scoped fixtures, run under `TEST_TIME_LIMIT_S` (`time_limit`).
Its module-scoped fixtures run outside the limit.
"""

import faulthandler
import os
import signal
import sys
import threading
import time
from contextlib import contextmanager

import pytest
import torch


def thread_share(cpus, workers):
    """Threads one test process may use: the CPUs split evenly among the
    `workers` processes that run tests at once, and at least one."""
    return max(1, (cpus or 1) // workers)


# The native leaves, `pipeline/driver.py` and the CLI subprocesses read
# OMP_NUM_THREADS.  Only a worker caps itself: the controller starts the
# workers, and they would inherit its value.
if "PYTEST_XDIST_WORKER" in os.environ:
    _share = thread_share(
        len(os.sched_getaffinity(0)),
        int(os.environ["PYTEST_XDIST_WORKER_COUNT"]),
    )
    for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(_var, str(_share))
    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))

# The longest a port test's call may run.  A hang past it fails with the
# test's node id and every thread's stack, and frees its worker; whether
# the whole run then still ends inside its own time limit depends on when
# the hang began.
TEST_TIME_LIMIT_S = 300

# When each limit armed now runs out (time.monotonic()), outermost first.
_deadlines = []


def _arm(seconds, main):
    faulthandler.dump_traceback_later(seconds, file=sys.__stderr__)
    if main:
        signal.setitimer(signal.ITIMER_REAL, seconds)


@contextmanager
def time_limit(nodeid, seconds):
    """Fail what runs inside with a message naming `nodeid` once it has
    run `seconds`, and dump every thread's stack to stderr then.  On
    leaving, an enclosing limit is armed again for the time it has left.

    Python runs the SIGALRM handler only in the main thread, and only
    between bytecodes: code stuck in a native call is named by the stack
    dump alone."""
    main = threading.current_thread() is threading.main_thread()
    if main:

        def expire(signum, frame):
            pytest.fail(f"{nodeid} ran past its time limit of {seconds} s")

        before = signal.signal(signal.SIGALRM, expire)
    _deadlines.append(time.monotonic() + seconds)
    _arm(seconds, main)
    try:
        yield
    finally:
        _deadlines.pop()
        faulthandler.cancel_dump_traceback_later()
        if main:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, before)
        if _deadlines:
            _arm(max(_deadlines[-1] - time.monotonic(), 1e-3), main)


@pytest.fixture(autouse=True)
def time_limited(request):
    with time_limit(request.node.nodeid, TEST_TIME_LIMIT_S):
        yield

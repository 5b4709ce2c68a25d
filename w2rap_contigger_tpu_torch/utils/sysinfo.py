"""Process memory accounting + micro-timers.

Reference equivalents:
  * MemUsageBytes / PeakMemUsageBytes read /proc self status
    (src/system/System.cc:976-995);
  * SetMaxMemory / GetMaxMemory soft memory ceiling
    (src/system/System.cc:1027-1042) — consulted by the counting
    pipelines to auto-size hash-range batches
    (ops/kmer_engine.count_kmers_batched);
  * TIMELOG_* accumulating micro-timers (src/util/w2rap_timers.h:8-81;
    compile-time-off in the reference, env-gated here via
    W2RAP_TIMELOG=1).
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

_max_memory_bytes: int | None = None


def _proc_status_kb(field: str) -> int:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(field + ":"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


def mem_usage_bytes() -> int:
    """Resident set size (VmRSS), bytes (System.cc:976)."""
    return _proc_status_kb("VmRSS") * 1024


def peak_mem_usage_bytes() -> int:
    """Peak resident set size (VmHWM), bytes (System.cc:985)."""
    return _proc_status_kb("VmHWM") * 1024


def peak_mem_usage_gb_string() -> str:
    """PeakMemUsageGBString (ExtractReads.cc:661-664 print idiom)."""
    return f"{peak_mem_usage_bytes() / 2**30:.2f}"


def mem_available_bytes() -> int:
    """MemAvailable from /proc/meminfo (System.cc consults it for
    parcel sizing)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def set_max_memory(nbytes: int) -> None:
    """Soft memory ceiling (System.cc:1027): sizing advice for the
    counting pipelines, not an enforced limit."""
    global _max_memory_bytes
    _max_memory_bytes = int(nbytes)


def get_max_memory() -> int:
    """GetMaxMemory (System.cc:1035): the ceiling, defaulting to
    MemAvailable (or 1TB when /proc is unreadable)."""
    if _max_memory_bytes:
        return _max_memory_bytes
    avail = mem_available_bytes()
    return avail if avail else (1 << 40)


# ---------------------------------------------------------------------------
# TIMELOG micro-timers
# ---------------------------------------------------------------------------

_timers: dict[str, float] = {}
_counts: dict[str, int] = {}


def timelog_enabled() -> bool:
    return os.environ.get("W2RAP_TIMELOG") not in (None, "", "0")


@contextmanager
def timelog(name: str):
    """Accumulating section timer (TIMELOG_START/STOP analogue).  A
    no-op unless W2RAP_TIMELOG=1."""
    if not timelog_enabled():
        yield
        return
    t0 = time.time()
    try:
        yield
    finally:
        _timers[name] = _timers.get(name, 0.0) + (time.time() - t0)
        _counts[name] = _counts.get(name, 0) + 1


def timelog_report() -> str:
    """TIMELOG_REPORT analogue (AssembleGaps.cc:473-475 prints the
    correction-phase totals)."""
    lines = [
        f"TIMELOG, {name}, {total:.3f}s, {_counts[name]} calls"
        for name, total in sorted(_timers.items())
    ]
    return "\n".join(lines)


def timelog_reset() -> None:
    _timers.clear()
    _counts.clear()

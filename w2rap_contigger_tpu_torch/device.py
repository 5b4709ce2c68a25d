"""Device selection, kernel launch counts and device-synchronised timers.

There is no silent fallback: `resolve_device("cuda")` raises when no
card is visible, and a kernel wrapper given a CUDA tensor launches its
kernel or raises.  The plain PyTorch version of a kernel runs only for
tensors that lie on the CPU (the tests).
"""

from __future__ import annotations

from collections import deque
from contextlib import contextmanager

import numpy as np
import torch

from .utils import sysinfo

# kernel name -> launches since the last reset; each wrapper adds one
# where it launches its kernel and nowhere else
LAUNCHES: dict[str, int] = {
    "pack": 0, "kmerize": 0, "collapse": 0, "radix_tile_sort": 0, "radix_partition": 0,
    "radix_region_sort": 0, "radix_merge_pass": 0, "bitonic_tile_sort": 0,
    "bitonic_cross_stage": 0, "bitonic_merge": 0,
}

# graph.build.build_unitigs since the last reset: chains assembled, and
# what the host still finished: chains its tie loop settled (a chain
# whose head is its mirror's head) and nodes of smooth cycles it walked
ASSEMBLY: dict[str, int] = {"chains": 0, "host_tie_chains": 0, "host_cycle_nodes": 0}

# ops.kmer_engine.count_kmers_batched's range path since the last reset:
# counts that took it, hash ranges counted, the valid rows of the largest
# range, and the valid rows of all ranges
RANGED: dict[str, int] = {"counts": 0, "ranges": 0, "range_rows_max": 0, "range_rows": 0}

# the sharded paths' host waits for device data since the last reset
# (wait_host), and the last of their enqueues and waits in order:
# ("enqueue", "<stage>:<shard>") or ("wait", "<what was read>")
HOST_WAITS = 0
EVENTS: deque = deque(maxlen=4096)


def reset_launches() -> None:
    for counts in (LAUNCHES, ASSEMBLY, RANGED):
        for name in counts:
            counts[name] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_host_waits() -> None:
    global HOST_WAITS
    HOST_WAITS = 0
    EVENTS.clear()


def note(stage: str, shard: int) -> None:
    """Log that `shard`'s work of `stage` was enqueued."""
    EVENTS.append(("enqueue", f"{stage}:{shard}"))


def waits_inside_rounds(events) -> list[tuple[str, str, str]]:
    """(first, wait, second) wherever a host wait falls between two
    shards' enqueues of one round of a stage: consecutive enqueues of a
    stage whose shard index rises (a stage's round restarts at a lower
    shard, as the pathers' rounds and the exchange's chunks do)."""
    bad, last, waits = [], {}, {}
    for kind, label in events:
        if kind == "wait":
            for stage in last:
                waits.setdefault(stage, label)
            continue
        stage, shard = label.rsplit(":", 1)
        prev = last.get(stage)
        if prev is not None and stage in waits and int(shard) > int(prev.rsplit(":", 1)[1]):
            bad.append((prev, waits[stage], label))
        last[stage] = label
        waits.pop(stage, None)
    return bad


def upload(a: np.ndarray, dev) -> torch.Tensor:
    """A host array on `dev`: on a card, copied from pinned memory on the
    current stream without a host wait (the pinned block is kept until
    the copy ends)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(dev).type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def to_host(t: torch.Tensor):
    """Start copying t to the host on the current stream; wait_host
    reads it.  A CPU tensor is its own copy."""
    if t.device.type != "cuda":
        return t, None
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    return out, done


def wait_host(pending, what: str) -> list[np.ndarray]:
    """One host wait: the numpy arrays of to_host copies, once every copy
    ended (counted in HOST_WAITS, logged in EVENTS)."""
    global HOST_WAITS
    for _, done in pending:
        if done is not None:
            done.synchronize()
    HOST_WAITS += 1
    EVENTS.append(("wait", what))
    return [t.numpy() for t, _ in pending]


def resolve_device(device) -> torch.device:
    """torch.device for a user-facing name; cuda without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; the port never falls back to the CPU (use --device cpu "
            "explicitly)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def synchronize(device) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextmanager
def timed(name: str, device):
    """sysinfo.timelog section that waits for the device (or for each
    device of a sequence, such as a mesh's) before it closes, so a
    W2RAP_TIMELOG split holds device time, not enqueue."""
    devices = device if isinstance(device, (list, tuple)) else (device,)
    with sysinfo.timelog(name):
        yield
        for dev in dict.fromkeys(torch.device(d) for d in devices):
            synchronize(dev)

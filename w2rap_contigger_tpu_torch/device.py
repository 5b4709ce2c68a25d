"""Device selection, kernel launch counts and device-synchronised timers.

There is no silent fallback: `resolve_device("cuda")` raises when no
card is visible, and a kernel wrapper given a CUDA tensor launches its
kernel or raises.  The plain PyTorch version of a kernel runs only for
tensors that lie on the CPU (the tests).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from .shared import sysinfo

# kernel name -> launches since the last reset; each wrapper adds one
# where it launches its kernel and nowhere else
LAUNCHES: dict[str, int] = {"kmerize": 0, "collapse": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


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
    """sysinfo.timelog section that waits for the device before it
    closes, so a W2RAP_TIMELOG split holds device time, not enqueue."""
    with sysinfo.timelog(name):
        yield
        synchronize(device)

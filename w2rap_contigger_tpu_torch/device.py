"""Device selection, kernel launch counts and device-synchronised timers.

There is no silent fallback: `resolve_device("cuda")` raises when no
card is visible, and a kernel wrapper given a CUDA tensor launches its
kernel or raises.  The plain PyTorch version of a kernel runs only for
tensors that lie on the CPU (the tests).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from .utils import sysinfo

# kernel name -> launches since the last reset; each wrapper adds one
# where it launches its kernel and nowhere else
LAUNCHES: dict[str, int] = {
    "kmerize": 0, "collapse": 0, "radix_tile_sort": 0, "radix_partition": 0,
    "radix_region_sort": 0, "radix_merge_pass": 0, "bitonic_tile_sort": 0,
    "bitonic_cross_stage": 0, "bitonic_merge": 0,
}


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
    """sysinfo.timelog section that waits for the device (or for each
    device of a sequence, such as a mesh's) before it closes, so a
    W2RAP_TIMELOG split holds device time, not enqueue."""
    devices = device if isinstance(device, (list, tuple)) else (device,)
    with sysinfo.timelog(name):
        yield
        for dev in dict.fromkeys(torch.device(d) for d in devices):
            synchronize(dev)

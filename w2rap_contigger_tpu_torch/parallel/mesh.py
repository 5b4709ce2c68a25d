"""Multi-device sharding of steps 2 and 3: one process, a list of devices.

Counterpart of w2rap_contigger_tpu/parallel/mesh.py.  The JAX package
runs `shard_map` over a `jax.sharding.Mesh`: one controller, one program
a chip, collectives between them.  The port keeps that single-controller
model without `torch.distributed`: a `Mesh` is a tuple of
`torch.device`s, one Python process enqueues the work of every shard,
each on a CUDA stream of its own (`Mesh.on`), before it waits on the
host, so the shards run at once as shard_map's do; an exchange is a
device-to-device copy, ordered by stream events (`Mesh.barrier`).
Repeats are allowed: D logical shards of one device run the sharded code
paths on a one-card machine (and on the CPU, in the tests, where the
shards run in turn), where a copy between two shards stays on the
device.

What is sharded, and where (each bit-identical to the unsharded run):

* step 2's count and step 3's flat count (`ops.kmer_engine
  .count_kmers_sharded`, `count_kmers_flat(mesh=)`): each shard kmerizes
  its reads or position chunks, every valid row goes to the shard that
  owns its `bucket_of` hash, and each owner sorts and collapses what it
  owns (JAX mesh.py:76-219);
* adjacency pruning and unitig links (`graph.build`): rows, or the
  oriented node space, in contiguous slices against a replica of the
  table on each device (:247-297);
* list ranking (`list_rank_sharded` here, :300-357);
* read pathing and step 3's flat pathing (`paths.pather`,
  `paths.flat_pather`): data-parallel against replicated tables
  (:360-413).
"""

from __future__ import annotations

import contextlib
import functools
import os
from dataclasses import dataclass

import torch

from ..device import resolve_device

M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class Mesh:
    """The devices of the shards, in shard order; a device may repeat."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @functools.cached_property
    def shard_streams(self) -> tuple:
        """A CUDA stream of its own for each CUDA shard (None for a CPU
        shard), made at first use: logical shards of one card run at once
        too."""
        return tuple(torch.cuda.Stream(device=d) if d.type == "cuda" else None
                     for d in self.devices)

    @contextlib.contextmanager
    def on(self, s: int):
        """Shard s's device and stream made current while the shard
        enqueues work: the hand-written kernels launch on the current
        stream.  The stream first waits for the device's current stream,
        so what the caller enqueued there (tables, dictionaries) is
        ready.  Nothing for a CPU shard."""
        stream = self.shard_streams[s]
        if stream is None:
            yield
            return
        with torch.cuda.device(self.devices[s]):
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                yield

    def barrier(self) -> None:
        """Every shard's stream waits for the work enqueued so far on every
        other's (before an exchange writes into buffers the owners
        allocated, and before the owners read what every source wrote)."""
        streams = [st for st in self.shard_streams if st is not None]
        marks = [st.record_event() for st in streams]
        for st in streams:
            for mark in marks:
                st.wait_event(mark)

    def join(self, *tensors: torch.Tensor) -> None:
        """The current stream of each device waits for the shard streams on
        it; `tensors`, made on shard streams, are marked as used on it so
        the caching allocator does not hand their memory on early."""
        for dev, st in zip(self.devices, self.shard_streams):
            if st is not None:
                torch.cuda.current_stream(dev).wait_stream(st)
        for t in tensors:
            if t.device.type == "cuda":
                t.record_stream(torch.cuda.current_stream(t.device))

    def slices(self, n: int) -> list[tuple[int, int]]:
        """Contiguous [lo, hi) slices of n rows, one a shard, each of
        ceil(n / size) rows but the last ones (which may be empty)."""
        per = -(-n // self.size)
        return [(min(s * per, n), min((s + 1) * per, n)) for s in range(self.size)]

    def replicate(self, t: torch.Tensor) -> list[torch.Tensor]:
        """t on each shard's device: one copy a distinct device (none
        where t already lies), listed a shard."""
        copies: dict[torch.device, torch.Tensor] = {}
        for dev in self.devices:
            if dev not in copies:
                copies[dev] = t.to(dev)
        return [copies[dev] for dev in self.devices]


def on(mesh: Mesh | None, s: int):
    """mesh.on(s), or nothing without a mesh (the unsharded caller's
    current device and stream)."""
    return mesh.on(s) if mesh is not None else contextlib.nullcontext()


def make_mesh(devices) -> Mesh:
    """A Mesh of `devices` (names or torch.devices), each resolved as
    `--device` is: cuda without a card raises, and so does a `cuda:j`
    with j >= torch.cuda.device_count().  `cuda` means the current card."""
    out = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda":
            idx = torch.cuda.current_device() if dev.index is None else dev.index
            if idx >= torch.cuda.device_count():
                raise RuntimeError(
                    f"device {str(d)!r}: only {torch.cuda.device_count()} CUDA "
                    "device(s) visible"
                )
            dev = torch.device("cuda", idx)
        out.append(dev)
    if not out:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(out))


def shard_request(shard_devices: int = -1) -> int:
    """The shard count asked for: W2RAP_SHARD when set, else the flag
    (-1 = every visible device, 0 = off, N = N devices)."""
    env = os.environ.get("W2RAP_SHARD")
    return int(env) if env is not None else int(shard_devices)


def visible_devices(device) -> int:
    """Devices a mesh on `device`'s type may use: the visible cards for
    cuda, 1 for cpu."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def auto_mesh(shard_devices: int = -1, device="cuda") -> Mesh | None:
    """The pipeline's mesh (JAX mesh.py:39-60): the shard count asked for
    (`shard_request`), clamped to the visible devices and rounded down to
    a power of two; None (unsharded) when that leaves one device or
    sharding is off."""
    asked = shard_request(shard_devices)
    if asked == 0:
        return None
    avail = visible_devices(device)
    want = avail if asked < 0 else min(asked, avail)
    if want <= 1:
        return None
    n = 1 << (want.bit_length() - 1)
    return make_mesh([f"cuda:{i}" for i in range(n)])


def quantize_octave(n: int, align: int, steps: int = 8) -> int:
    """n rounded up onto `steps` points a power of two, aligned to `align`
    (JAX kmer_engine.py:903)."""
    n = max(n, align)
    p = 1 << (n.bit_length() - 1)
    step = max(align, p // steps)
    return ((n + step - 1) // step) * step


def shard_chunk(chunk: int, n: int, mesh: Mesh, align: int = 1024) -> int:
    """A chunk of at most `chunk` positions, clamped to the octave-quantized
    load of one shard so that every shard gets work on small inputs (JAX
    flat_pather.py:128-135)."""
    return min(chunk, quantize_octave(max(1, -(-n // mesh.size)), align))


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 of int64 tensors holding u32 values, with no
    product past 2^49 (int64 never overflows)."""
    lo = h & 0xFFFF
    hi = h >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & M32


def bucket_of(w0: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Owning shard of each kmer: the Murmur-style finalizer of its word
    0 (JAX `_bucket_of`, mesh.py:63-73), modulo n_buckets.  w0 holds u32
    values (int64) or raw u32 bits (int32); returns int64."""
    h = w0.to(torch.int64) & M32
    h = _mul32(h ^ (h >> 16), 0x7FEB352D)
    h = _mul32(h ^ (h >> 15), 0x846CA68B)
    h = h ^ (h >> 16)
    return h % n_buckets


def list_rank_sharded(mesh: Mesh, nxt: torch.Tensor, n_iters: int):
    """Pointer-doubling list ranking (graph.build.list_rank) with the
    node rows in `mesh.slices` (JAX mesh.py:300-357): each shard jumps
    the pointers of its slice, and each round's gather reads the round's
    full ptr and dist arrays, of which every device holds a copy (the
    all-gather: each shard's new slice is copied into every device's next
    array; logical shards of one device share one).  The slices may be
    uneven or empty.

    Returns (head, rank, on_cycle), each (2M,), on nxt's device."""
    N2 = nxt.shape[0]
    M = N2 // 2
    slices = mesh.slices(N2)
    nxt_r = dict(zip(mesh.devices, mesh.replicate(nxt)))

    def prev_of(nxt_full, n):
        x = nxt_full[torch.where(n < M, n + M, n - M)]
        return torch.where(x >= 0, torch.where(x < M, x + M, x - M), -1)

    # the full ptr / dist arrays of the round, one a distinct device
    ptr = {dev: torch.empty(N2, dtype=torch.int64, device=dev) for dev in nxt_r}
    dist = {dev: torch.empty(N2, dtype=torch.int64, device=dev) for dev in nxt_r}

    def publish(full, lo, hi, part):
        for t in full.values():
            t[lo:hi].copy_(part, non_blocking=True)

    for dev, (lo, hi) in zip(mesh.devices, slices):
        n = torch.arange(lo, hi, device=dev)
        prev = prev_of(nxt_r[dev], n)
        publish(ptr, lo, hi, torch.where(prev >= 0, prev, n))
        publish(dist, lo, hi, (prev >= 0).to(torch.int64))
    for _ in range(n_iters):
        nptr = {dev: torch.empty_like(t) for dev, t in ptr.items()}
        ndist = {dev: torch.empty_like(t) for dev, t in dist.items()}
        for dev, (lo, hi) in zip(mesh.devices, slices):
            p = ptr[dev][lo:hi]
            publish(ndist, lo, hi, dist[dev][lo:hi] + dist[dev][p])
            publish(nptr, lo, hi, ptr[dev][p])
        ptr, dist = nptr, ndist
    head = ptr[nxt.device] if nxt.device in ptr else ptr[mesh.devices[0]].to(nxt.device)
    rank = dist[nxt.device] if nxt.device in dist else dist[mesh.devices[0]].to(nxt.device)
    # on a cycle the final pointer still has a predecessor
    on_cycle = prev_of(nxt, head) >= 0
    return head, rank, on_cycle

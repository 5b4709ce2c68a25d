"""K0 (csrc/pack.cu) checked and timed on one GPU, and the count's chunk
stream through it against the host pack and K0's plain version, in
turns, in one process.

    python3 scripts/pack_ab.py [--reads 1114000] [--rounds 3]

Runs chip_smoke.py's K0 check (`check_pack`: bit for bit against its
plain version and `pack_and_glen_host` on one chunk of the count's shape,
65,536 reads of 250 bases; its time against its bound, over chunks that
L2 cannot hold; registers and spills).  Times on the host clock, medians
of 5, one chunk's host pack, its pageable upload of the packed rows (the
host route's) and of the raw codes, qualities and lengths (the card
route's).  Times K1 on one chunk's packed rows (CUDA events, medians of
--k1-reps, the host's launch kept out) just after K0 wrote them, just
after their pageable upload, and after a 256 MB write that evicts them
from L2.  Then runs --reads
reads (E. coli's 1,114,000 by default) through the chunk stream and K1,
as the count's `.kmerize` span does, by three routes in turns (host,
card, plain, plain, card, host) over --rounds turns: `host` is the
worker's pack_and_glen_host then the upload of the packed rows, `card`
is `kmer_engine._device_chunks` on the card (the raw upload, then K0),
`plain` is the same with K0's plain version (`pack_glen_plain`) in K0's
place.  Every chunk of every route is compared.  Prints each route's
walls, host CPU seconds of the process and peak device memory above the
pass's start (medians), the K0 launches a pass, and the card's name and
power limit last.  Exits non-zero on any mismatch.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from w2rap_contigger_tpu_torch import device as tdev  # noqa: E402
from w2rap_contigger_tpu_torch.ops import kmer_engine as tke  # noqa: E402
from w2rap_contigger_tpu_torch.ops import kmerize as kkm  # noqa: E402

CHUNK = 65536
L = 250
MIN_QUAL = 7
K = 60


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock ms of fn() (which synchronises), after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def host_route(bases, lengths, quals, dev):
    """The chunk stream as the host pack gives it: the worker packs each
    chunk (pack_and_glen_host) and uploads the packed rows."""
    n = bases.shape[0]

    def host_chunk(start):
        stop = min(start + CHUNK, n)
        pr, glen = kkm.pack_and_glen_host(bases[start:stop], quals[start:stop],
                                          lengths[start:stop], K, MIN_QUAL)
        return pr.view(np.int32), glen

    return tke._prefetched(host_chunk, range(0, n, CHUNK), dev)


def card_route(bases, lengths, quals, dev):
    return tke._device_chunks(bases, lengths, quals, K, MIN_QUAL, CHUNK, dev)


def plain_route(bases, lengths, quals, dev):
    """The card route with K0's plain version in K0's place: the worker
    uploads each raw chunk, and pack_glen_plain packs it on the current
    stream."""
    n = bases.shape[0]

    def raw_chunk(start):
        stop = min(start + CHUNK, n)
        return (bases[start:stop], quals[start:stop],
                np.asarray(lengths[start:stop], dtype=np.int32))

    stream = torch.cuda.current_stream(dev)
    for raw in tke._prefetched(raw_chunk, range(0, n, CHUNK), dev, stream):
        yield kkm.pack_glen_plain(*raw, K, MIN_QUAL)


def one_pass(route, bases, lengths, quals, dev, keep: list | None):
    """(wall seconds, host CPU seconds, peak device bytes above the
    start) of K1 over every chunk of `route`, to the last chunk's end on
    the card; the chunks appended to keep, if given."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0, c0 = time.perf_counter(), time.process_time()
    for pr, glen in route(bases, lengths, quals, dev):
        x = kkm.kmerize(pr, glen, K, L)
        del x
        if keep is not None:
            keep.append((pr, glen))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0, time.process_time() - c0,
            torch.cuda.max_memory_allocated(dev) - base)


def k1_after(dev, reps: int):
    """Median device ms of K1 on one chunk's packed rows just after K0
    wrote them, just after their pageable upload (the host route), and
    after a 256 MB write that leaves none of them in L2.  A sleep on the
    card between the two keeps the host's launch of K1 out of the time
    and touches no memory."""
    bases, lengths, quals = cs._reads(np.random.default_rng(7), CHUNK, L)
    raw = [torch.from_numpy(a).to(dev) for a in (bases, quals, lengths)]
    pr_h, gl_h = kkm.pack_and_glen_host(bases, quals, lengths, K, MIN_QUAL)
    pr_h = pr_h.view(np.int32)
    kept = kkm.pack_glen(*raw, K, MIN_QUAL)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def evicted():
        flush.fill_(1)
        return kept

    before = {
        "k0": lambda: kkm.pack_glen(*raw, K, MIN_QUAL),
        "upload": lambda: (torch.from_numpy(pr_h).to(dev), torch.from_numpy(gl_h).to(dev)),
        "evicted": evicted,
    }
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    times = {name: [] for name in before}
    for r in range(reps + 1):
        for name, fn in before.items():
            pr, glen = fn()
            torch.cuda._sleep(1_000_000)
            e0.record()
            x = kkm.kmerize(pr, glen, K, L)
            e1.record()
            torch.cuda.synchronize()
            if r:  # the first turn warms up
                times[name].append(e0.elapsed_time(e1))
            del x
    return {name: statistics.median(t) for name, t in times.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=1114000)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--k1-reps", type=int, default=50)
    args = ap.parse_args()
    card = cs.phase_probe()
    cs.phase_build()
    dev = torch.device("cuda")
    cs.check_pack()

    bases, lengths, quals = cs._reads(np.random.default_rng(11), CHUNK, L)
    packed = kkm.pack_and_glen_host(bases, quals, lengths, K, MIN_QUAL)

    def upload(arrays):
        for a in arrays:
            torch.from_numpy(a).to(dev)
        torch.cuda.synchronize()

    pack_ms = host_ms(lambda: kkm.pack_and_glen_host(bases, quals, lengths, K, MIN_QUAL))
    cs.say("host", reads=CHUNK, pack_ms=f"{pack_ms:.3f}",
           packed_upload_ms=f"{host_ms(lambda: upload(packed)):.3f}",
           raw_upload_ms=f"{host_ms(lambda: upload((bases, quals, lengths))):.3f}")

    cs.say("k1_after", reps=args.k1_reps,
           **{f"{name}_ms": f"{ms:.4f}" for name, ms in k1_after(dev, args.k1_reps).items()})

    bases, lengths, quals = cs._reads(np.random.default_rng(5), args.reads, L)
    routes = {"host": host_route, "card": card_route, "plain": plain_route}
    want = []
    one_pass(host_route, bases, lengths, quals, dev, want)
    launches = {}
    for name in ("card", "plain"):
        got = []
        tdev.reset_launches()
        one_pass(routes[name], bases, lengths, quals, dev, got)
        launches[name] = tdev.LAUNCHES["pack"]
        if len(got) != len(want) or not all(
                torch.equal(a, c) and torch.equal(b_, d)
                for (a, b_), (c, d) in zip(got, want)):
            cs.fail(f"the {name} route's chunks differ from the host route's")
        del got
    del want
    runs = {name: [] for name in routes}
    for _ in range(args.rounds):
        for name in ["host", "card", "plain", "plain", "card", "host"]:
            runs[name].append(one_pass(routes[name], bases, lengths, quals, dev, None))
    for name, r in runs.items():
        walls, cpu, peak = zip(*r)
        cs.say("stream", route=name, reads=args.reads, chunks=-(-args.reads // CHUNK),
               median_s=f"{statistics.median(walls):.4f}",
               walls=",".join(f"{x:.4f}" for x in walls),
               cpu_s=f"{statistics.median(cpu):.4f}", peak_bytes=int(statistics.median(peak)),
               pack_launches=launches.get(name, 0))
    print(card, flush=True)


if __name__ == "__main__":
    main()

"""Pipeline driver of the port: steps 1 and 2 with the JAX package's
checkpoints.

Counterpart of w2rap_contigger_tpu/pipeline/driver.py:52-247.  Step 1
is the shared host `extract_reads`; step 2 runs on `device` through
this package.  Later steps are not ported yet and raise.  Outputs have
the JAX package's names and formats: frag_reads_orig.npz,
small_K.freqs, <p>.small_K.hbv.npz / .paths.npz and <p>.perf.
"""

from __future__ import annotations

import os
import time

from ..device import resolve_device
from ..shared import ReadSet, extract_reads, sysinfo
from . import step2_small_k

LAST_PORTED_STEP = 2


class PerfLog:
    """`TIME, <section>, <wall s>, <cpu s>` lines (checkpoint_perf_time,
    w2rap-contigger.cc:32-46)."""

    def __init__(self, path=None):
        self.path = path
        self.t0 = time.time()
        self.c0 = time.process_time()
        if path:
            with open(path, "w") as f:
                f.write("")

    def checkpoint(self, section: str):
        t1, c1 = time.time(), time.process_time()
        line = f"TIME, {section}, {t1 - self.t0:.2f}, {c1 - self.c0:.2f}"
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        self.t0, self.c0 = t1, c1
        return line


def run_pipeline(
    out_dir: str,
    read_spec: str | None = None,
    reads: ReadSet | None = None,
    prefix: str = "pe",
    from_step: int = 1,
    to_step: int = 2,
    min_freq: int = 4,
    min_qual: int = 7,
    dump_all: bool = False,
    dump_perf: bool = False,
    chunk_reads: int = 65536,
    threads: int = 4,
    max_mem_gb: int = 10000,
    disk_batches: int = 0,
    tmp_dir: str | None = None,
    fill_join: bool = False,
    device="cuda",
):
    """Run steps from_step..to_step (1..2) on `device`; returns (hbv,
    paths, dict) of step 2, or Nones when step 2 did not run."""
    if to_step > LAST_PORTED_STEP or from_step > LAST_PORTED_STEP:
        raise NotImplementedError(
            f"steps {LAST_PORTED_STEP + 1}-7 are not ported yet "
            f"(from_step={from_step}, to_step={to_step}); see ROADMAP.md"
        )
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    perf = PerfLog(f"{out_dir}/{prefix}.perf" if dump_perf else None)
    p = f"{out_dir}/{prefix}"
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, str(threads))
    sysinfo.set_max_memory(int(max_mem_gb) << 30)

    hbv = paths = d = None
    if from_step <= 1 <= to_step:
        if reads is None:
            if not read_spec:
                raise ValueError("step 1 needs read files (-r)")
            reads = extract_reads(read_spec)
        reads.save(f"{out_dir}/frag_reads_orig.npz")
        print(f"peak mem usage = {sysinfo.peak_mem_usage_gb_string()} GB")
        perf.checkpoint("ReadLoad")

    if from_step <= 2 <= to_step:
        if reads is None:
            reads = ReadSet.load(f"{out_dir}/frag_reads_orig.npz")
        hbv, paths, d = step2_small_k.build_read_q_graph(
            reads,
            min_qual=min_qual,
            min_freq=min_freq,
            workdir=out_dir,
            chunk_reads=chunk_reads,
            disk_batches=disk_batches,
            tmp_dir=tmp_dir,
            max_mem_gb=max_mem_gb,
            do_fill_gaps=fill_join,
            do_join_overlaps=fill_join,
            device=dev,
        )
        if dump_all or to_step == 2:
            hbv.save(f"{p}.small_K.hbv.npz")
            paths.save(f"{p}.small_K.paths.npz")
        perf.checkpoint("SmallKGraph")

    if sysinfo.timelog_enabled():
        rep = sysinfo.timelog_report()
        if rep:
            print(rep)
    return hbv, paths, d

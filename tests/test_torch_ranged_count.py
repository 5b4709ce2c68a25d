"""The range path of step 2's count (ops.kmer_engine.count_kmers_batched
under -d/-m) on reads made as the A. fumigatus Af293 deployment makes
them (benchmark/data.py, cut to a 200 kb genome and 4,000 PE250 reads),
against the benchmark's plain reference (benchmark/reference/count.py):
the dictionary row by row and the 101-bin histogram, exactly.  Also the
range path's counter (device.RANGED) against the reference's own windows
split by hash range, and its spans (step2.count.range.*), which the
unbatched count leaves alone as the range path leaves the unbatched
count's spans alone."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import data
from benchmark.entries import rows_off
from benchmark.reference import count as ref_count
from w2rap_contigger_tpu_torch import device as tdev
from w2rap_contigger_tpu_torch.ops import kmer_engine as tke
from w2rap_contigger_tpu_torch.utils import sysinfo
from _torch_guards import time_limited  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANGE_SPANS = {f"step2.count.range.{s}" for s in ("pack", "sizes", "kmerize", "sort",
                                                  "collapse")}
UNBATCHED_SPANS = {f"step2.count.{s}" for s in ("kmerize", "sort", "collapse")}


@pytest.fixture(scope="module")
def case():
    """The deployment's reads at a test's size, and the reference's count
    of them with its valid windows split into 2 and 4 hash ranges."""
    with open(os.path.join(ROOT, "benchmark", "configs", "afumigatus_af293_pe250.json")) as f:
        cfg = json.load(f)
    cfg["genome"]["genome_len"] = 200_000
    cfg["genome"]["repeats"][0]["copies"] = 3
    cfg["reads"]["pairs"] = 2_000
    cfg["assembly"]["chunk_reads"] = 1024
    reads = data.make_reads(cfg, 2**31 + 18, "cpu")
    a = cfg["assembly"]
    bases, lengths, quals = reads
    ref = ref_count.count(bases, quals, lengths, int(a["k"]), int(a["min_qual"]),
                          int(a["min_freq"]))
    hi = torch.cat([ref_count.block_windows(torch.as_tensor(bases[i : i + 4096]),
                                            torch.as_tensor(quals[i : i + 4096]),
                                            torch.as_tensor(lengths[i : i + 4096]),
                                            int(a["k"]), int(a["min_qual"]))[0]
                    for i in range(0, bases.shape[0], 4096)])
    # hi is word 0 and 1 less 2**63: its top bits, shifted up, are the range
    per_range = {R: torch.bincount((hi >> (64 - rb)) + R // 2, minlength=R).tolist()
                 for R, rb in ((2, 1), (4, 2))}
    return cfg, reads, ref, per_range


def _count(cfg, reads, disk_batches, monkeypatch):
    monkeypatch.setenv("W2RAP_TIMELOG", "1")
    monkeypatch.setenv("W2RAP_SORT", cfg["assembly"]["sort"])
    sysinfo.timelog_reset()
    tdev.reset_launches()
    a = cfg["assembly"]
    d, hist = tke.count_kmers_batched(
        *reads, int(a["k"]), min_qual=int(a["min_qual"]), min_freq=int(a["min_freq"]),
        chunk_reads=int(a["chunk_reads"]), disk_batches=disk_batches, tmp_dir=None,
        max_mem_gb=int(a["max_mem_gb"]), device="cpu")
    spans = {line.split(",")[1].strip() for line in sysinfo.timelog_report().splitlines()}
    return d, hist, spans


def _off(d, hist, ref):
    hi, lo = ref_count.keys_of_words(d.words)
    rows = rows_off([hi, lo, d.cnt, d.ctx], [ref["hi"], ref["lo"], ref["count"], ref["ctx"]])
    return rows, int(np.abs(np.asarray(hist, dtype=np.int64) - ref["hist"].numpy()).sum())


@pytest.mark.parametrize("ranges", [2, 4])
def test_ranged_count_matches_the_reference(case, monkeypatch, ranges):
    """-d 2 and -d 4 on the deployment's reads: 0 rows and 0 bins off;
    RANGED counts one count of `ranges` ranges whose rows are the
    reference's valid windows, the largest as the reference splits them;
    the range path's spans appear and the unbatched count's do not."""
    cfg, reads, ref, per_range = case
    d, hist, spans = _count(cfg, reads, ranges, monkeypatch)
    assert _off(d, hist, ref) == (0, 0)
    assert d.size == ref["hi"].numel() > 0
    assert tdev.RANGED == {"counts": 1, "ranges": ranges,
                           "range_rows_max": max(per_range[ranges]),
                           "range_rows": ref["windows"]}
    assert sum(per_range[ranges]) == ref["windows"]
    assert RANGE_SPANS <= spans and not spans & UNBATCHED_SPANS


def test_unbatched_count_leaves_the_range_path_alone(case, monkeypatch):
    """The same reads at the configuration's -m 72 fit unbatched at this
    size: the same dictionary, RANGED untouched, the unbatched spans and
    none of the range path's."""
    cfg, reads, ref, _ = case
    d, hist, spans = _count(cfg, reads, 0, monkeypatch)
    assert _off(d, hist, ref) == (0, 0)
    assert tdev.RANGED == {"counts": 0, "ranges": 0, "range_rows_max": 0, "range_rows": 0}
    assert UNBATCHED_SPANS <= spans and not spans & RANGE_SPANS


# the deployment's ranges at 2 bits as measured on the card (seed
# 2147483712): 728,121,715 and 242,711,597 valid rows; 7,056,000 reads
# packed in 479,808,000 bytes
AF293_RANGES = (728_121_715, 242_711_597)
AF293_PACKED = 479_808_000


@pytest.mark.parametrize("max_mem_gb,bits", [(79, 1), (72, 1), (70, 2), (64, 2)])
def test_budget_bounds_the_largest_range(max_mem_gb, bits):
    """The range path's budget at the deployment's measured sizes: the
    larger half's rows at range_row_bytes (4% over the 101.0 B a row
    measured) fit beside the packed reads at -m 72, the configuration's
    own, and need a third range bit below about -m 71; whatever ranges
    are taken, the largest fits at the measured rate."""
    fine = [r // 128 for r in AF293_RANGES for _ in range(128)]
    room = max_mem_gb * float(1 << 30) - AF293_PACKED
    got = tke.ceiling_range_bits(fine, 1, room, tke.range_row_bytes(4))
    assert got == bits
    assert max(tke.ranges_at(fine, got)) * 101.0 <= room

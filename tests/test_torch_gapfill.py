"""--fill_join: the port's graph/gapfill.py (fill_gaps, join_overlaps; the
read pathing on the dictionary's device, here the CPU) against the JAX
package's on the graphs of tests/test_gapfill.py, each case asserting
that the pass changed the graph; and the port's CLI `--fill_join
--to_step 2` against the JAX package's on a low-coverage genome.
Dictionary words, counts, ctx, edges, small_K.freqs and the small_K
checkpoints: exact equality."""

import os
import subprocess
import sys

import numpy as np
import pytest

from w2rap_contigger_tpu.core.reads import ReadSet
from w2rap_contigger_tpu.graph import build as jgb
from w2rap_contigger_tpu.graph import gapfill as jgf
from w2rap_contigger_tpu.ops import kmer_engine as ke
from w2rap_contigger_tpu.pipeline.driver import run_pipeline
from w2rap_contigger_tpu_torch import __main__ as cli
from w2rap_contigger_tpu_torch import state
from w2rap_contigger_tpu_torch.graph import build as tgb
from w2rap_contigger_tpu_torch.graph import gapfill as tgf
from w2rap_contigger_tpu_torch.ops import kmer_engine as tke
from _torch_guards import time_limited  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 32


def _reads(genome, spans, rc_spans=()):
    """spans: (start, stop, copies); rc_spans the same, reverse-complemented."""
    seqs = [genome[s:e] for s, e, c in spans for _ in range(c)]
    seqs += [(3 - genome[s:e][::-1]).astype(np.uint8)
             for s, e, c in rc_spans for _ in range(c)]
    return ReadSet.from_sequences(seqs, [np.full(len(x), 35, np.uint8) for x in seqs])


def _graphs(reads):
    """Both packages' dictionary and unitig edges of the reads (min_freq 4),
    held equal before any repair pass."""
    jd, _ = ke.count_kmers(reads.bases, reads.lengths, reads.quals, K, min_qual=7,
                           min_freq=4, chunk_reads=1024)
    jgb.recompute_adjacencies(jd)
    jeb, jes = jgb.build_unitigs(jd)
    td, _ = tke.count_kmers_device(reads.bases, reads.lengths, reads.quals, K,
                                   min_qual=7, min_freq=4, device="cpu")
    tgb.recompute_adjacencies(td)
    teb, tes = tgb.build_unitigs(td)
    _same(jd, jeb, jes, td, teb, tes)
    return (jd, jeb, jes), (td, teb, tes)


def _same(jd, jeb, jes, td, teb, tes):
    words, counts, ctx = state.dict_to_numpy(td)
    np.testing.assert_array_equal(words, jd.words)
    np.testing.assert_array_equal(counts, jd.counts)
    np.testing.assert_array_equal(ctx, jd.ctx)
    np.testing.assert_array_equal(tes, jes)
    np.testing.assert_array_equal(teb, jeb)


# name -> (pass, genome seed, spans, rc spans, max_gap_size): the
# changing cases of tests/test_gapfill.py
CASES = {
    # the middle only from 3 spanning copies (< min_freq 4, >= min_freq2 3)
    "fill_low_coverage_span": ("fill", 11, [(0, 150, 6), (170, 300, 6), (100, 250, 3)],
                               [], 0),
    # missing kmer starts 129..139 (<= K/2): the flanks overlap by 20 bases
    "join_small_gap": ("join", 12, [(0, 160, 6), (140, 300, 6), (100, 200, 3)], [], K // 2),
    # the same junction from reverse-complemented spanning reads (the
    # canonical join orientation's swap branch)
    "join_small_gap_rc": ("join", 13, [(0, 160, 6), (140, 300, 6)], [(100, 200, 3)],
                          K // 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gapfill_pass_matches_jax(case):
    kind, seed, spans, rc_spans, max_gap = CASES[case]
    genome = np.random.default_rng(seed).integers(0, 4, size=300).astype(np.uint8)
    reads = _reads(genome, spans, rc_spans)
    (jd, jeb, jes), (td, teb, tes) = _graphs(reads)
    jfn, tfn = {"fill": (jgf.fill_gaps, tgf.fill_gaps),
                "join": (jgf.join_overlaps, tgf.join_overlaps)}[kind]
    jd2, jeb2, jes2 = jfn(reads, jd, jeb, jes, max_gap, 3)
    td2, teb2, tes2 = tfn(reads, td, teb, tes, max_gap, 3)
    _same(jd2, jeb2, jes2, td2, teb2, tes2)
    # the pass changed the graph: one edge spans the genome now
    assert td2.size > td.size and len(tes) - 1 == 2 and len(tes2) - 1 == 1
    seq = teb2[tes2[0] : tes2[1]]
    assert np.array_equal(seq, genome) or np.array_equal((3 - seq[::-1]), genome)
    assert td2.kdef is not None and td2.edge_id is not None


def test_gapfill_cli_matches_jax(tmp_path):
    """Both CLIs to step 2 with --fill_join on a low-coverage genome (6x:
    the small-K graph has captured gaps), against each other and against
    the port's run without it, which must differ."""
    data = str(tmp_path / "synth")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "make_synth_fastq.py"), data,
         "--glen", "20000", "--pairs", "250", "--rlen", "250", "--insert", "500",
         "--seed", "11"],
        check=True, capture_output=True, timeout=300,
    )
    fastq = f"{data}/reads_R1.fastq,{data}/reads_R2.fastq"
    jdir, tdir, plain = (str(tmp_path / x) for x in ("jax", "port", "plain"))
    run_pipeline(out_dir=jdir, read_spec=fastq, to_step=2, shard_devices=0,
                 fill_join=True)
    cli.main(["-r", fastq, "-o", tdir, "--to_step", "2", "--device", "cpu", "--fill_join"])
    cli.main(["-r", fastq, "-o", plain, "--to_step", "2", "--device", "cpu"])
    with open(f"{jdir}/small_K.freqs", "rb") as a, open(f"{tdir}/small_K.freqs", "rb") as b:
        assert a.read() == b.read()
    changed = False
    for name in ("pe.small_K.hbv.npz", "pe.small_K.paths.npz"):
        za, zb, zc = (np.load(f"{d}/{name}") for d in (jdir, tdir, plain))
        assert sorted(za.files) == sorted(zb.files)
        for key in za.files:
            np.testing.assert_array_equal(zb[key], za[key], err_msg=f"{name}:{key}")
            changed |= zb[key].shape != zc[key].shape or not np.array_equal(zb[key], zc[key])
    assert changed

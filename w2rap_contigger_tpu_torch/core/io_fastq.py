"""FASTQ/FASTA read loading — step 1 (ExtractReads equivalent).

Reference: src/paths/long/large/ExtractReads.cc:45-688 — globs paired
fastq(.gz)/BAM/fastb inputs, validates pairing, converts N->A, and writes
frag_reads_orig.fastb/.qualp.  Here: the native fastq(.gz) loader
(:mod:`.native_io`, native/fastq_loader.cc) producing a dense ReadSet;
pairs are interleaved (read 2i, 2i+1), same as the reference's
PairsManager convention.

BAM input goes through :mod:`.io_bam` (BGZF parser, parity with
src/bam/ReadBAM.cc) and feudal .fastb[/.qualb/.qualp] checkpoints through
:mod:`.feudal`, matching the reference's accepted input kinds
(ExtractReads.cc:205-266).
"""

from __future__ import annotations

import os

import numpy as np

from .native_io import load_fastq_readset
from .reads import ReadSet


def _subsample_pairs(rs: ReadSet, frac: float, seed: int) -> ReadSet:
    if frac >= 1.0:
        return rs
    rng = np.random.default_rng(seed)
    keep = rng.random(rs.n_reads // 2) < frac
    idx = np.flatnonzero(np.repeat(keep, 2))
    return ReadSet(rs.bases[idx], rs.lengths[idx], rs.quals[idx])


def _codes_to_readset(code_list, qual_list) -> ReadSet:
    n = len(code_list)
    lens = np.array([len(s) for s in code_list], dtype=np.int32)
    lmax = int(lens.max()) if n else 0
    bases = np.zeros((n, lmax), dtype=np.uint8)
    quals = np.zeros((n, lmax), dtype=np.uint8)
    for i, s in enumerate(code_list):
        bases[i, : lens[i]] = s
        quals[i, : lens[i]] = qual_list[i] if qual_list is not None else 40
    return ReadSet(bases, lens, quals)


def load_bam_readset(path: str) -> ReadSet:
    """BAM input: pair records by name (.1/.2 suffixes), interleave.

    Reference keeps BAM records in file order and pairs via
    ReadNameLookup; here names are matched directly
    (ExtractReads.cc:205-233, ReadBAM.cc:436-563)."""
    from .io_bam import read_bam

    recs = read_bam(path)
    firsts = {n[:-2]: (c, q) for n, c, q in recs if n.endswith(".1")}
    codes, quals = [], []
    for n, c, q in recs:
        if n.endswith(".2") and n[:-2] in firsts:
            c1, q1 = firsts.pop(n[:-2])
            codes += [c1, c]
            quals += [q1, q]
    return _codes_to_readset(codes, quals)


def load_feudal_readset(fastb_path: str) -> ReadSet:
    """Feudal checkpoint input: .fastb plus sibling .qualp or .qualb."""
    from . import feudal

    codes = feudal.read_fastb(fastb_path)
    stem = fastb_path[: -len(".fastb")]
    if os.path.exists(stem + ".qualp"):
        quals = feudal.read_qualp(stem + ".qualp")
    elif os.path.exists(stem + ".qualb"):
        quals = feudal.read_qualb(stem + ".qualb")
    else:
        quals = None
    return _codes_to_readset(codes, quals)


def extract_reads(read_spec: str, frac: float = 1.0, seed: int = 42) -> ReadSet:
    """ExtractReads equivalent: read_spec is 'r1.fastq,r2.fastq' (paired)
    or a single (possibly interleaved) fastq; .gz supported.  Pairs are
    interleaved in the output.  frac subsamples pairs (reference's
    `frac` option, ExtractReads.cc).  .bam and .fastb specs dispatch to
    the BGZF/feudal readers."""
    files = [f.strip() for f in read_spec.split(",") if f.strip()]
    for f in files:
        if not os.path.exists(f):
            raise FileNotFoundError(f)
    if len(files) == 1 and files[0].endswith(".bam"):
        rs = load_bam_readset(files[0])
        return _subsample_pairs(rs, frac, seed)
    if len(files) == 1 and files[0].endswith(".fastb"):
        rs = load_feudal_readset(files[0])
        return _subsample_pairs(rs, frac, seed)
    if len(files) == 2:
        r1, r2 = (load_fastq_readset(f) for f in files)
        if r1.n_reads != r2.n_reads:
            raise ValueError(f"R1/R2 read counts differ ({r1.n_reads} and {r2.n_reads})")
        lmax = max(r1.max_len, r2.max_len)
        n = r1.n_reads + r2.n_reads
        bases = np.zeros((n, lmax), dtype=np.uint8)
        quals = np.zeros((n, lmax), dtype=np.uint8)
        lengths = np.empty(n, dtype=np.int32)
        bases[0::2, :r1.max_len] = r1.bases
        bases[1::2, :r2.max_len] = r2.bases
        quals[0::2, :r1.max_len] = r1.quals
        quals[1::2, :r2.max_len] = r2.quals
        lengths[0::2] = r1.lengths
        lengths[1::2] = r2.lengths
        rs = ReadSet(bases, lengths, quals)
    elif len(files) == 1:
        rs = load_fastq_readset(files[0])
    else:
        raise ValueError("read_spec must name 1 interleaved or 2 paired files")
    return _subsample_pairs(rs, frac, seed)

"""FASTQ/FASTA read loading — step 1 (ExtractReads equivalent).

Reference: src/paths/long/large/ExtractReads.cc:45-688 — globs paired
fastq(.gz)/BAM/fastb inputs, validates pairing, converts N->A, and writes
frag_reads_orig.fastb/.qualp.  Here: a numpy-vectorized fastq(.gz) parser
producing a dense ReadSet; pairs are interleaved (read 2i, 2i+1), same as
the reference's PairsManager convention.

BAM input goes through :mod:`.io_bam` (BGZF parser, parity with
src/bam/ReadBAM.cc) and feudal .fastb[/.qualb/.qualp] checkpoints through
:mod:`.feudal`, matching the reference's accepted input kinds
(ExtractReads.cc:205-266).
"""

from __future__ import annotations

import gzip
import os

import numpy as np

from .dna import ASCII_TO_CODE
from .reads import ReadSet


def _read_bytes(path: str) -> bytes:
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def parse_fastq_bytes(data: bytes):
    """Parse fastq bytes -> (list_of_seq_bytes, list_of_qual_bytes).

    Vectorized: newline positions via numpy, record lines = 4-periodic.
    """
    buf = np.frombuffer(data, dtype=np.uint8)
    if len(buf) == 0:
        return [], []
    nl = np.flatnonzero(buf == ord("\n"))
    # line start/end offsets (handle missing trailing newline)
    starts = np.concatenate([[0], nl + 1])
    ends = np.concatenate([nl, [len(buf)]])
    if starts[-1] >= len(buf):
        starts = starts[:-1]
        ends = ends[:-1]
    n_lines = len(starts)
    n_rec = n_lines // 4
    seqs = []
    quals = []
    for i in range(n_rec):
        s0, e0 = starts[4 * i], ends[4 * i]
        assert buf[s0] == ord("@"), f"bad fastq record at line {4*i}"
        seqs.append(data[starts[4 * i + 1] : ends[4 * i + 1]])
        quals.append(data[starts[4 * i + 3] : ends[4 * i + 3]])
    return seqs, quals


def load_fastq(path: str):
    return parse_fastq_bytes(_read_bytes(path))


def parse_fasta_bytes(data: bytes):
    seqs = []
    cur = []
    for line in data.split(b"\n"):
        if line.startswith(b">"):
            if cur:
                seqs.append(b"".join(cur))
                cur = []
        elif line:
            cur.append(line.strip())
    if cur:
        seqs.append(b"".join(cur))
    return seqs


def to_readset(seq_bytes_list, qual_bytes_list=None, qual_offset=33) -> ReadSet:
    """Pack byte strings into a dense ReadSet (N->A, phred decode)."""
    n = len(seq_bytes_list)
    lens = np.array([len(s) for s in seq_bytes_list], dtype=np.int32)
    lmax = int(lens.max()) if n else 0
    bases = np.zeros((n, lmax), dtype=np.uint8)
    quals = np.zeros((n, lmax), dtype=np.uint8)
    for i, s in enumerate(seq_bytes_list):
        bases[i, : lens[i]] = ASCII_TO_CODE[np.frombuffer(s, dtype=np.uint8)]
        if qual_bytes_list is not None:
            q = np.frombuffer(qual_bytes_list[i], dtype=np.uint8)
            quals[i, : lens[i]] = q - qual_offset
        else:
            quals[i, : lens[i]] = 40
    return ReadSet(bases, lens, quals)


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
    if os.environ.get("W2RAP_NATIVE", "1") != "0":
        from .native_io import load_fastq_readset

        sets = [load_fastq_readset(f) for f in files]
        if all(s is not None for s in sets):
            if len(sets) == 2:
                r1, r2 = sets
                assert r1.n_reads == r2.n_reads, "R1/R2 read counts differ"
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
            else:
                rs = sets[0]
            return _subsample_pairs(rs, frac, seed)
    if len(files) == 2:
        s1, q1 = load_fastq(files[0])
        s2, q2 = load_fastq(files[1])
        assert len(s1) == len(s2), "R1/R2 read counts differ"
        seqs = [x for pair in zip(s1, s2) for x in pair]
        quals = [x for pair in zip(q1, q2) for x in pair]
    elif len(files) == 1:
        seqs, quals = load_fastq(files[0])
    else:
        raise ValueError("read_spec must name 1 interleaved or 2 paired files")
    if frac < 1.0:
        rng = np.random.default_rng(seed)
        n_pairs = len(seqs) // 2
        keep = rng.random(n_pairs) < frac
        seqs = [
            s
            for p in np.flatnonzero(keep)
            for s in (seqs[2 * p], seqs[2 * p + 1])
        ]
        quals = [
            q
            for p in np.flatnonzero(keep)
            for q in (quals[2 * p], quals[2 * p + 1])
        ]
    return to_readset(seqs, quals)

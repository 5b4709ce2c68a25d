"""Self-contained BGZF + BAM reader (no htslib), mirroring the
reference's own zlib-only parser (``src/bam/ReadBAM.{h,cc}``):

* BGZF: a BAM file is a series of gzip members whose FEXTRA field
  carries a ``BC`` subfield with the compressed block size
  (``ReadBAM.cc:35-91``); decompressing and concatenating the members
  yields the BAM byte stream.
* BAM records: magic ``BAM\\1`` (``ReadBAM.cc:404`` checks
  0x014d4142), header text + reference dictionary are skipped, then
  fixed 32-byte alignment heads (``ReadBAM.cc:94-124``).
* Record handling parity (``ReadBAM.cc:436-563``): secondary /
  supplementary alignments (flags & 0x900) are skipped, optional
  PF-only filtering (flag 0x200), read names get ``.1``/``.2``/``.3``
  suffixes by segment flags, an ``OQ:Z`` aux tag overrides the quality
  string (phred+33), and reverse-strand records are
  reverse-complemented. Ambiguous seq nibbles map to the first base of
  the IUPAC set (the reference picks a random member, ``:482``).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

FLAG_REVERSED = 0x10
FLAG_FIRST_SEGMENT = 0x40
FLAG_LAST_SEGMENT = 0x80
FLAG_PF = 0x200
FLAG_SECONDARY = 0x900

# 4-bit BAM seq codes: =ACMGRSVTWYHKDBN; map each IUPAC set to its first
# ACGT member as code 0..3 (A=0 C=1 G=2 T=3)
_NIBBLE_TO_CODE = np.zeros(16, dtype=np.uint8)
for _i, _sym in enumerate("=ACMGRSVTWYHKDBN"):
    _first = {"=": "A", "A": "A", "C": "C", "M": "A", "G": "G", "R": "A",
              "S": "C", "V": "A", "T": "T", "W": "A", "Y": "C", "H": "A",
              "K": "G", "D": "A", "B": "C", "N": "A"}[_sym]
    _NIBBLE_TO_CODE[_i] = "ACGT".index(_first)

_TAG_LEN = {b"A": 1, b"c": 1, b"C": 1, b"s": 2, b"S": 2, b"i": 4, b"I": 4,
            b"f": 4, b"Z": 0, b"H": 0, b"B": 0}


def bgzf_decompress(data: bytes) -> bytes:
    """Decompress a BGZF byte string (series of gzip members)."""
    out = []
    pos = 0
    n = len(data)
    while pos < n:
        if data[pos:pos + 2] != b"\x1f\x8b":
            raise ValueError("bad BGZF block magic")
        flg = data[pos + 3]
        if not flg & 0x04:
            raise ValueError("BGZF block missing FEXTRA")
        xlen = struct.unpack_from("<H", data, pos + 10)[0]
        # find the BC subfield for the block size
        xpos, xend = pos + 12, pos + 12 + xlen
        bsize = None
        while xpos < xend:
            si1, si2, slen = data[xpos], data[xpos + 1], struct.unpack_from(
                "<H", data, xpos + 2)[0]
            if si1 == 0x42 and si2 == 0x43:
                bsize = struct.unpack_from("<H", data, xpos + 4)[0] + 1
            xpos += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block missing BC subfield")
        cdata = data[xend:pos + bsize - 8]
        out.append(zlib.decompress(cdata, wbits=-15))
        pos += bsize
    return b"".join(out)


def read_bam(path: str, pf_only: bool = False):
    """Parse a BAM file → list of (name, codes uint8[0..3], quals uint8).

    Unmapped reads are fine (the assembler ignores alignments); cigar
    and aux fields other than OQ are skipped, as in the reference.
    """
    with open(path, "rb") as fh:
        stream = bgzf_decompress(fh.read())
    if stream[:4] != b"BAM\x01":
        raise ValueError(f"{path}: bad BAM magic")
    pos = 4
    l_text = struct.unpack_from("<i", stream, pos)[0]
    pos += 4 + l_text
    n_ref = struct.unpack_from("<i", stream, pos)[0]
    pos += 4
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", stream, pos)[0]
        pos += 4 + l_name + 4
    out = []
    n = len(stream)
    while pos < n:
        block_size = struct.unpack_from("<i", stream, pos)[0]
        rec_end = pos + 4 + block_size
        (_ref, _p, name_len, _mapq, _bin, cigar_len, flags, seq_len,
         _nref, _npos, _tlen) = struct.unpack_from("<iiBBHHHiiii", stream,
                                                   pos + 4)
        if (pf_only and not flags & FLAG_PF) or flags & FLAG_SECONDARY:
            pos = rec_end
            continue
        p = pos + 36
        name = stream[p:p + name_len - 1].decode()
        if flags & FLAG_FIRST_SEGMENT and not flags & FLAG_LAST_SEGMENT:
            name += ".1"
        elif flags & FLAG_LAST_SEGMENT and not flags & FLAG_FIRST_SEGMENT:
            name += ".2"
        else:
            name += ".3"
        p += name_len + 4 * cigar_len
        nib = np.frombuffer(stream, dtype=np.uint8, offset=p,
                            count=(seq_len + 1) // 2)
        hi, lo = nib >> 4, nib & 0x0F
        nibbles = np.empty(2 * len(nib), dtype=np.uint8)
        nibbles[0::2], nibbles[1::2] = hi, lo
        nibbles = nibbles[:seq_len]
        if (nibbles == 0).any():
            raise ValueError(f"{path}: uninterpretable seq data in {name}")
        codes = _NIBBLE_TO_CODE[nibbles]
        p += (seq_len + 1) // 2
        quals = np.frombuffer(stream, dtype=np.uint8, offset=p,
                              count=seq_len).copy()
        p += seq_len
        # aux tags: scan for OQ:Z (original quals, phred+33)
        while p < rec_end:
            tag, typ = stream[p:p + 2], stream[p + 2:p + 3]
            p += 3
            tl = _TAG_LEN.get(typ)
            if tl is None:
                raise ValueError(f"{path}: bad tag type {typ!r} in {name}")
            if typ == b"B":
                dt = stream[p:p + 1]
                arr_len = struct.unpack_from("<I", stream, p + 1)[0]
                p += 5 + _TAG_LEN[dt] * arr_len
            elif tl:
                p += tl
            elif tag == b"OQ" and typ == b"Z":
                oq = np.frombuffer(stream, dtype=np.uint8, offset=p,
                                   count=seq_len) - 33
                if stream[p + seq_len] != 0:
                    raise ValueError(f"{path}: OQ tag length mismatch")
                quals = oq.astype(np.uint8)
                p += seq_len + 1
            else:  # null-terminated Z/H
                while stream[p] != 0:
                    p += 1
                p += 1
        if flags & FLAG_REVERSED:
            codes = (3 - codes)[::-1].copy()
            quals = quals[::-1].copy()
        out.append((name, codes, quals))
        pos = rec_end
    return out

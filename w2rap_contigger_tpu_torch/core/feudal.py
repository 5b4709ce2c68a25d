"""Feudal-file format readers/writers (.fastb / .qualb / .qualp).

Byte-level parity with the reference's on-disk formats so that
checkpoints written by the reference binary can be loaded directly (and
vice versa) for step-wise parity testing:

* Feudal control block: 24-byte header — uint32 nElements, uint8
  bitflags (nFiles|compressed|endian|version), uint8 sizeofFixed, uint8
  sizeofX, uint8 sizeofA, uint64 varOffset, uint64 fixedOffset
  (reference ``src/feudal/FeudalControlBlock.h:27-165``; layout of the
  three chunks documented at ``FeudalControlBlock.h:83-127``).
* ``.fastb`` = MasterVec<BaseVec>: variable data is 2-bit-packed bases,
  4 per byte, LSB-first (``src/feudal/FieldVec.h:765-769`` — value i is
  ``byte[i/4] >> (i%4)*2``); fixed data is a uint32 base count per read
  (``FieldVec.h:585-607``).
* ``.qualb`` = MasterVec<SmallVec<uint8>>: raw bytes, no fixed data
  (``src/feudal/SmallVec.h:348-366`` — fixedDataLen()==0 for primitive
  element types; size inferred from the offsets table).
* ``.qualp`` = MasterVec<PQVec>: block-compressed quality vectors
  (``src/feudal/PQVec.cc`` — encoder DP at ``:18-86``, bitstream layout
  in ``encode``/``decode`` at ``:88-187``; 17-bit block header = 8-bit
  count, 3-bit width, 6-bit minQ, zero count byte terminates).

These are host-side IO (L1/L4 of the survey); the decoded reads land in
the flat packed tensors of :mod:`w2rap_contigger_tpu_torch.core.reads`.
"""

from __future__ import annotations

import struct

import numpy as np

_FCB = struct.Struct("<IBBBBQQ")
assert _FCB.size == 24


def _read_fcb(data: bytes, path: str):
    n, flags, szf, szx, sza, var_off, fixed_off = _FCB.unpack_from(data, 0)
    if flags & 3 != 1:
        raise ValueError(f"{path}: not a single-file feudal file (nFiles={flags & 3})")
    if flags & 4:
        raise ValueError(f"{path}: compressed mastervec files are not supported")
    # nElements is stored modulo 2^32; the authoritative count comes from
    # the offsets-table extent (FeudalControlBlock.h:57-61)
    n_elements = (fixed_off - var_off) // 8 - 1
    if n_elements & 0xFFFFFFFF != n:
        raise ValueError(f"{path}: inconsistent element count")
    return n_elements, var_off, fixed_off


def _write_fcb(n_elements: int, var_data_len: int, sizeof_fixed: int,
               sizeof_x: int, sizeof_a: int) -> bytes:
    var_off = var_data_len + _FCB.size
    fixed_off = var_off + (n_elements + 1) * 8
    return _FCB.pack(n_elements & 0xFFFFFFFF, 1, sizeof_fixed & 0xFF,
                     sizeof_x & 0xFF, sizeof_a & 0xFF, var_off, fixed_off)


def _offsets(data: bytes, var_off: int, fixed_off: int) -> np.ndarray:
    return np.frombuffer(data, dtype="<u8", offset=var_off,
                         count=(fixed_off - var_off) // 8)


# ---------------------------------------------------------------- .fastb

def read_fastb(path: str):
    """Read a .fastb into (list of uint8 code arrays, codes 0..3 = ACGT)."""
    with open(path, "rb") as fh:
        data = fh.read()
    n, var_off, fixed_off = _read_fcb(data, path)
    offs = _offsets(data, var_off, fixed_off)
    sizes = np.frombuffer(data, dtype="<u4", offset=fixed_off, count=n)
    packed = np.frombuffer(data, dtype=np.uint8, offset=_FCB.size,
                           count=var_off - _FCB.size)
    # unpack all bytes once: byte -> 4 codes, LSB-first (FieldVec.h:768)
    shifts = np.array([0, 2, 4, 6], dtype=np.uint8)
    codes_all = (packed[:, None] >> shifts[None, :]) & 3
    codes_all = codes_all.reshape(-1)
    out = []
    base = _FCB.size
    for i in range(n):
        start = (int(offs[i]) - base) * 4
        out.append(codes_all[start:start + int(sizes[i])])
    return out


def write_fastb(path: str, reads) -> None:
    """Write uint8 code arrays (0..3) as a reference-compatible .fastb."""
    chunks, offsets, sizes = [], [0], []
    pos = 0
    for codes in reads:
        codes = np.asarray(codes, dtype=np.uint8)
        sizes.append(len(codes))
        pad = (-len(codes)) % 4
        if pad:
            codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
        quad = codes.reshape(-1, 4)
        packed = (quad[:, 0] | (quad[:, 1] << 2) | (quad[:, 2] << 4)
                  | (quad[:, 3] << 6)).astype(np.uint8)
        chunks.append(packed.tobytes())
        pos += len(packed.tobytes())
        offsets.append(pos)
    var = b"".join(chunks)
    offs = (np.asarray(offsets, dtype="<u8") + _FCB.size).tobytes()
    fixed = np.asarray(sizes, dtype="<u4").tobytes()
    with open(path, "wb") as fh:
        fh.write(_write_fcb(len(sizes), len(var), 4, 16, 1))
        fh.write(var)
        fh.write(offs)
        fh.write(fixed)


# ---------------------------------------------------------------- .qualb

def read_qualb(path: str):
    """Read a .qualb into a list of uint8 quality arrays."""
    with open(path, "rb") as fh:
        data = fh.read()
    n, var_off, fixed_off = _read_fcb(data, path)
    offs = _offsets(data, var_off, fixed_off)
    raw = np.frombuffer(data, dtype=np.uint8, offset=0, count=var_off)
    return [raw[int(offs[i]):int(offs[i + 1])].copy() for i in range(n)]


def write_qualb(path: str, quals) -> None:
    chunks, offsets = [], [_FCB.size]
    pos = _FCB.size
    for q in quals:
        b = np.asarray(q, dtype=np.uint8).tobytes()
        chunks.append(b)
        pos += len(b)
        offsets.append(pos)
    var = b"".join(chunks)
    with open(path, "wb") as fh:
        fh.write(_write_fcb(len(chunks), len(var), 0, 16, 1))
        fh.write(var)
        fh.write(np.asarray(offsets, dtype="<u8").tobytes())


# ---------------------------------------------------------------- .qualp

def _block_size(n_qs: int, n_bits: int) -> int:
    # 17 header bits + payload, byte-rounded (PQVec.h:58-60)
    return (n_qs * n_bits + 17 + 7) >> 3


def pqvec_encode(q: np.ndarray) -> bytes:
    """Optimal block partition via the reference's suffix DP
    (PQVec.cc:18-86): for each prefix, the cheapest block cover where a
    block stores up to 255 quals as minQ + nBits-wide offsets."""
    q = np.asarray(q, dtype=np.uint8)
    if q.max(initial=0) > 63:
        raise ValueError("quality score > 63")
    n = len(q)
    costs = np.zeros(n + 1, dtype=np.int64)
    costs[0] = 1  # terminator byte
    # block choice (nQs, nBits, minQ) ending at position i
    best_n = np.zeros(n + 1, dtype=np.int32)
    best_bits = np.zeros(n + 1, dtype=np.int32)
    best_min = np.zeros(n + 1, dtype=np.int32)
    for i in range(1, n + 1):
        mn = mx = int(q[i - 1])
        bc = 0x7FFFFFFF
        for m in range(1, min(i, 255) + 1):
            v = int(q[i - m])
            mn = min(mn, v)
            mx = max(mx, v)
            bits = int(mx - mn).bit_length() if mx > mn else 0
            # ceilLg2: width able to represent the (mx-mn+1) distinct values
            c = costs[i - m] + _block_size(m, bits)
            if c < bc:
                bc = c
                best_n[i], best_bits[i], best_min[i] = m, bits, mn
        costs[i] = bc
    # walk back the chosen blocks
    blocks = []
    i = n
    while i > 0:
        m = int(best_n[i])
        blocks.append((m, int(best_bits[i]), int(best_min[i])))
        i -= m
    blocks.reverse()
    # emit the little-endian bitstream (PQVec.cc:88-127)
    out = bytearray()
    pos = 0
    acc = 0
    nacc = 0

    def put(val, width):
        nonlocal acc, nacc
        acc |= int(val) << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    idx = 0
    for (m, bits, mn) in blocks:
        put(m, 8)
        put(bits, 3)
        put(mn, 6)
        for j in range(m):
            if bits:
                put(int(q[idx]) - mn, bits)
            idx += 1
        if nacc:  # byte-align between blocks
            out.append(acc & 0xFF)
            acc = 0
            nacc = 0
    out.append(0)
    return bytes(out)


def pqvec_decode(buf, out_len: int | None = None) -> np.ndarray:
    """Decode one PQVec buffer to uint8 quals (PQVec.cc:129-187)."""
    buf = bytes(buf)
    qs = []
    pos = 0
    while True:
        n_qs = buf[pos]
        if n_qs == 0:
            break
        # header is a 17-bit LE bitfield: [8b n][3b bits][6b minQ]
        hdr = int.from_bytes(buf[pos:pos + 3], "little")
        bits = (hdr >> 8) & 7
        min_q = (hdr >> 11) & 0x3F
        bsz = _block_size(n_qs, bits)
        if bits == 0:
            qs.extend([min_q] * n_qs)
        else:
            stream = int.from_bytes(buf[pos:pos + bsz], "little") >> 17
            mask = (1 << bits) - 1
            for _ in range(n_qs):
                qs.append(min_q + (stream & mask))
                stream >>= bits
        pos += bsz
    a = np.asarray(qs, dtype=np.uint8)
    if out_len is not None and len(a) != out_len:
        raise ValueError("decoded length mismatch")
    return a


def read_qualp(path: str):
    """Read a .qualp (MasterVec<PQVec>) into uint8 quality arrays."""
    with open(path, "rb") as fh:
        data = fh.read()
    n, var_off, fixed_off = _read_fcb(data, path)
    offs = _offsets(data, var_off, fixed_off)
    return [pqvec_decode(data[int(offs[i]):int(offs[i + 1])])
            for i in range(n)]


def write_qualp(path: str, quals) -> None:
    chunks, offsets = [], [_FCB.size]
    pos = _FCB.size
    for q in quals:
        b = pqvec_encode(np.asarray(q, dtype=np.uint8))
        chunks.append(b)
        pos += len(b)
        offsets.append(pos)
    var = b"".join(chunks)
    with open(path, "wb") as fh:
        fh.write(_write_fcb(len(chunks), len(var), 0, 16, 1))
        fh.write(var)
        fh.write(np.asarray(offsets, dtype="<u8").tobytes())

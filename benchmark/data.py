"""Synthetic paired-end reads of a configuration, made from a seed.

The read model of the repo's FASTQ generator, rewritten without any of
the assembler's packages: a uniformly random genome with identical repeat
copies planted at evenly spread loci, fragments of a fixed length drawn
uniformly, read 1 the fragment's first `read_len` bases and read 2 the
reverse complement of its last ones, substitutions at `sub_rate` (a base
replaced by one of the three others), qualities uniform in
[qual_min, qual_max] with a share `qual_low_rate` set to `qual_low`.
Qualities are independent of the substitutions, as in that generator.

Reads come out in the order the assembler's paired FASTQ reader gives
them: read 2i and 2i+1 are the two ends of fragment i.  Everything is
drawn on `device` with one torch.Generator, in blocks of fragments so
that the temporaries stay near a GiB, then copied to host numpy arrays:
the step-2 input (bases (N, L) uint8 codes 0..3, lengths (N,) int32,
quals (N, L) uint8 raw phred).  The same seed on the same kind of device
gives the same reads.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_PAIRS = 131072


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def make_genome(cfg: dict, g: torch.Generator, device) -> torch.Tensor:
    """(genome_len,) uint8 codes with each repeat family's copies planted:
    family f's `copies` identical units of `len` bases at loci spread
    evenly, shifted by f so that families do not overlap."""
    glen = int(cfg["genome_len"])
    genome = torch.randint(0, 4, (glen,), generator=g, device=device, dtype=torch.uint8)
    for f, fam in enumerate(cfg.get("repeats", [])):
        copies, ulen = int(fam["copies"]), int(fam["len"])
        unit = torch.randint(0, 4, (ulen,), generator=g, device=device, dtype=torch.uint8)
        spacing = glen // (copies + 1)
        for i in range(copies):
            at = spacing * (i + 1) + f * (ulen + 1000)
            n = max(0, min(ulen, glen - at))
            genome[at : at + n] = unit[:n]
    return genome


def make_reads(cfg: dict, seed: int, device="cpu"):
    """(bases, lengths, quals) host numpy arrays of the configuration's
    2 * pairs reads, made from `seed` on `device`."""
    rd = cfg["reads"]
    dev = torch.device(device)
    g = _generator(seed, dev)
    genome = make_genome(cfg["genome"], g, dev)
    pairs, L, frag = int(rd["pairs"]), int(rd["read_len"]), int(rd["fragment_len"])
    if frag < L or frag >= genome.numel():
        raise ValueError(f"fragment_len {frag} against read_len {L} and genome {genome.numel()}")
    bases = np.empty((2 * pairs, L), dtype=np.uint8)
    quals = np.empty((2 * pairs, L), dtype=np.uint8)
    span = torch.arange(frag, device=dev)
    for p0 in range(0, pairs, BLOCK_PAIRS):
        nb = min(BLOCK_PAIRS, pairs - p0)
        starts = torch.randint(0, genome.numel() - frag, (nb,), generator=g, device=dev)
        frags = genome[starts[:, None] + span[None, :]]
        r1 = frags[:, :L]
        r2 = 3 - frags[:, frag - L :].flip(1)
        reads = torch.stack([r1, r2], dim=1).reshape(2 * nb, L)
        err = torch.rand(reads.shape, generator=g, device=dev) < float(rd["sub_rate"])
        shift = torch.randint(1, 4, reads.shape, generator=g, device=dev, dtype=torch.uint8)
        reads = torch.where(err, (reads + shift) % 4, reads)
        q = torch.randint(int(rd["qual_min"]), int(rd["qual_max"]) + 1, reads.shape,
                          generator=g, device=dev, dtype=torch.uint8)
        low = torch.rand(reads.shape, generator=g, device=dev) < float(rd["qual_low_rate"])
        q = torch.where(low, torch.tensor(int(rd["qual_low"]), dtype=torch.uint8, device=dev), q)
        bases[2 * p0 : 2 * (p0 + nb)] = reads.cpu().numpy()
        quals[2 * p0 : 2 * (p0 + nb)] = q.cpu().numpy()
    lengths = np.full(2 * pairs, L, dtype=np.int32)
    return bases, lengths, quals

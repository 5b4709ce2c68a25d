"""Carry a kmer dictionary across the two packages.

The JAX package's KmerDict exposes host numpy arrays (words (m, W) u32,
counts (m,) i32, ctx (m,) u32); the port's KmerDict holds device
tensors.  These two functions convert, so both packages' graph and
pathing stages can start from one dictionary.  The step checkpoints need
no converter: both packages save them through the same HyperBasevector
and ReadPathVec classes.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ops import bitkmer as bk
from .ops.kmer_engine import KmerDict


def dict_from_reference(words, counts, ctx, k: int, device) -> KmerDict:
    """Port dictionary on `device` from the JAX package's host arrays."""
    dev = resolve_device(device)
    words = np.asarray(words, dtype=np.uint32).reshape(-1, bk.nwords(k))

    def t(a):
        return torch.from_numpy(np.asarray(a).astype(np.int64)).to(dev)

    return KmerDict(t(words), t(counts), t(np.asarray(ctx, dtype=np.uint32)), k)


def dict_to_numpy(d: KmerDict):
    """(words (m, W) u32, counts (m,) i32, ctx (m,) u32) host arrays."""
    return d.host("words"), d.host("counts"), d.host("ctx")

"""KMerContext bytes on torch integer tensors.

Counterpart of w2rap_contigger_tpu/ops/context.py:17-55; bit layout of
src/kmers/KMerContext.h:36-57: high nibble = predecessor base bits, low
nibble = successor base bits, bit 0 = A .. bit 3 = T.
"""

from __future__ import annotations

import torch


def make_context(pred_code, succ_code, has_pred, has_succ) -> torch.Tensor:
    """Context byte from optional predecessor/successor base codes."""
    pred = (1 << pred_code) << 4
    succ = 1 << succ_code
    return pred * has_pred + succ * has_succ


def rc_bits4(b: torch.Tensor) -> torch.Tensor:
    """Reverse the 4 base bits (A<->T, C<->G): bit i -> bit 3-i."""
    return ((b & 1) << 3) | ((b & 2) << 1) | ((b & 4) >> 1) | ((b & 8) >> 3)


def rc_context(ctx: torch.Tensor) -> torch.Tensor:
    """Swap nibbles + complement bases (KMerContext::rc, KMerContext.h:75)."""
    return (rc_bits4(ctx & 0xF) << 4) | rc_bits4((ctx >> 4) & 0xF)


def pred_bits(ctx: torch.Tensor) -> torch.Tensor:
    return (ctx >> 4) & 0xF


def succ_bits(ctx: torch.Tensor) -> torch.Tensor:
    return ctx & 0xF


def popcount4(b: torch.Tensor) -> torch.Tensor:
    """Number of set bits in a 4-bit value."""
    return (b & 1) + ((b >> 1) & 1) + ((b >> 2) & 1) + ((b >> 3) & 1)


def single_base(b: torch.Tensor) -> torch.Tensor:
    """Base code of the single set bit (undefined if popcount != 1)."""
    return ((b >> 1) & 1) + ((b >> 2) & 1) * 2 + ((b >> 3) & 1) * 3

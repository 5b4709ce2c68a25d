"""The roofline formulas give the bounds the port's kernel notes used:
K1 0.0761 ms on step 2's chunk (65,536 reads of 250 bases, k=60) and K2
2.509 ms on 210.1M rows at W = 4."""

from benchmark import roofline


def test_k1_bound_on_step2_chunk():
    assert round(roofline.k1_bound_s(65536, 250, 60) * 1e3, 4) == 0.0761


def test_k2_bound_at_ecoli_rows():
    assert round(roofline.k2_bound_s(210_100_000, 60) * 1e3, 3) == 2.509


def test_bound_takes_the_larger_side():
    assert roofline.bound_s(3.35e12) == 1.0
    assert roofline.bound_s(0, 67e12) == 1.0
    assert roofline.bound_s(3.35e12, 2 * 67e12) == 2.0

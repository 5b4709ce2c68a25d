"""The unitig chain assembly's counting placement against the sort it
replaced, and its device route on the card against the numpy route
(`_unitig_cases`).  Tolerance: exact equality.  The file imports no JAX,
so the `cuda` test runs on a card alone (`python -m pytest --noconftest
tests/test_torch_unitigs.py`); the CPU cases of the device route are in
`tests/test_torch_graph.py`, held to the JAX package besides."""

import numpy as np
import pytest
import torch

from w2rap_contigger_tpu_torch.graph import build as tgb
from _torch_guards import time_limited  # noqa: F401
import _unitig_cases as uc


@pytest.mark.parametrize("seed, n, chains", [(0, 1, 1), (1, 50, 7), (2, 5000, 60), (3, 4000, 4000)])
def test_place_chains_equals_lexsort(seed, n, chains):
    """Random partitions of n nodes into chains (heads drawn from a wider
    id space, ranks 0..len-1 in a shuffled order)."""
    rng = np.random.default_rng(seed)
    heads = rng.choice(10 * n, size=chains, replace=False)
    owner = np.sort(np.concatenate([np.arange(chains), rng.integers(0, chains, n - chains)]))
    head = heads[owner]
    rank = np.arange(n) - np.searchsorted(owner, owner)
    perm = rng.permutation(n)
    nodes, head, rank = rng.permutation(10 * n)[:n][perm], head[perm], rank[perm]
    placed, cnt, start = tgb.place_chains(*map(torch.from_numpy, (nodes, head, rank)), 10 * n)
    np.testing.assert_array_equal(placed.numpy(), nodes[np.lexsort((rank, head))])
    np.testing.assert_array_equal(cnt.numpy(), np.bincount(head, minlength=10 * n))
    # a rank outside its chain leaves a hole, which the assembly refuses
    rank[0] = n
    placed, _, _ = tgb.place_chains(*map(torch.from_numpy, (nodes, head, rank)), 10 * n)
    assert (placed.numpy() < 0).sum() == 1


@pytest.mark.cuda
def test_device_assembly_on_the_card_matches_numpy_route():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device route runs there")
    (got, want), d, _ = uc.both_routes(*uc.card_case(), "cuda")
    assert d.size > 200_000
    uc.assert_same(got, want, d, d.k)
    assert got[5]["host_tie_chains"] > 0 and got[5]["host_cycle_nodes"] > 0

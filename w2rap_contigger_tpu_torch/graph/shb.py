"""Supported-HBV path weighting + low-coverage edge filter.

The reference's local assemblies wrap the local graph in a
``SupportedHyperBasevector`` — an HBV plus the traced read paths with
fw/rc fractional weights (construction in ``LongHyper.cc:787-814``,
class at ``paths/long/SupportedHyperBasevector.h:49``) — and then run
exactly one of its simplification methods in the w2rap pipeline:
``DeleteLowCoverage`` (``SupportedHyperBasevector6.cc:1385``, called
from ``MakeLocalAssembly2``, ``GapToyTools.cc:397``).  The rest of the
SHB method family (PullApart2, Gulp, DivineBubbles, ...) belongs to the
standalone DISCOVAR LongProto pipeline and is never reached from
w2rap-contigger's driver.

With the default heuristics (``NEW_LC_FILT=False``/``LC_CAREFUL=False``,
``Heuristics.h:115,160``) DeleteLowCoverage reduces to an integer-free
coverage-ratio test per edge:

  cov[e]  = sum of Weight(i) over paths i containing e, where
            Weight(i) = weight_fw + weight_rc and FixWeights
            (``SupportedHyperBasevector5.cc:996``) makes the weight of a
            path equal to the weight of its involuted mirror;
  alt_c   = max cov over all edges sharing e's left vertex (outgoing)
            or right vertex (incoming)  [includes e itself];
  delete e if (cov[e] <= 2.0 and alt_c >= 5*cov[e])
           or (cov[inv e] <= 2.0 and alt_inv >= 5*cov[inv e]).

Because FixWeights symmetrizes fw/rc weight between a path and its
reverse-complement mirror, the post-FixWeights edge coverage equals the
number of traced sequences covering the edge in either orientation —
which is what :func:`edge_coverage` computes directly.
"""

from __future__ import annotations

import numpy as np

LOW_COV = 2.0   # SupportedHyperBasevector6.cc:1391
MIN_MULT = 5    # SupportedHyperBasevector6.cc:1441


def involution_from_xlats(n_edges, fwd_xlat, rev_xlat):
    """inv[] permutation from build_hbv_from_edges' fwd/rev tables
    (HBVFromEdges.h:27 xlat semantics)."""
    inv = np.full(n_edges, -1, dtype=np.int64)
    inv[np.asarray(fwd_xlat)] = np.asarray(rev_xlat)
    inv[np.asarray(rev_xlat)] = np.asarray(fwd_xlat)
    return inv


def edge_coverage(n_edges, inv, traced_paths, weights=None):
    """Post-FixWeights edge coverage: each traced sequence adds its
    weight to every edge on its path and to that edge's involution
    (the rc mirror path carries the symmetrized rc weight,
    SupportedHyperBasevector5.cc:996)."""
    cov = np.zeros(n_edges, dtype=np.float64)
    for i, p in enumerate(traced_paths):
        if len(p) == 0:
            continue
        w = 1.0 if weights is None else float(weights[i])
        es = np.unique(np.asarray(p, dtype=np.int64))
        np.add.at(cov, es, w)
        ie = inv[es]
        np.add.at(cov, ie[ie >= 0], w)
    return cov


def low_coverage_edges(hbv, inv, cov,
                       low_cov: float = LOW_COV,
                       min_mult: int = MIN_MULT):
    """Edge set DeleteLowCoverage would delete (default-heuristics
    branch, SupportedHyperBasevector6.cc:1442-1447)."""
    fo, fe, to, te = hbv.vertex_csr()
    n = hbv.n_edges
    # alt_c[e] = max cov over From(to_left[e]) U To(to_right[e])
    vmax_out = np.zeros(hbv.n_vertices, dtype=np.float64)
    vmax_in = np.zeros(hbv.n_vertices, dtype=np.float64)
    for v in range(hbv.n_vertices):
        out_es = fe[fo[v]:fo[v + 1]]
        in_es = te[to[v]:to[v + 1]]
        if len(out_es):
            vmax_out[v] = cov[out_es].max()
        if len(in_es):
            vmax_in[v] = cov[in_es].max()
    alt = np.maximum(vmax_out[hbv.to_left], vmax_in[hbv.to_right])

    dels = []
    for e in range(n):
        re = int(inv[e]) if inv is not None else -1
        c = cov[e]
        rc = cov[re] if re >= 0 else 1e9
        alt_c = alt[e]
        alt_rc = alt[re] if re >= 0 else 0.0
        if (c <= low_cov and alt_c >= min_mult * c) or \
           (re >= 0 and rc <= low_cov and alt_rc >= min_mult * rc):
            dels.append(e)
    return set(dels)

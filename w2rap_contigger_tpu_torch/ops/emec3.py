"""EMEC3 — EM-based error correction over a read stack.

Parity with the reference's EM corrector (``src/paths/long/EMEC3.cc``):
given a column-aligned stack whose row 0 is the founder read, iterate

* E-step ``estimate_friends`` (``EMEC3.cc:255-305``): per row, the
  friend responsibility a·φ_f / (a·φ_f + (1−a)·φ_NOTf) where φ_f is the
  quality-weighted agreement likelihood with the current truth
  (``:207-228``) and φ_NOTf the uniform-random model (``:230-252``);
* ``estimate_A`` (``:311-321``): a ← Σ_{j≥1} pfriend / (R) — the
  reference divides by the full stack size including the founder;
* M-step ``estimate_truth`` (``:338-500``): per column, accumulate
  friendship-weighted hit/miss log-likelihoods, add the founder-derived
  prior (``init_prior``, ``:156-182``) weighted by the covering count,
  and take the ML base;

for ≤20 iterations (``run_EMEC3``, ``:601-700``), with the reference's
short-circuits (need ≥3 friends and ≥5% of the stack; give up when the
EM assigns the founder itself <0.5 friendship) and its conservative
final consensus (``:758-795``): only rewrite a base when the
friendship-weighted vote has >0.70 mass on the winner and <0.10 on the
runner-up, zeroing the quality of edited positions.

Numerical note: the reference evaluates φ in linear space via
``exp(Σ log ...)`` (long double); we form the responsibility in log
space — identical values wherever the reference doesn't underflow.

Representation: (R, L) int8 base codes with -1 for empty columns (the
reference's ' ' = 32), (R, L) uint8 quals. Columns are dense tensors so
stacks batch naturally onto the device path later; this host version is
the semantics oracle.
"""

from __future__ import annotations

import numpy as np

_LOG3 = np.log(3.0)
_LOG25 = np.log(0.25)
_LOG75 = np.log(0.75)


def _q_tables():
    q = np.arange(56, dtype=np.float64)
    perr = np.power(10.0, -q / 10.0)
    with np.errstate(divide="ignore"):
        logq = np.log(perr)
        logp = np.log1p(-perr)
    return logq, logp


_LOGQ, _LOGP = _q_tables()


def init_prior(read, quals) -> np.ndarray:
    """Founder prior (EMEC3.cc:156-182): perror mass split over the 3
    other bases; q==0 means previously corrected (treated as Q30); Q1/Q2
    are unknown -> perror=0.66."""
    read = np.asarray(read)
    q = np.asarray(quals, dtype=np.int64).copy()
    q[q == 0] = 30
    perr = np.power(10.0, -q.astype(np.float64) / 10.0)
    perr[(q == 1) | (q == 2)] = 0.66
    prior = np.repeat((perr / 3.0)[:, None], 4, axis=1)
    prior[np.arange(len(read)), read] = 1.0 - perr
    return prior


def _phi_logs(calls, quals, truth):
    """(log φ_f, log φ_NOTf) per row (EMEC3.cc:207-252)."""
    valid = calls >= 0
    q = np.where(quals == 0, 30, quals).astype(np.int64)
    match = calls == truth[None, :]
    lf = np.where(match, _LOGP[q], _LOGQ[q] - _LOG3)
    ln = np.where(match, _LOG25, np.log(0.75 / 3.0))
    return (np.where(valid, lf, 0.0).sum(axis=1),
            np.where(valid, ln, 0.0).sum(axis=1))


def estimate_friends(calls, quals, truth, a, pfriend):
    """E-step; returns (new pfriend, rmsdiff over j>=1)
    (EMEC3.cc:255-305)."""
    lf, ln = _phi_logs(calls, quals, truth)
    # a*p1/(a*p1+(1-a)*p2) computed stably in log space
    with np.errstate(over="ignore"):
        logit = np.log(a) - np.log1p(-a) + lf - ln
    new = 1.0 / (1.0 + np.exp(-logit))
    rms = float(((pfriend[1:] - new[1:]) ** 2).sum())
    return np.clip(new, 1e-4, 1.0 - 1e-4), rms


def estimate_truth(calls, quals, pfriend, t_prior, founder, founder_q):
    """M-step (EMEC3.cc:338-500, final=False branch). Returns
    (truth, truthq)."""
    R, L = calls.shape
    fr = calls[1:]
    frq = quals[1:].astype(np.int64)
    use = (fr >= 0) & (frq > 0)
    count = use.sum(axis=0)
    q = np.where(frq == 0, 30, frq)
    mis = ((1.0 - pfriend[1:, None]) * (_LOG75 - _LOG3)
           + pfriend[1:, None] * (_LOGQ[q] - _LOG3))
    hit = (1.0 - pfriend[1:, None]) * _LOG25 + pfriend[1:, None] * _LOGP[q]
    mis = np.where(use, mis, 0.0)
    hit = np.where(use, hit, 0.0)
    base_sum = mis.sum(axis=0)  # every base credited with every miss
    p = np.repeat(base_sum[None, :], 4, axis=0)  # (4, L)
    # subtract the observed base's miss back out, add its hit
    for b in range(4):
        sel = use & (fr == b)
        p[b] -= np.where(sel, mis, 0.0).sum(axis=0)
        p[b] += np.where(sel, hit, 0.0).sum(axis=0)
    gamma = np.maximum(1.0, count.astype(np.float64))
    with np.errstate(divide="ignore"):
        p = p + gamma[None, :] * np.log(t_prior.T)
    p = p - p.max(axis=0, keepdims=True)
    p = np.exp(p)
    p = p / p.sum(axis=0, keepdims=True)
    p = np.clip(p, 1e-5, 1.0 - 1e-5)
    imax = p.argmax(axis=0)
    pmax = p.max(axis=0)
    truth = np.where(count < 3, founder, imax).astype(np.int8)
    with np.errstate(divide="ignore"):
        tq = (-10.0 * np.log10(1.0 - pmax)).astype(np.int64)
    truthq = np.where(count < 3, founder_q.astype(np.int64), tq)
    return truth, truthq


def run_emec3(calls, quals, max_iter: int = 20):
    """Main entry (run_EMEC3, EMEC3.cc:601-700). Returns
    (t, q, pfriend)."""
    calls = np.asarray(calls, dtype=np.int8)
    quals = np.asarray(quals, dtype=np.uint8)
    R, L = calls.shape
    founder, founder_q = calls[0].copy(), quals[0].copy()
    nfriends = R - 1
    pfriend = np.full(R, 0.5)
    if nfriends < 3:
        return founder, founder_q, pfriend
    a = 0.5
    t_prior = init_prior(founder, founder_q)
    t = founder.copy()
    olddiff = np.inf
    converged = False
    for _ in range(max_iter):
        pfriend, thisdiff = estimate_friends(calls, quals, t, a, pfriend)
        fcount = float((pfriend[1:] > 0.5).sum())
        if fcount < 3.0 or fcount / R < 0.05:
            return founder, founder_q, pfriend  # lack of friends
        a = float(pfriend[1:].sum() / R)  # reference divides by full size
        t, _ = estimate_truth(calls, quals, pfriend, t_prior, founder,
                              founder_q)
        if abs(olddiff - thisdiff) < 1e-3:
            converged = True
            break
        olddiff = thisdiff
    if pfriend[0] < 0.5:
        return founder, founder_q, pfriend  # EM found the wrong mode
    if not converged:
        pfriend = pfriend.copy()
        pfriend[1:] = 1.0
    nf = int((pfriend[1:] > 0.5).sum())
    if nf < 3 or nf < 0.05 * R:
        return founder, founder_q, pfriend
    # conservative final consensus (EMEC3.cc:758-795)
    fr = calls[1:]
    w = np.where((fr >= 0) & (pfriend[1:, None] > 0.5),
                 pfriend[1:, None], 0.0)
    ptruth = np.zeros((4, L))
    for b in range(4):
        ptruth[b] = np.where(fr == b, w, 0.0).sum(axis=0)
    ssum = ptruth.sum(axis=0)
    fcnt = (w > 0).sum(axis=0)
    order = np.argsort(-ptruth, axis=0, kind="stable")
    top = np.take_along_axis(ptruth, order[:1], axis=0)[0]
    second = np.take_along_axis(ptruth, order[1:2], axis=0)[0]
    with np.errstate(invalid="ignore", divide="ignore"):
        top_f = np.where(ssum > 0, top / ssum, 0.0)
        second_f = np.where(ssum > 0, second / ssum, 0.0)
    rewrite = (ssum > 0) & (fcnt > 3) & (top_f > 0.70) & (second_f < 0.10)
    t_out = np.where(rewrite, order[0].astype(np.int8), founder)
    q_out = np.where(rewrite & (t_out != founder), 0,
                     founder_q).astype(np.uint8)
    return t_out, q_out, pfriend

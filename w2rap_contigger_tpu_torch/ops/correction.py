"""CorrectionSuite — the step-5 local-read correction pipeline.

Reference: CorrectionSuite (src/paths/long/LoadCorrectCore.cc:171-437):
pre-correct -> zero corrected quals -> FillPairs(MIN_FREQ=5) ->
CapQualityScores -> Correct1Pre at K=24 then 40 -> path at K2=80 and
close done pairs -> CorrectPairs1(K=40) -> CP2 special second pass ->
corrected efasta set.

Here `corrected[id]` is a list of expansion sequences (uint8 code
arrays) — the dense stand-in for the reference's efasta with at most
one homopolymer ambiguity (LoadCorrectCore.cc:407-420 condense +
EfastaTools ExpandTo).  Heuristic defaults mirror Heuristics.h: FF_MAX_FREQ
=1000, MAX_STACK=10000, CP_MIN_GLUE=30, CP_MINQ_FLOOR=10, CP_MAX_QDIFF=20,
CP_RAISE_ZERO=False, CP2=True with the LoadCorrectCore.cc:415-421
overrides.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import friends as friends_mod
from .stack import Stack, get_offsets1

from ..config import DEFAULT as _H

FF_MAX_FREQ = _H.FF_MAX_FREQ
MAX_STACK = _H.MAX_STACK
Q_SOLID = _H.Q_SOLID
PROTECTED_BASES = _H.PROTECTED_BASES
Q_TO_PROTECT = _H.Q_TO_PROTECT


@dataclasses.dataclass
class CPParams:
    min_glue: int = 30
    minq_floor: int = 10
    raise_zero: bool = False
    max_qdiff: float = 20.0


def cap_quality_scores(quals, lengths, done, cap_radius=4):
    """CapQualityScores (LoadCorrectCore.cc:158): sliding-window minimum
    of radius 4 over each not-done read's quals."""
    n, L = quals.shape
    q = quals.astype(np.int32)
    pad = np.pad(
        q, ((0, 0), (cap_radius, cap_radius)), constant_values=10**6
    )
    # mask positions beyond each read's length with +inf before the min
    idx = np.arange(L + 2 * cap_radius)[None, :] - cap_radius
    valid = (idx >= 0) & (idx < lengths[:, None])
    pad = np.where(valid, pad, 10**6)
    win = np.lib.stride_tricks.sliding_window_view(
        pad, 2 * cap_radius + 1, axis=1
    )
    mn = win.min(axis=2)
    mn = np.where(np.arange(L)[None, :] < lengths[:, None], mn, quals)
    out = np.where(done[:, None], quals, mn.astype(quals.dtype))
    return out


def zero_corrected_quals(orig_bases, bases, quals):
    """ZeroCorrectedQuals (LoadCorrectCore.cc:126): corrected positions
    get qual 0."""
    return np.where(orig_bases != bases, 0, quals)


def correct1pre_seq(K, bases, lengths, quals, to_edit, trim_to,
                    max_freq=FF_MAX_FREQ, max_stack=MAX_STACK):
    """Correct1Pre (src/paths/long/Correct1Pre.cc:50-176): per-read
    strict friend stacks, HighQualDiff(30,1) + HighQualDiffWindow
    filters, CorrectAll consensus correction.  Jacobi-style: all stacks
    see the pre-pass reads; edits land after the loop.

    Sequential per-read form — retained as the oracle for the batched
    implementation below (the pipeline uses correct1pre)."""
    friends = friends_mod.find_friends(bases, lengths, K, max_freq)
    new_b = bases.copy()
    new_q = quals.copy()
    for id1 in np.flatnonzero(to_edit):
        id1 = int(id1)
        trim_to[id1] = lengths[id1]
        if lengths[id1] == 0:
            continue
        if friends.count(id1) > max_stack:
            continue
        st = Stack.from_friends(
            id1, friends.slice(id1), bases, lengths, quals, "strict"
        )
        st.erase(st.high_qual_diff(Q_SOLID, 1))
        st.erase(st.high_qual_diff_window())
        b, q, tt = st.correct_all()
        trim_to[id1] = tt
        l = int(lengths[id1])
        new_b[id1, :l] = b[:l]
        new_q[id1, :l] = q[:l]
    return new_b, new_q


def _batched_stacks(ids1, friends, bases, lengths, quals, C, Rb):
    """(B, Rb, C) strict stacks for founder reads ids1 (all of length C),
    rows padded to Rb with UNDEF.  One flat gather builds every stack of
    the bucket at once (the batched (blobs, rows, cols) readstack form:
    stack shapes are the shapes a TPU wants, ReadStack.cc:111-161)."""
    B = len(ids1)
    rows_i = (friends.offs[ids1 + 1] - friends.offs[ids1]) + 1
    tot = int(rows_i.sum())
    ids = np.empty(tot, dtype=np.int64)
    offs = np.empty(tot, dtype=np.int64)
    rcs = np.empty(tot, dtype=bool)
    member = np.repeat(np.arange(B), rows_i)
    slot = np.arange(tot) - np.repeat(np.cumsum(rows_i) - rows_i, rows_i)
    first = slot == 0
    ids[first] = ids1
    offs[first] = 0
    rcs[first] = False
    rest = ~first
    f0 = friends.offs[ids1]
    # friend j of member m sits at CSR position f0[m] + slot - 1
    src_csr = (f0[member] + slot - 1)[rest]
    ids[rest] = friends.id2[src_csr]
    offs[rest] = friends.off[src_csr]
    rcs[rest] = friends.rc[src_csr]

    l2 = np.asarray(lengths)[ids].astype(np.int64)
    cols = np.arange(C, dtype=np.int64)[None, :]
    src = cols - offs[:, None]
    valid = (src >= 0) & (src < l2[:, None])
    srcc = np.where(rcs[:, None], l2[:, None] - 1 - src, src)
    srcc = np.clip(srcc, 0, bases.shape[1] - 1)
    vals = bases[ids[:, None], srcc]
    qvals = quals[ids[:, None], srcc]
    vals = np.where(rcs[:, None], 3 - vals, vals)
    flat_b = np.where(valid, vals, -1).astype(np.int8)
    flat_q = np.where(valid, qvals, -1).astype(np.int16)

    sb = np.full((B, Rb, C), -1, dtype=np.int8)
    sq = np.full((B, Rb, C), -1, dtype=np.int16)
    sb[member, slot] = flat_b
    sq[member, slot] = flat_q
    return sb, sq


def _hqd_batched(sb, sq, n):
    """HighQualDiff(n, top=1) over (B, R, C) stacks (ReadStack.cc:597)."""
    mism = (sb != sb[:, :1]) & (sq >= n) & (sq[:, :1] >= n)
    sus = mism.any(axis=2)
    sus[:, 0] = False
    return sus


def _hqdw_batched(sb, sq):
    """HighQualDiffWindow over (B, R, C) stacks (ReadStack.cc:2078).
    Invalidated rows (all-UNDEF) can neither confirm a window nor be
    flagged, so masking == the sequential erase.

    Window reductions run as cumulative-sum differences (one pass over
    (B, R, C) instead of w passes over the materialized window view)."""
    w, min_diffs, min_qsum, min_qual = 10, 3, 30, 10
    B, R, C = sb.shape
    if C < w or R < 2:
        return np.zeros((B, R), dtype=bool)
    P = C - w + 1

    def wsum(x):
        # (..., C) -> (..., P): sum over each length-w window
        cs = np.cumsum(x, axis=-1)
        out = cs[..., w - 1 :].copy()
        out[..., 1:] -= cs[..., : C - w]
        return out

    f_def = (sq[:, 0, :P] >= 0) & (sq[:, 0, w - 1 :] >= 0)  # (B, P)
    eq = (sb[:, 1:] == sb[:, :1]).astype(np.int16)  # (B, R-1, C)
    hq = (sq[:, 1:] >= min_qual).astype(np.int16)
    ok_cnt = wsum((eq & hq).astype(np.int16))
    confirmed = f_def & (ok_cnt == w).any(axis=1)  # (B, P)
    row_def = (sq[:, 1:, :P] >= 0) & (sq[:, 1:, w - 1 :] >= 0)
    diffs = wsum((1 - eq).astype(np.int16))
    qsum = wsum(np.where(eq == 0, sq[:, 1:], 0).astype(np.int32))
    flag = (
        confirmed[:, None, :]
        & row_def
        & (diffs >= min_diffs)
        & (qsum >= min_qsum)
    ).any(axis=2)
    return np.concatenate([np.zeros((B, 1), bool), flag], axis=1)


def _correct_all_batched(sb, sq):
    """CorrectAll over (B, R, C) stacks (ReadStack.cc:1212): returns
    (b (B, C) uint8, q (B, C) int16, trim_to (B,) int64)."""
    B, R, C = sb.shape
    min_win, min_win_ratio, max_lose = 50, 10, 100
    qf = sq.astype(np.float64)
    w = np.where(qf <= 2, np.minimum(qf, 0.2), qf)
    w = np.where(sq >= 0, w, 0.0)
    sums = np.zeros((B, 4, C))
    tops = np.zeros((B, 4, C), dtype=np.int64)
    for base in range(4):
        m = sb == base
        sums[:, base] = np.where(m, w, 0.0).sum(axis=1)
        tops[:, base] = np.where(m & (sq >= 0), sq, 0).max(axis=1, initial=0)
    # BaseMetrics::reverseSort per batch element (stack._metrics_order)
    rev = np.argsort(-sums[:, ::-1], axis=1, kind="stable")
    order = 3 - rev
    winner = order[:, 0]
    val0 = np.take_along_axis(sums, order[:, :1], axis=1)[:, 0]
    sub = sums - tops
    val1 = np.take_along_axis(sub, order[:, 1:2], axis=1)[:, 0]
    ok = (val0 >= min_win) & (val0 >= min_win_ratio * val1) & (
        val1 <= max_lose
    )
    bad = ~ok
    trim_to = np.where(bad.any(axis=1), np.argmax(bad, axis=1), C).astype(
        np.int64
    )
    b0 = np.where(sb[:, 0] >= 0, sb[:, 0], 0).astype(np.uint8)
    change = ok & (sb[:, 0] != winner)
    b = np.where(change, winner, b0).astype(np.uint8)
    q = np.where(change, 0, sq[:, 0]).astype(np.int16)
    return b, q, trim_to


def correct1pre(K, bases, lengths, quals, to_edit, trim_to,
                max_freq=FF_MAX_FREQ, max_stack=MAX_STACK):
    """Batched Correct1Pre: reads are bucketed by (founder length,
    pow2-padded row count) and each bucket runs the
    HighQualDiff -> HighQualDiffWindow -> CorrectAll chain as one
    (B, R, C) masked reduction (suspect rows are invalidated in place —
    equivalent to the sequential erase, asserted by
    tests/test_correct1pre_batched.py against correct1pre_seq).
    Reference: Correct1Pre.cc:50-176."""
    friends = friends_mod.find_friends(bases, lengths, K, max_freq)
    new_b = bases.copy()
    new_q = quals.copy()
    edit = np.flatnonzero(to_edit)
    trim_to[edit] = lengths[edit]
    edit = edit[np.asarray(lengths)[edit] > 0]
    if len(edit) == 0:
        return new_b, new_q
    counts = friends.offs[edit + 1] - friends.offs[edit]
    edit = edit[counts <= max_stack]
    if len(edit) == 0:
        return new_b, new_q
    rows = (friends.offs[edit + 1] - friends.offs[edit]) + 1
    rb = np.maximum(2, 1 << np.ceil(np.log2(rows)).astype(np.int64))
    cl = np.asarray(lengths)[edit].astype(np.int64)
    order = np.lexsort((edit, rb, cl))
    edit, rb, cl = edit[order], rb[order], cl[order]
    grp = np.concatenate(
        [[True], (rb[1:] != rb[:-1]) | (cl[1:] != cl[:-1])]
    )
    gstart = np.flatnonzero(grp)
    gend = np.concatenate([gstart[1:], [len(edit)]])
    L = bases.shape[1]
    MAX_ELEMS = 1 << 26  # per-bucket working-set bound (~192MB of stacks)
    for s0, e0 in zip(gstart, gend):
        C = int(cl[s0])
        Rb = int(rb[s0])
        bstep = max(1, MAX_ELEMS // (Rb * C))
        for s in range(s0, e0, bstep):
            ids1 = edit[s : min(s + bstep, e0)]
            sb, sq = _batched_stacks(
                ids1, friends, bases, lengths, quals, C, Rb
            )
            sus = _hqd_batched(sb, sq, Q_SOLID)
            sb[sus] = -1
            sq[sus] = -1
            sus = _hqdw_batched(sb, sq)
            sb[sus] = -1
            sq[sus] = -1
            b, q, tt = _correct_all_batched(sb, sq)
            trim_to[ids1] = tt
            new_b[ids1[:, None], np.arange(C)[None, :]] = b
            new_q[ids1[:, None], np.arange(C)[None, :]] = q
    return new_b, new_q


def _protect_ends(stack, con, conq):
    """CorrectPairs1.cc:240-258: founder/partner end bases >=Q20 override
    the consensus at the outer 10 columns."""
    C = stack.cols
    for j in range(min(PROTECTED_BASES, C)):
        if stack.quals[0, j] >= Q_TO_PROTECT and stack.bases[0, j] != con[j]:
            con[j] = stack.bases[0, j]
            conq[j] = stack.quals[0, j]
    for j in range(min(PROTECTED_BASES, C)):
        jr = C - j - 1
        if stack.quals[1, jr] >= Q_TO_PROTECT and stack.bases[1, jr] != con[jr]:
            con[jr] = stack.bases[1, jr]
            conq[jr] = stack.quals[1, jr]


def _min_glue(stack, con):
    """CorrectPairs1.cc:365-400: the weakest link of the chain of >=40-
    base consensus-agreement intervals covering the closure."""
    R, C = stack.rows, stack.cols
    agree = []
    eq = stack.bases == con[None, :]
    for i in range(R):
        row = eq[i]
        j = 0
        while j < C:
            if not row[j]:
                j += 1
                continue
            k = j
            while k < C and row[k]:
                k += 1
            if k - j >= 40:
                agree.append((j, k))
            j = k
    agree.sort(key=lambda h: (h[0], -h[1]))
    # drop intervals nested under a same-start longer one
    pruned = []
    i = 0
    while i < len(agree):
        j = i + 1
        while j < len(agree) and agree[j][1] <= agree[i][1]:
            j += 1
        pruned.append(agree[i])
        i = j
    agree = pruned
    if not agree or agree[0][0] > 0:
        return 0
    min_glue = agree[0][1] - agree[0][0]
    stop = agree[0][1]
    for s, e in agree[1:]:
        if e > stop:
            min_glue = min(min_glue, stop - s)
            stop = e
    if stop < C:
        return 0
    return min_glue


def correct_pairs1(K, max_freq, bases, lengths, quals, to_edit, cp: CPParams,
                   corrected, max_stack=MAX_STACK):
    """CorrectPairs1 (src/paths/long/CorrectPairs1.cc:44-468): merge the
    two mates' extended friend stacks at shift-scored offsets and emit
    closure consensus sequences into `corrected`."""
    n = len(lengths)
    friends = friends_mod.find_friends(bases, lengths, K, max_freq)
    use = [
        id1
        for id1 in range(n)
        if to_edit[id1] and to_edit[id1 ^ 1] and lengths[id1] > 0
        and (id1 ^ 1) < id1
    ]
    for id1 in use:
        id1p = id1 ^ 1
        st1 = Stack.from_friends(
            id1, friends.slice(id1), bases, lengths, quals,
            "right_extended",
        )
        st2 = Stack.from_friends(
            id1p, friends.slice(id1p), bases, lengths, quals,
            "right_extended",
        )
        if st1.rows > max_stack or st2.rows > max_stack:
            continue

        # low-quality-pair filter (founder mean qual vs stack-wide)
        tb = tq = 0
        for st in (st1, st2):
            d = st.quals[0] >= 0
            tb += int(d.sum())
            q0 = st.quals[0]
            tq += int(q0[(q0 >= 2)].sum())
        this_qual = tq / max(tb, 1)
        ids_all = np.unique(np.concatenate([st1.ids, st2.ids]))
        qa = quals[ids_all]
        la = lengths[ids_all]
        m = np.arange(quals.shape[1])[None, :] < la[:, None]
        bases_all = int(m.sum())
        total_all = int(np.where(m & (qa >= 2), qa, 0).sum())
        all_qual = total_all / max(bases_all, 1)
        if all_qual - this_qual > cp.max_qdiff:
            continue

        for st in (st1, st2):
            st.erase(st.flag_noise())
            st.raise1(0)
            st.erase(st.motif_diff(1))
            st.erase(st.high_qual_diff(Q_SOLID, 1))
        st2.reverse()

        offsets = get_offsets1(st1, st2)
        closures = []
        for o in offsets:
            minq_floor = cp.minq_floor if len(offsets) > 1 else 5
            min_glue_floor = (
                cp.min_glue if len(offsets) > 1 else min(cp.min_glue, 20)
            )
            stack = st1.copy()
            rows1 = stack.rows
            stack.merge(st2, o)
            stack.sort_by_pid(id1 // 2, 0, rows1)
            stack.unique()
            stack.raise1(0)
            stack.raise1(1)
            suspect = stack.high_qual_diff(Q_SOLID, 2)
            if suspect[0] or suspect[1]:
                continue
            stack.erase(suspect)
            suspect = stack.pair_weak1()
            if suspect[0] or suspect[1]:
                continue
            stack.erase(suspect)
            d0 = np.flatnonzero(stack.quals[0] >= 0)
            d1 = np.flatnonzero(stack.quals[1] >= 0)
            if len(d0) == 0 or len(d1) == 0:
                continue
            start = int(d0[0])
            stop = int(d1[-1]) + 1
            if start < stop:
                stack.trim(start, stop)
            con, conq = stack.strong_consensus2(cp.raise_zero)
            con = con.astype(np.int16)
            _protect_ends(stack, con, conq)
            for m_ in range(2):
                dis = (stack.quals[m_] >= 30) & (stack.bases[m_] != con)
                conq[dis] = 0
            # suspicious founder-consensus inconsistencies (flank 5)
            flank, min_mult = 5, 3
            C = stack.cols
            for m_ in range(2):
                fb = stack.bases[m_]
                cand = np.flatnonzero(
                    (stack.quals[m_] >= 0) & (fb != con)
                )
                for j in cand:
                    if j < flank or j + flank >= C:
                        continue
                    lo, hi = j - flank, j + flank + 1
                    if (fb[lo:j] != con[lo:j]).any() or (
                        fb[j + 1 : hi] != con[j + 1 : hi]
                    ).any():
                        continue
                    window = stack.bases[2:, lo:hi]
                    mult = int(
                        (window == fb[lo:hi][None, :]).all(axis=1).sum()
                    )
                    if mult >= min_mult:
                        conq[j] = 0
            # recover conflicted columns
            qmin, qdelta = 2, 10
            to_del = np.zeros(stack.rows, dtype=bool)
            low = np.flatnonzero(conq < minq_floor)
            for j in low:
                q0, q1 = int(stack.quals[0, j]), int(stack.quals[1, j])
                if q0 < qmin and q1 < qmin:
                    continue
                if (
                    q0 >= qmin
                    and q1 >= qmin
                    and stack.bases[0, j] != stack.bases[1, j]
                    and abs(q0 - q1) < qdelta
                ):
                    continue
                b = (
                    stack.bases[0, j]
                    if (q0 >= qmin and q0 >= q1)
                    else stack.bases[1, j]
                )
                to_del |= (stack.quals[:, j] >= qmin) & (
                    stack.bases[:, j] != b
                )
                to_del[:2] = False
            stack.erase(to_del)
            con, conq = stack.strong_consensus2(cp.raise_zero)
            con = con.astype(np.int16)
            _protect_ends(stack, con, conq)
            if not (stack.quals[0] >= 0).any() or not (
                stack.quals[1] >= 0
            ).any():
                continue
            minq = int(conq.min()) if len(conq) else 0
            glue = _min_glue(stack, con)
            if minq >= minq_floor and glue >= min_glue_floor:
                closures.append(con.astype(np.uint8))

        if not closures:
            continue
        uniq = []
        for c in closures:
            if not any(len(c) == len(u) and (c == u).all() for u in uniq):
                uniq.append(c)
        if len(uniq) == 1:
            corrected[id1] = [uniq[0]]
            corrected[id1p] = [(3 - uniq[0])[::-1]]
            continue
        # homopolymer-ambiguity condense (LoadCorrectCore-style efasta):
        # accept all variants when the closures differ only by the length
        # of one single-character run
        pre = 0
        ml = min(len(u) for u in uniq)
        while pre < ml and all(u[pre] == uniq[0][pre] for u in uniq):
            pre += 1
        suf = 0
        while suf < ml - pre and all(
            u[len(u) - 1 - suf] == uniq[0][len(uniq[0]) - 1 - suf]
            for u in uniq
        ):
            suf += 1
        mids = [u[pre : len(u) - suf] for u in uniq]
        chars = {int(c) for m_ in mids for c in m_}
        if len(chars) <= 1:
            corrected[id1] = uniq
            corrected[id1p] = [(3 - u)[::-1] for u in uniq]
            continue
        # else: unambiguous prefix/suffix only (CorrectPairs1 tail logic)
        mc = min(len(u) for u in uniq)
        left = uniq[0][:mc].copy()
        nl = 0
        for j in range(mc):
            if all(len(u) > j and u[j] == left[j] for u in uniq):
                nl = j + 1
            else:
                break
        left = left[:nl]
        right = uniq[0][-mc:].copy()
        nr = 0
        for j in range(mc):
            if all(u[len(u) - 1 - j] == right[len(right) - 1 - j]
                   for u in uniq):
                nr = j + 1
            else:
                break
        right = right[len(right) - nr :]
        if len(left):
            corrected[id1] = [left]
        same = len(left) == len(right) and (left == right).all()
        if not same and len(right):
            corrected[id1p] = [(3 - right)[::-1]]


def populate_specials(bases, lengths, corrected, creads_done, done,
                      M=40, min_strong=5, min_ext=200):
    """PopulateSpecials (LoadCorrectCore.cc:39-122): reads carrying a
    strong (count>=5) 40-mer form that never appears with >=200 bases of
    right extension in any corrected/closed sequence (rc occurrences
    count via their left extension)."""
    n = len(lengths)
    keys, rid, pos, rcf = friends_mod._kmer_keys(bases, lengths, M)
    if len(rid) == 0:
        return np.zeros(n, dtype=bool)

    def as_void(k):
        return np.ascontiguousarray(k).view(
            np.dtype((np.void, k.shape[1]))
        ).ravel()

    void = as_void(keys)
    sv = void[friends_mod.rows_order(keys)]
    bound = np.concatenate([[True], sv[1:] != sv[:-1]])
    starts = np.flatnonzero(bound)
    counts = np.diff(np.concatenate([starts, [len(sv)]]))
    strong = sv[starts[counts >= min_strong]]
    if len(strong) == 0:
        return np.zeros(n, dtype=bool)

    # corrected/closed sequence pool
    seqs = []
    for id_ in range(n):
        seqs.extend(np.asarray(s, dtype=np.uint8) for s in corrected[id_])
        cd = creads_done[id_]
        if done[id_] and cd is not None and len(cd):
            seqs.append(np.asarray(cd, dtype=np.uint8))
    right_ext = np.zeros((len(strong), 2), dtype=bool)  # (key, orient)
    if seqs:
        sl = np.array([len(s) for s in seqs], dtype=np.int32)
        sb = np.zeros((len(seqs), int(sl.max())), dtype=np.uint8)
        for i, s in enumerate(seqs):
            sb[i, : len(s)] = s
        skeys, srid, spos, srcf = friends_mod._kmer_keys(sb, sl, M)
        if len(srid):
            svoid = as_void(skeys)
            ki = np.searchsorted(strong, svoid)
            ki = np.clip(ki, 0, len(strong) - 1)
            hit = strong[ki] == svoid
            ki, srid, spos, srcf = ki[hit], srid[hit], spos[hit], srcf[hit]
            ext_written = sl[srid] - spos  # right ext of the as-written form
            ext_rc = spos + M  # right ext of the rc form
            for flip in (False, True):
                m = srcf == flip
                # as-written orientation relative to canonical == flip
                ok = m & (ext_written >= min_ext)
                right_ext[ki[ok], int(flip)] = True
                ok = m & (ext_rc >= min_ext)
                right_ext[ki[ok], int(not flip)] = True

    # scan reads for strong-but-unextendable forms
    ki = np.searchsorted(strong, void)
    ki = np.clip(ki, 0, len(strong) - 1)
    hit = strong[ki] == void
    ki, rid, pos, rcf = ki[hit], rid[hit], pos[hit], rcf[hit]
    fail_here = ~right_ext[ki, rcf.astype(int)]
    fail_rc = (pos + M >= min_ext) & ~right_ext[ki, (~rcf).astype(int)]
    bad_reads = np.unique(rid[fail_here | fail_rc])
    special = np.zeros(n, dtype=bool)
    special[bad_reads] = True
    special[bad_reads ^ 1] = True
    return special


def correction_suite(reads, fill_min_freq=5, device="cuda"):
    """Full CorrectionSuite (LoadCorrectCore.cc:171-437) over a local
    interleaved-pair ReadSet.  Returns (corrected, creads, cquals, done)
    where corrected[id] is a list of expansion sequences.  Pre-correction
    runs on `device`; the rest is host numpy and the native leaves."""
    from ..paths import fillpairs
    from . import precorrect

    n = reads.n_reads
    gbases = reads.bases
    creads = gbases.copy()
    cquals = reads.quals.astype(np.int16)
    lens = reads.lengths.astype(np.int32).copy()

    # pre-correction (K=25 flank voting)
    from ..core.reads import ReadSet

    rs = ReadSet(creads, lens, reads.quals)
    creads, _nfix = precorrect.pre_correct(rs, device=device)
    cquals = zero_corrected_quals(gbases, creads, cquals)

    # initial pair filling
    done = np.zeros(n, dtype=bool)
    to_edit = np.ones(n, dtype=bool)
    creads_done = [None] * n
    rs = ReadSet(creads, lens, np.clip(cquals, 0, 255).astype(np.uint8))
    filled, _nf = fillpairs.fill_pairs(rs, min_freq=fill_min_freq)
    for id_ in range(n):
        f = filled[id_]
        if len(f) == 0:
            continue
        l = int(lens[id_])
        creads_done[id_] = f.copy()
        # the read keeps min(len(f), l) bases: prefix for the first mate,
        # suffix for the second (LoadCorrectCore.cc:243-258)
        if l < len(f) and (id_ ^ 1) < id_:
            keep = f[len(f) - l :]
        else:
            keep = f[:l]
        lens[id_] = len(keep)
        creads[id_] = 0
        creads[id_, : len(keep)] = keep
        cquals[id_] = 0
        cquals[id_, : len(keep)] = 40
        done[id_] = True
        to_edit[id_] = False
        if (id_ ^ 1) < id_:
            creads_done[id_] = None

    cquals = cap_quality_scores(cquals, lens, done)

    # Correct1Pre at K = 24, 40
    trim_to = lens.astype(np.int64).copy()
    for K in (24, 40):
        creads, cquals = correct1pre(
            K, creads, lens, cquals, to_edit, trim_to
        )

    # close pairs on the K2=80 graph of trimmed reads
    creads, cquals, done, to_edit, creads_done = _close_pairs_k2(
        creads, cquals, lens, trim_to, done, to_edit, creads_done
    )

    corrected = [[] for _ in range(n)]
    correct_pairs1(
        40, FF_MAX_FREQ, creads, lens, cquals, to_edit, CPParams(),
        corrected,
    )
    for id_ in range(n):
        if corrected[id_]:
            to_edit[id_] = False
            to_edit[id_ ^ 1] = False

    # CP2 second pass on "special" reads
    special = populate_specials(creads, lens, corrected, creads_done, done)
    to_edit2 = to_edit.copy()
    to_edit2[~special] = False
    if to_edit2.any():
        cp2 = CPParams(
            min_glue=15, minq_floor=0, raise_zero=True, max_qdiff=25.0
        )
        correct_pairs1(
            40, FF_MAX_FREQ, creads, lens, cquals, to_edit2, cp2,
            corrected,
        )

    for id_ in range(n):
        if done[id_]:
            cd = creads_done[id_]
            corrected[id_] = [cd.copy()] if cd is not None and len(cd) else []
    return corrected, creads, cquals, done


def _close_pairs_k2(creads, cquals, lengths, trim_to, done, to_edit,
                    creads_done, K2=80):
    # reference K2 = 80 (LoadCorrectCore.cc:273)
    """LoadCorrectCore.cc:266-400: path the trimmed reads on their own
    K2=80 graph; a pair whose mates both map cleanly inside one common
    edge is replaced by the implied full fragment."""
    from ..core.reads import ReadSet
    from ..graph import build as gb
    from ..ops import kmer_engine as ke
    from ..paths import pather as pather_mod

    n = len(lengths)
    tl = np.minimum(trim_to, lengths).astype(np.int32)
    if int(tl.max(initial=0)) < K2:
        return creads, cquals, done, to_edit, creads_done
    rs = ReadSet(creads, tl, np.full_like(creads, 40))
    # host-forced flat counting: quals are uniform 40 with min_qual=0,
    # so row counting == flat counting over the trimmed sequences; the
    # jitted row path would pay a fresh XLA compile per distinct blob
    # shape (measured 104 compiles / ~6s of the repeat-rich step-5 wall)
    # row counting emits only for glen > k (strict); mirror that by
    # keeping only reads longer than K2 in the flat pool
    keep_l = np.where(tl > K2, tl.astype(np.int64), 0)
    seg = np.zeros(n + 1, dtype=np.int64)
    seg[1:] = np.cumsum(keep_l)
    flat = np.concatenate(
        [creads[i, : keep_l[i]] for i in range(n)]
    ) if n else np.zeros(0, np.uint8)
    d = ke.count_kmers_flat(flat, seg, K2, min_freq=1, host=True)
    if d.size == 0:
        return creads, cquals, done, to_edit, creads_done
    gb.recompute_adjacencies(d)
    eb, es = gb.build_unitigs(d)
    hbv, fx, rx = gb.build_hbv_from_edges(eb, es, K2)
    paths = pather_mod.path_reads(rs, d, hbv, fx, rx)
    inv = hbv.inv
    for id1 in range(n):
        if done[id1]:
            continue
        id2 = id1 ^ 1
        if id2 < id1:
            continue
        p1 = [int(x) for x in paths.path(id1)]
        p2 = [int(x) for x in paths.path(id2)]
        if len(p1) != 1 or len(p2) != 1:
            continue
        # both trimmed mates must be full-length and map whole
        if tl[id1] != lengths[id1] or tl[id2] != lengths[id2]:
            continue
        e1 = p1[0]
        e2r = int(inv[p2[0]])
        if e1 != e2r:
            continue
        o1 = int(paths.start[id1])
        elen = int(hbv.edge_len(e1))
        # mate 2's start in fwd-edge coordinates
        left1 = o1
        left2 = elen - int(paths.start[id2]) - int(tl[id2])
        offset = left2 - left1
        b1siz, b2siz = int(tl[id1]), int(tl[id2])
        if offset < 0:
            continue
        if left1 < 0 or left2 < 0 or left2 + b2siz > elen:
            continue
        if left1 + b1siz > elen:
            continue
        frag = hbv.edge_seq(e1)[left1 : left2 + b2siz].copy()
        creads_done[id1] = frag
        creads_done[id2] = None
        creads[id1, :b1siz] = frag[:b1siz]
        rcf = (3 - frag)[::-1]
        creads[id2, :b2siz] = rcf[len(rcf) - b2siz :]
        cquals[id1] = 0
        cquals[id1, :b1siz] = 40
        cquals[id2] = 0
        cquals[id2, :b2siz] = 40
        done[id1] = done[id2] = True
        to_edit[id1] = to_edit[id2] = False
    return creads, cquals, done, to_edit, creads_done

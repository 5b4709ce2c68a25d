"""Full readstack engine — column-aligned friend piles with the complete
filter/consensus/merge toolkit of the reference's readstack class
(src/paths/long/ReadStack.{h,cc}).

Data model: dense numpy arrays (rows, cols) — bases int8 with -1 for an
undefined cell (the reference uses ' '), quals int16 with -1 undefined —
plus per-row metadata (id, rc2, pid, pair_pos, offset, len).  Every
operation is a masked column reduction or a sliding-window reduction,
i.e. the shapes a TPU wants; stacks per blob are tiny (<=MAX_STACK rows,
~read-length columns), so the host vectorized form is the fast path.
The batched (stacks, rows, cols) form of the Correct1Pre chain
(construction + HighQualDiff + HighQualDiffWindow + CorrectAll as one
masked reduction per shape bucket) lives in ops/correction.py
(_batched_stacks/_hqd_batched/_hqdw_batched/_correct_all_batched).

Reference quirks reproduced deliberately:
* Merge copies pair_pos into len for the appended rows
  (ReadStack.cc:433 `len_.insert(..., s.pair_pos_...)`) — Unique()
  then compares those bogus lengths.
* StrongConsensus2 skips the window positions at exactly
  min_window/2 from a mismatch (`2*dist < min_window` with dist==20,
  ReadStack.cc:557-560).
* The consensus base is Consensus1's winner while its quality comes
  from the StrongConsensus sums (ReadStack.cc:532-596).
"""

from __future__ import annotations

import math

import numpy as np

UNDEF = -1
QUAL_CAP = 50
MAX_QCOMP = 100


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


def _metrics_order(sums):
    """BaseMetrics::reverseSort order (ReadStack.cc:20-49): descending by
    value, ties broken by HIGHER base id (std::greater on (val, id))."""
    rev = np.argsort(-sums[::-1], axis=0, kind="stable")
    return 3 - rev


class Stack:
    __slots__ = (
        "bases", "quals", "ids", "rc2", "pid", "pair_pos", "offset", "len_",
    )

    def __init__(self, rows, cols):
        self.bases = np.full((rows, cols), UNDEF, dtype=np.int8)
        self.quals = np.full((rows, cols), UNDEF, dtype=np.int16)
        self.ids = np.full(rows, -1, dtype=np.int64)
        self.rc2 = np.zeros(rows, dtype=bool)
        self.pid = np.full(rows, -1, dtype=np.int64)
        self.pair_pos = np.full(rows, -1, dtype=np.int64)
        self.offset = np.full(rows, -1, dtype=np.int64)
        self.len_ = np.full(rows, -1, dtype=np.int64)

    @property
    def rows(self):
        return self.bases.shape[0]

    @property
    def cols(self):
        return self.bases.shape[1]

    def copy(self):
        s = Stack(0, 0)
        for f in Stack.__slots__:
            setattr(s, f, getattr(self, f).copy())
        return s

    def defined(self):
        return self.quals >= 0

    # -- Initialize (ReadStack.cc:111-161) --------------------------------
    @staticmethod
    def from_friends(id1, friends, bases, lengths, quals, ctype="strict"):
        """Build the founder+friends pile.  `friends` is an
        (id2 array, offset array, rc array) triple (a Friends.slice);
        ctype 'strict' clips at the founder length, 'right_extended'
        widens to the furthest friend end."""
        f_id2, f_off, f_rc = friends
        f_id2 = np.asarray(f_id2, dtype=np.int64)
        f_off = np.asarray(f_off, dtype=np.int64)
        f_rc = np.asarray(f_rc, dtype=bool)
        n = len(f_id2) + 1
        k = int(lengths[id1])
        if ctype == "right_extended" and len(f_id2):
            k = max(
                k,
                int((f_off + np.asarray(lengths)[f_id2]).max()),
            )
        st = Stack(n, k)
        # vectorized over rows (was a per-row Python loop): stack col c
        # of row j reads source position c - off (mirrored for rc rows)
        ids = np.concatenate([[id1], f_id2])
        offs = np.concatenate([[0], f_off])
        rcs = np.concatenate([[False], f_rc])
        l2 = np.asarray(lengths)[ids].astype(np.int64)
        cols = np.arange(k, dtype=np.int64)[None, :]
        src = cols - offs[:, None]
        valid = (src >= 0) & (src < l2[:, None])
        srcc = np.where(rcs[:, None], l2[:, None] - 1 - src, src)
        srcc = np.clip(srcc, 0, bases.shape[1] - 1)
        vals = bases[ids[:, None], srcc]
        qvals = quals[ids[:, None], srcc]
        vals = np.where(rcs[:, None], 3 - vals, vals)
        st.bases[:] = np.where(valid, vals, UNDEF).astype(np.int8)
        st.quals[:] = np.where(valid, qvals, UNDEF).astype(np.int16)
        st.offset[:] = offs
        st.len_[:] = l2
        st.ids[:] = ids
        st.rc2[:] = rcs
        st.pid[:] = ids // 2
        st.pair_pos[:] = ids % 2
        return st

    # -- row/column edits ---------------------------------------------------

    def erase(self, to_remove):
        keep = ~np.asarray(to_remove, dtype=bool)
        self.bases = self.bases[keep]
        self.quals = self.quals[keep]
        self.ids = self.ids[keep]
        self.rc2 = self.rc2[keep]
        self.pid = self.pid[keep]
        self.pair_pos = self.pair_pos[keep]
        self.offset = self.offset[keep]
        self.len_ = self.len_[keep]

    def trim(self, start, stop):
        """Trim (ReadStack.cc:847): keep columns [start, stop); drop rows
        left with no defined cell."""
        d = self.defined()[:, start:stop]
        to_remove = ~d.any(axis=1)
        self.bases = self.bases[:, start:stop]
        self.quals = self.quals[:, start:stop]
        self.offset = self.offset - start
        self.erase(to_remove)

    def reverse(self):
        """Reverse (ReadStack.cc:368)."""
        db = self.bases >= 0
        self.bases = np.where(db, 3 - self.bases, self.bases)[:, ::-1]
        self.quals = self.quals[:, ::-1]
        self.rc2 = ~self.rc2
        self.offset = -(self.offset + self.len_ - self.cols)

    def merge(self, other, offset):
        """Merge (ReadStack.cc:380), including the len_<-pair_pos quirk."""
        rows1, rows2 = self.rows, other.rows
        cols1, cols2 = self.cols, other.cols
        left1 = max(0, -offset)
        right1 = max(0, offset + cols2 - cols1)
        left2 = max(0, offset)
        right2 = max(0, cols1 - (offset + cols2))
        newc = left1 + cols1 + right1
        assert newc == left2 + cols2 + right2
        nb = np.full((rows1 + rows2, newc), UNDEF, dtype=np.int8)
        nq = np.full((rows1 + rows2, newc), UNDEF, dtype=np.int16)
        nb[:rows1, left1 : left1 + cols1] = self.bases
        nq[:rows1, left1 : left1 + cols1] = self.quals
        nb[rows1:, left2 : left2 + cols2] = other.bases
        nq[rows1:, left2 : left2 + cols2] = other.quals
        self.bases, self.quals = nb, nq
        self.offset = np.concatenate(
            [self.offset + left1, other.offset + max(0, offset)]
        )
        self.ids = np.concatenate([self.ids, other.ids])
        self.rc2 = np.concatenate([self.rc2, other.rc2])
        self.pid = np.concatenate([self.pid, other.pid])
        self.pair_pos = np.concatenate([self.pair_pos, other.pair_pos])
        # reference bug reproduced: appended rows get pair_pos as len
        self.len_ = np.concatenate([self.len_, other.pair_pos])

    def sort_by_pid(self, pid1, i1, i2):
        """SortByPid (ReadStack.cc:318): order rows by (min offset of the
        pid group [founder pid pinned first], pid, rc2, offset); founder
        rows are then swapped to rows 0 and 1."""
        n = self.rows
        order0 = np.lexsort((np.arange(n), self.pid))
        pid_s = self.pid[order0]
        offsetp = np.empty(n, dtype=np.int64)
        i = 0
        while i < n:
            j = i
            while j < n and pid_s[j] == pid_s[i]:
                j += 1
            off = self.offset[order0[i:j]].min()
            if pid_s[i] == pid1:
                off = -1000000000
            offsetp[i:j] = off
            i = j
        keys = np.rec.fromarrays(
            [
                offsetp,
                self.pid[order0],
                self.rc2[order0].astype(np.int64),
                self.offset[order0],
            ]
        )
        order = order0[np.argsort(keys, kind="stable")]
        order = list(order)
        if order[0] != i1:
            j = order.index(i1)
            order[0], order[j] = order[j], order[0]
        if order[1] != i2:
            j = order.index(i2)
            order[1], order[j] = order[j], order[1]
        perm = np.asarray(order)
        self.bases = self.bases[perm]
        self.quals = self.quals[perm]
        self.ids = self.ids[perm]
        self.rc2 = self.rc2[perm]
        self.pid = self.pid[perm]
        self.pair_pos = self.pair_pos[perm]
        self.offset = self.offset[perm]
        self.len_ = self.len_[perm]

    def unique(self):
        """Unique (ReadStack.cc:275): merge adjacent metadata-identical
        rows (cell union), then fold rows equal to row 0/1."""
        meta = np.stack(
            [
                self.ids,
                self.rc2.astype(np.int64),
                self.pid,
                self.pair_pos,
                self.offset,
                self.len_,
            ],
            axis=1,
        )
        n = self.rows
        to_remove = np.zeros(n, dtype=bool)
        i = 0
        while i < n:
            j = i + 1
            while j < n and (meta[j] == meta[i]).all():
                fill = (self.quals[i] < 0) & (self.quals[j] >= 0)
                self.bases[i, fill] = self.bases[j, fill]
                self.quals[i, fill] = self.quals[j, fill]
                to_remove[j] = True
                j += 1
            i = j
        for i in range(2):
            for j in range(2, n):
                if to_remove[j] or not (meta[j] == meta[i]).all():
                    continue
                to_remove[j] = True
                fill = (self.quals[i] < 0) & (self.quals[j] >= 0)
                self.bases[i, fill] = self.bases[j, fill]
                self.quals[i, fill] = self.quals[j, fill]
        self.erase(to_remove)

    # -- consensus ----------------------------------------------------------

    def _qual_weights(self):
        q = self.quals.astype(np.float64)
        w = np.where(q <= 2, np.minimum(q, 0.2), q)
        w = np.where(q == 0, 0.1, w)
        return np.where(self.quals >= 0, w, 0.0)

    def _base_sums(self, w):
        sums = np.zeros((4, self.cols))
        for b in range(4):
            sums[b] = np.where(self.bases == b, w, 0.0).sum(axis=0)
        return sums

    def column_consensus1(self):
        """ColumnConsensus1 winner per column (ReadStack.cc:2048); ties
        go to the LOWEST base id (std::max_element)."""
        sums = self._base_sums(self._qual_weights())
        return np.argmax(sums, axis=0).astype(np.uint8)

    def consensus1(self):
        """Consensus1 (ReadStack.cc:443): (con, conq)."""
        sums = self._base_sums(self._qual_weights())
        order = _metrics_order(sums)
        con = order[0].astype(np.uint8)
        val0 = np.take_along_axis(sums, order[:1], axis=0)[0]
        val1 = np.take_along_axis(sums, order[1:2], axis=0)[0]
        conq = np.minimum(QUAL_CAP, np.round(val0 - val1)).astype(np.int16)
        second = order[1]
        strong2 = ((self.quals >= 30) & (self.bases == second[None, :])).sum(
            axis=0
        )
        conq = np.where(
            (val1 > MAX_QCOMP) & (strong2 >= 2), 0, conq
        ).astype(np.int16)
        return con, conq

    def strong_consensus2(self, raise_zero):
        """StrongConsensus2 (ReadStack.cc:532): agreement-run-raised
        quality sums; con stays the Consensus1 winner.

        The per-row run-scan loops are vectorized: per cell, the
        enclosing agreement-run bounds come from running max/min of the
        nearest disagreeing position on either side, and the raise
        applies as one masked maximum (bit-identical: same libm log10)."""
        con = self.column_consensus1().astype(np.int8)
        min_window = 41
        R, C = self.rows, self.cols
        bsm = self.bases
        qs = self.quals.astype(np.float64)
        eq = bsm == con[None, :]
        t = np.arange(C)
        # i1 = run start (nearest disagreeing position to the left + 1)
        i1 = (
            np.maximum.accumulate(np.where(~eq, t[None, :], -1), axis=1)
            + 1
        )
        # i2 = run end (nearest disagreeing position to the right), excl.
        lfr = np.maximum.accumulate(
            np.where(~eq[:, ::-1], t[None, :], -1), axis=1
        )[:, ::-1]
        i2 = (C - 1) - lfr
        dist = np.minimum(t[None, :] - i1, i2 - t[None, :] - 1)
        mask = eq & (i2 - i1 >= min_window) & (2 * dist >= min_window)
        if not raise_zero:
            mask &= qs != 0
        # 5*log10(2*dist) via a small gather table (dist < C); math.log10
        # per entry, not np.log10 — numpy's SIMD log can differ by 1 ulp
        # from libm and the sequential form used libm
        dt = np.zeros(C + 1)
        for dd in range(1, C + 1):
            dt[dd] = 5.0 * math.log10(2 * dd)
        q = np.where(mask, np.maximum(qs, dt[np.clip(dist, 0, C)]), qs)
        d = qs >= 0
        p = np.where(q <= 2, np.minimum(q, 0.2), q)
        p = np.where(q == 0, 0.1, p)
        p = np.where(d, p, 0.0)
        qsum = np.zeros((4, C))
        for b in range(4):
            qsum[b] = np.where(bsm == b, p, 0.0).sum(axis=0)
        sorder = _metrics_order(qsum)
        val0 = np.take_along_axis(qsum, sorder[:1], axis=0)[0]
        val1 = np.take_along_axis(qsum, sorder[1:2], axis=0)[0]
        conq = np.minimum(QUAL_CAP, np.round(val0 - val1)).astype(np.int16)
        second = sorder[1]
        strong2 = ((self.quals >= 30) & (self.bases == second[None, :])).sum(
            axis=0
        )
        conq = np.where(
            (val1 > MAX_QCOMP) & (strong2 >= 2), 0, conq
        ).astype(np.int16)
        return con.astype(np.uint8), conq

    # -- filters -------------------------------------------------------------

    def high_qual_diff(self, n, top):
        """HighQualDiff (ReadStack.cc:597)."""
        suspect = np.zeros(self.rows, dtype=bool)
        for t in range(min(top, self.rows)):
            mism = (
                (self.bases != self.bases[t][None, :])
                & (self.quals >= n)
                & (self.quals[t][None, :] >= n)
            )
            suspect |= mism.any(axis=1)
        suspect[:top] = False
        return suspect

    def high_qual_diff_window(self):
        """HighQualDiffWindow (ReadStack.cc:2078): w=10 founder windows
        confirmed by another all->=Q10 identical row; rows with >=3
        diffs of total qual >=30 in a confirmed window are flagged."""
        w, min_diffs, min_qsum, min_qual = 10, 3, 30, 10
        R, C = self.rows, self.cols
        if C < w or R < 2:
            return np.zeros(R, dtype=bool)
        P = C - w + 1
        bw = np.lib.stride_tricks.sliding_window_view(self.bases, w, axis=1)
        qw = np.lib.stride_tricks.sliding_window_view(self.quals, w, axis=1)
        f_def = (self.quals[0, :P] >= 0) & (self.quals[0, w - 1 :] >= 0)
        eq_all = (bw[1:] == bw[0][None]).all(axis=2)
        hq_all = (qw[1:] >= min_qual).all(axis=2)
        confirmed = f_def & (eq_all & hq_all).any(axis=0)
        if not confirmed.any():
            return np.zeros(R, dtype=bool)
        row_def = (qw[1:, :, 0] >= 0) & (qw[1:, :, w - 1] >= 0)
        mism = bw[1:] != bw[0][None]
        diffs = mism.sum(axis=2)
        qsum = np.where(mism, qw[1:], 0).sum(axis=2)
        flag = (
            confirmed[None, :]
            & row_def
            & (diffs >= min_diffs)
            & (qsum >= min_qsum)
        ).any(axis=1)
        return np.concatenate([[False], flag])

    def clean_columns(self, top):
        """CleanColumns (ReadStack.cc:610)."""
        MIN_Q, MIN_COUNT = 20, 3
        counts = np.zeros((4, self.cols), dtype=np.int64)
        for b in range(4):
            counts[b] = ((self.bases == b) & (self.quals >= MIN_Q)).sum(axis=0)
        active = (counts >= MIN_COUNT).sum(axis=0) >= 2
        suspect = np.zeros(self.rows, dtype=bool)
        for t in range(min(top, self.rows)):
            tb = self.bases[t].astype(np.int64)
            tsup = (
                np.take_along_axis(counts, np.clip(tb, 0, 3)[None], axis=0)[0]
                >= MIN_COUNT
            ) & (tb >= 0)
            mism = (
                active[None, :]
                & (self.bases != self.bases[t][None, :])
                & (self.quals >= MIN_Q)
                & (self.quals[t][None, :] >= MIN_Q)
                & tsup[None, :]
            )
            suspect |= mism.any(axis=1)
        suspect[:top] = False
        return suspect

    def flag_noise(self):
        """FlagNoise (ReadStack.cc:1923): rows without a homopolymer-
        capped >=20-base agreement run with the founder."""
        min_glue, hp_cap = 20, 10
        R, C = self.rows, self.cols
        out = np.zeros(R, dtype=bool)
        if R < 2:
            return out
        f = self.bases[0]
        for j in range(1, R):
            r = self.bases[j]
            eq = r == f
            ok = False
            i = 0
            while i < C and not ok:
                if not eq[i]:
                    i += 1
                    continue
                k = i
                while k < C and eq[k]:
                    k += 1
                # capped length of run [i, k) on the read's chars
                run = r[i:k]
                capped = 0
                a = 0
                while a < len(run):
                    b = a
                    while b < len(run) and run[b] == run[a]:
                        b += 1
                    capped += min(hp_cap, b - a)
                    a = b
                if capped >= min_glue:
                    ok = True
                i = k
            out[j] = not ok
        return out

    def raise1(self, rid, rwindow=11, require_unedited=True):
        """Raise1 (ReadStack.cc:770): raise sub-Q30 centers of clean
        founder windows supported by >=3 clean Q30 friends, unless a Q30
        alternate hypothesis also has >=3 support."""
        min_agree, critical_q = 3, 30
        R, C = self.rows, self.cols
        if C < rwindow:
            return
        half = rwindow // 2
        P = C - rwindow + 1
        bw = np.lib.stride_tricks.sliding_window_view(self.bases, rwindow, axis=1)
        qw = np.lib.stride_tricks.sliding_window_view(self.quals, rwindow, axis=1)
        fb, fq = bw[rid], qw[rid]
        centers_q = fq[:, half]
        cand = centers_q < critical_q
        if require_unedited:
            cand &= ~(fq == 0).any(axis=1)
        cand &= centers_q != 0
        cand &= (fq >= 0).all(axis=1)
        if not cand.any():
            return
        others = np.arange(R) != rid
        ob, oq = bw[others], qw[others]
        clean = ((oq > 0) & (ob == fb[None])).all(axis=2)
        q30c = oq[:, :, half] >= critical_q
        support = (clean & q30c).sum(axis=0)
        cand &= support >= min_agree
        if not cand.any():
            return
        # alternate hypotheses: clean except center, Q30 center, different base
        side = np.ones(rwindow, dtype=bool)
        side[half] = False
        clean_side = ((oq > 0) & (ob == fb[None]))[:, :, side].all(axis=2)
        alt_rows = clean_side & q30c & (ob[:, :, half] != fb[None, :, half])
        alt_counts = np.zeros((4, P), dtype=np.int64)
        for b in range(4):
            alt_counts[b] = (alt_rows & (ob[:, :, half] == b)).sum(axis=0)
        cand &= alt_counts.max(axis=0) < min_agree
        centers = np.flatnonzero(cand) + half
        self.quals[rid, centers] = critical_q

    def motif_diff(self, top):
        """MotifDiff (ReadStack.cc:950): width-10 stripes; delete rows
        carrying a high-multiplicity motif that has a founder-Q20 diff
        from the founder's own high-multiplicity motif."""
        WIDTH, MIN_MULT = 10, 10
        R, C = self.rows, self.cols
        to_delete = np.zeros(R, dtype=bool)
        for i in range(0, C - WIDTH + 1, WIDTH):
            stripe = self.bases[:, i : i + WIDTH]
            full = (stripe >= 0).all(axis=1)
            idx = np.flatnonzero(full)
            if len(idx) == 0:
                continue
            rows = stripe[idx]
            # rows are base codes 0..3 over WIDTH=10 columns: pack each
            # into one uint64 key (np.unique on void dtypes is
            # memcmp-per-compare); group membership is all that matters
            # downstream, not group order
            shifts = (np.arange(rows.shape[1], dtype=np.uint64) * 2)
            vals = (rows.astype(np.uint64) << shifts).sum(
                axis=1, dtype=np.uint64
            )
            uniq, inv, cnt = np.unique(
                vals, return_inverse=True, return_counts=True
            )
            big = np.flatnonzero(cnt >= MIN_MULT)
            if len(big) == 0:
                continue
            # founder/top motif among bigs?
            this_one = -1
            for m in range(min(top, R)):
                if not full[m]:
                    continue
                pos = np.searchsorted(idx, m)
                g = inv[pos]
                if cnt[g] >= MIN_MULT:
                    this_one = g
                    break
            if this_one < 0:
                continue
            fq = self.quals[0, i : i + WIDTH]
            these = rows[np.flatnonzero(inv == this_one)[0]]
            for g in big:
                if g == this_one:
                    continue
                those = rows[np.flatnonzero(inv == g)[0]]
                hq_diff = ((those != these) & (fq >= 20)).any()
                if not hq_diff:
                    continue
                to_delete[idx[inv == g]] = True
        return to_delete

    def pair_weak1(self):
        """PairWeak1 (ReadStack.cc:866): columns decided by both-mates-
        present rows flag Q30 dissenters."""
        R, C = self.rows, self.cols
        # pair_pos in {-1,0,1}: pack (pid, pair_pos) into one int64 key
        # (np.unique(axis=0) views rows as void and memcmp-sorts)
        packed = self.pid.astype(np.int64) * 4 + (
            self.pair_pos.astype(np.int64) + 1
        )
        uniq_packed = np.unique(packed)
        pids, cnts = np.unique(uniq_packed >> 2, return_counts=True)
        both = set(pids[cnts >= 2].tolist())
        paired = np.array([p in both for p in self.pid])
        suspect = np.zeros(R, dtype=bool)
        if not paired.any():
            return suspect
        w = np.where(
            paired[:, None] & (self.quals >= 0), self.quals, 0
        ).astype(np.int64)
        sums = np.zeros((4, C), dtype=np.int64)
        for b in range(4):
            sums[b] = np.where(self.bases == b, w, 0).sum(axis=0)
        order = _metrics_order(sums.astype(np.float64))
        val0 = np.take_along_axis(sums.astype(np.float64), order[:1], axis=0)[0]
        val1 = np.take_along_axis(sums.astype(np.float64), order[1:2], axis=0)[0]
        win = order[0]
        decided = (val0 >= 100) & (val0 > 10 * val1) & (val1 < 100)
        bad = (
            decided[None, :]
            & (self.quals >= 30)
            & (self.bases >= 0)
            & (self.bases != win[None, :])
        )
        return bad.any(axis=1)

    # -- correction ----------------------------------------------------------

    def correct_all(self):
        """CorrectAll (ReadStack.cc:1212): returns (b, q, trim_to)."""
        R, C = self.rows, self.cols
        b = np.where(self.bases[0] >= 0, self.bases[0], 0).astype(np.uint8)
        q = self.quals[0].copy()
        min_win, min_win_ratio, max_lose = 50, 10, 100
        qf = self.quals.astype(np.float64)
        w = np.where(qf <= 2, np.minimum(qf, 0.2), qf)
        w = np.where(self.quals >= 0, w, 0.0)
        sums = np.zeros((4, C))
        tops = np.zeros((4, C), dtype=np.int64)
        for base in range(4):
            m = self.bases == base
            sums[base] = np.where(m, w, 0.0).sum(axis=0)
            tops[base] = np.where(m & (self.quals >= 0), self.quals, 0).max(
                axis=0, initial=0
            )
        order = _metrics_order(sums)
        winner = order[0]
        val0 = np.take_along_axis(sums, order[:1], axis=0)[0]
        sub = sums - tops  # competitors drop their top score
        val1 = np.take_along_axis(sub, order[1:2], axis=0)[0]
        ok = (val0 >= min_win) & (val0 >= min_win_ratio * val1) & (
            val1 <= max_lose
        )
        bad = ~ok
        trim_to = int(np.argmax(bad)) if bad.any() else C
        change = ok & (self.bases[0] != winner)
        b = np.where(change, winner, b).astype(np.uint8)
        q = np.where(change, 0, q).astype(np.int16)
        return b, q, trim_to

    def correct_all_em3(self):
        """CorrectAllEM3 (ReadStack.cc wrapper over run_EMEC3,
        src/paths/long/EMEC3.cc:601): EM friend/truth estimation on this
        stack; returns (b, q, trim_to)."""
        from .emec3 import run_emec3

        calls = self.bases.astype(np.int8)
        quals = np.where(self.quals >= 0, self.quals, 0).astype(np.uint8)
        t, q, _ = run_emec3(calls, quals)
        return t.astype(np.uint8), q.astype(np.int16), self.cols


# ---------------------------------------------------------------------------
# GetOffsets1 (ReadStack.cc:1360-1689)
# ---------------------------------------------------------------------------

_LOG10_BS_TABLE = None  # (N, N) log10 BinomialSum(n, k, 0.75), like gBS


def _log10_bs_table(nmax, w=20, p=0.75):
    """log10 of sum_{i<=k} C(n,i) p^i (1-p)^(n-i) (random/Bernoulli.cc:40)
    for n in [w, nmax], all k < n — the PrecomputedBinomialSums table
    (ReadStack.cc:52), computed in log space to survive large n."""
    global _LOG10_BS_TABLE
    if _LOG10_BS_TABLE is not None and _LOG10_BS_TABLE.shape[0] > nmax:
        return _LOG10_BS_TABLE
    N = max(nmax + 1, 256)
    tbl = np.zeros((N, N))
    lp, lq = math.log(p), math.log(1.0 - p)
    lg = np.concatenate([[0.0], np.cumsum(np.log(np.arange(1, N + 1)))])
    for n in range(w, N):
        i = np.arange(n + 1)
        lt = lg[n] - lg[i] - lg[n - i] + i * lp + (n - i) * lq
        acc = np.logaddexp.accumulate(lt)
        tbl[n, : n + 1] = acc / math.log(10.0)
    _LOG10_BS_TABLE = tbl
    return tbl


def get_offsets1(stack1: Stack, stack2: Stack):
    """Candidate merge offsets of stack2 onto stack1 by consensus
    shift-scoring.  Faithful to GetOffsets1's heuristics: 8-mer seed
    offsets, 40-wide bad-window veto (>=20 errors), binomial bits test
    (w=20, p=0.75, min_bits=25), founder-Q30 exclusion, mutual offset
    invalidation, and big-near-small suppression."""
    min_stretch, w = 8, 20
    min_bits, min_bits_save = 25.0, 40.0
    wx, max_ewx = 40, 20
    max_overlap = 1000

    con1, _ = stack1.consensus1()
    con2, _ = stack2.consensus1()
    n1, n2 = len(con1), len(con2)
    if max(n1, n2) >= max_overlap:
        return []

    # seed offsets from shared forward 8-mers of the consensuses
    def mers(c):
        if len(c) < min_stretch:
            return {}
        win = np.lib.stride_tricks.sliding_window_view(c, min_stretch)
        keys = {}
        mult = np.power(4, np.arange(min_stretch - 1, -1, -1), dtype=np.int64)
        vals = win.astype(np.int64) @ mult
        for pos, v in enumerate(vals):
            keys.setdefault(int(v), []).append(pos)
        return keys

    m1, m2 = mers(con1), mers(con2)
    doffsets = sorted(
        {
            p1 - p2
            for kmer, ps1 in m1.items()
            if kmer in m2
            for p1 in ps1
            for p2 in m2[kmer]
        }
    )
    if not doffsets:
        return []

    cand = []
    for o in doffsets:
        lo1 = max(0, o)
        hi1 = min(n1, o + n2)
        overlap = hi1 - lo1
        if overlap <= 0:
            continue
        a = con1[lo1:hi1]
        b = con2[lo1 - o : hi1 - o]
        mism_arr = a != b
        mismatch = int(mism_arr.sum())
        sum_errors = np.concatenate([[0], np.cumsum(mism_arr)])
        # bad windows (errs in the trailing wx positions >= max_ewx)
        bad_window = np.zeros(overlap, dtype=bool)
        if overlap >= wx:
            errs = 0
            for m in range(0, overlap - wx + 1):
                if mism_arr[m]:
                    errs += 1
                if m >= wx and mism_arr[m - wx]:
                    errs -= 1
                if errs >= max_ewx:
                    bad_window[max(0, m - wx)] = True
        tbl = _log10_bs_table(overlap)
        # for each start, the n-loop runs until the first bad window at
        # start+n-wx (checked only once n >= wx)
        bad_pos = np.flatnonzero(bad_window)
        minp = 0.0
        for start in range(overlap):
            nlim = overlap - start  # inclusive upper n
            nxt = bad_pos[np.searchsorted(bad_pos, start):]
            if len(nxt):
                nlim = min(nlim, int(nxt[0]) - start + wx - 1)
            if nlim < w:
                continue
            ns = np.arange(w, nlim + 1)
            ks = sum_errors[start + ns] - sum_errors[start]
            minp = min(minp, float(tbl[ns, ks].min()))
        bits = -minp * 10.0 / 6.0
        if bits >= min_bits:
            cand.append((o, overlap, mismatch, bits))

    # founder Q30 mismatch exclusion
    f1b, f1q = stack1.bases[0], stack1.quals[0]
    f2b, f2q = stack2.bases[0], stack2.quals[0]
    kept = []
    for o, overlap, mismatch, bits in cand:
        lo1 = max(0, o)
        hi1 = min(stack1.cols, o + stack2.cols)
        if hi1 > lo1:
            a_q = f1q[lo1:hi1]
            b_q = f2q[lo1 - o : hi1 - o]
            a_b = f1b[lo1:hi1]
            b_b = f2b[lo1 - o : hi1 - o]
            if ((a_q >= 30) & (b_q >= 30) & (a_b != b_b)).any():
                continue
        kept.append((o, overlap, mismatch, bits))
    cand = kept
    if not cand:
        return []

    # offset invalidation via flank-trimmed agreement intervals
    flank = 10
    val1 = []
    val2 = []
    for o, _, _, _ in cand:
        v1 = np.zeros(stack1.cols, dtype=bool)
        v2 = np.zeros(stack2.cols, dtype=bool)
        lo1 = max(0, o)
        hi1 = min(n1, o + n2)
        eq = con1[lo1:hi1] == con2[lo1 - o : hi1 - o]
        i = 0
        L = hi1 - lo1
        while i < L:
            if not eq[i]:
                i += 1
                continue
            k = i
            while k < L and eq[k]:
                k += 1
            for q1 in range(lo1 + i + flank, lo1 + k - flank):
                v1[q1] = True
                v2[q1 - o] = True
            i = k
        val1.append(v1)
        val2.append(v2)
    nc = len(cand)
    invalidates = np.zeros((nc, nc), dtype=bool)
    for i, (o, _, _, _) in enumerate(cand):
        lo1 = max(0, o)
        hi1 = min(n1, o + n2)
        mism_pos = np.flatnonzero(
            con1[lo1:hi1] != con2[lo1 - o : hi1 - o]
        )
        for mp in mism_pos:
            p1 = lo1 + mp
            p2 = p1 - o
            for j in range(nc):
                if val1[j][p1] and val2[j][p2]:
                    invalidates[j][i] = True
    to_delete = np.zeros(nc, dtype=bool)
    for i in range(nc):
        if invalidates[:, i].any():
            continue
        to_delete |= invalidates[i]
    cand = [c for c, d in zip(cand, to_delete) if not d]

    # big near small
    min_slope, min_add = 2.0, 10.0
    nd = len(cand)
    dele = [False] * nd
    for i1 in range(nd):
        for i2 in range(nd):
            if dele[i1]:
                continue
            if cand[i2][3] >= min_bits_save:
                continue
            delta = cand[i1][3] - cand[i2][3]
            if delta < min_add:
                continue
            do = abs(cand[i1][0] - cand[i2][0])
            if do and delta / do < min_slope:
                continue
            if do == 0:
                continue
            dele[i2] = True
    return [c[0] for c, d in zip(cand, dele) if not d]

"""The plain reference count: against a string-by-string model of the
upstream rules on small reads, and against the port at a 200 kb genome
(60x PE250) on the CPU, where the port runs its plain kernels."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import data
from benchmark.entries import rows_off
from benchmark.reference import count as ref

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def _model(reads, quals, k, min_qual, min_freq):
    """Strings: {canonical k-mer: [count, ctx]} kept at min_freq, and the histogram."""
    seen = {}
    for r, q in zip(reads, quals):
        glen = 0
        run = 0
        for i, qq in enumerate(q):
            run = run + 1 if qq >= min_qual else 0
            if run >= k and (i + 1 == len(q) or q[i + 1] < min_qual):
                glen = i + 1
        for p in range(glen - k + 1 if glen > k else 0):
            kmer = r[p : p + k]
            rc = "".join(COMP[c] for c in reversed(kmer))
            pred = r[p - 1] if p > 0 else None
            succ = r[p + k] if p + k < glen else None
            if rc < kmer:
                kmer, pred, succ = rc, (COMP[succ] if succ else None), (COMP[pred] if pred else None)
            ctx = (16 << "ACGT".index(pred) if pred else 0) | (1 << "ACGT".index(succ) if succ else 0)
            e = seen.setdefault(kmer, [0, 0])
            e[0] += 1
            e[1] |= ctx
    hist = np.zeros(101, dtype=np.int64)
    for c, _ in seen.values():
        hist[min(c, 255, 100)] += 1
    kept = {km: (min(c, 255), x) for km, (c, x) in seen.items() if min(c, 255) >= min_freq}
    return kept, hist


@pytest.mark.parametrize("k", [33, 48, 60, 64])
def test_reference_matches_the_string_model(k):
    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 400)
    reads, quals = [], []
    for i in range(300):
        s = int(rng.integers(0, 400 - 120))
        r = genome[s : s + 120].copy()
        if i % 2:
            r = 3 - r[::-1]
        if i % 7 == 0:
            r[int(rng.integers(0, 120))] = int(rng.integers(0, 4))
        q = rng.integers(30, 41, 120)
        q[rng.random(120) < 0.01] = 2
        reads.append(r)
        quals.append(q)
    # a palindrome: its forward form wins the tie
    pal = np.array([0, 1, 2, 3] * 30)[:k // 2]
    reads.append(np.concatenate([pal, 3 - pal[::-1], np.zeros(120 - 2 * (k // 2), dtype=np.int64)]))
    quals.append(np.full(120, 35))
    bases = np.array(reads, dtype=np.uint8)
    qual = np.array(quals, dtype=np.uint8)
    lengths = np.full(len(reads), 120, dtype=np.int32)
    got = ref.count(bases, qual, lengths, k, 7, 2)
    strs = ["".join("ACGT"[c] for c in r) for r in bases]
    kept, hist = _model(strs, [list(q) for q in qual], k, 7, 2)
    assert np.array_equal(got["hist"].numpy(), hist)
    codes = {c: i for i, c in enumerate("ACGT")}
    want = sorted(kept.items())
    assert len(want) == got["hi"].numel()
    for i, (km, (c, x)) in enumerate(want):
        cs = torch.tensor([[codes[ch] for ch in km]], dtype=torch.uint8)
        hi, lo = ref._keys(cs, k)
        assert (int(got["hi"][i]), int(got["lo"][i])) == (int(hi[0]), int(lo[0]))
        assert (int(got["count"][i]), int(got["ctx"][i])) == (c, x)


def test_good_lengths_rule():
    q = torch.tensor([[30] * 10 + [2] + [30] * 5, [30] * 16, [2] * 16, [30] * 6 + [2] + [30] * 6 + [2, 2, 2]])
    glen = ref.good_lengths(q, torch.tensor([16, 12, 16, 16]), 5, 7)
    assert glen.tolist() == [16, 12, 0, 13]


def test_reference_matches_the_port_at_200kb():
    from w2rap_contigger_tpu_torch.ops import kmer_engine

    with open(os.path.join(ROOT, "benchmark", "configs", "ecoli_k12_pe250.json")) as f:
        cfg = json.load(f)
    cfg["genome"] = {"genome_len": 200_000, "repeats": [{"copies": 3, "len": 5000}]}
    cfg["reads"]["pairs"] = 24_000
    bases, lengths, quals = data.make_reads(cfg, 2**31 + 5, "cpu")
    d, hist = kmer_engine.count_kmers_batched(bases, lengths, quals, 60, min_qual=7, min_freq=4,
                                              chunk_reads=8192, device="cpu")
    want = ref.count(bases, quals, lengths, 60, 7, 4)
    assert np.array_equal(np.asarray(hist), want["hist"].numpy())
    hi, lo = ref.keys_of_words(d.words)
    assert hi.numel() > 180_000
    assert rows_off([hi, lo, d.cnt, d.ctx], [want["hi"], want["lo"], want["count"], want["ctx"]]) == 0
    assert torch.equal(hi, want["hi"]) and torch.equal(lo, want["lo"])


def _graph_case(glen, pairs, copies, sub, seed):
    """(entry, the port's kept pass) of a small genome, on the CPU."""
    from benchmark import entries

    with open(os.path.join(ROOT, "benchmark", "configs", "ecoli_k12_pe250.json")) as f:
        cfg = json.load(f)
    cfg["genome"] = {"genome_len": glen, "repeats": [{"copies": copies, "len": 2000}]}
    cfg["reads"]["pairs"] = pairs
    cfg["reads"]["sub_rate"] = sub
    cfg["assembly"]["chunk_reads"] = 8192
    e = entries.SmallKGraph(cfg, data.make_reads(cfg, seed, "cpu"), "cpu")
    out = e.run_pass()
    e.record(out)
    return e, e.keep(out)


@pytest.mark.parametrize("case", [(200_000, 24_000, 3, 0.003, 2**31 + 11),
                                  (30_000, 2_000, 5, 0.02, 7)])
def test_graph_reference_matches_the_port(case):
    e, kept = _graph_case(*case)
    ref = e.reference()
    checks, failed = e.judge(kept, ref)
    assert failed == 0 and not any(checks.values()), checks
    assert len(ref["graph"].seqs) >= 10 and int(ref["offsets"][-1]) > case[1]
    if case[3] > 0.01:  # many edges: the heuristics and the extension work
        assert len(ref["graph"].seqs) > 300


@pytest.mark.parametrize("name,value", [("WEAK_SEED", 0), ("MIN_GAP", 10**6), ("LEFTOVER", 0)])
def test_graph_reference_is_sensitive_to_the_heuristics(name, value, monkeypatch):
    from benchmark.reference import graph as rg

    e, kept = _graph_case(30_000, 2_000, 5, 0.02, 7)
    monkeypatch.setattr(rg, name, value)
    assert e.judge(kept, e.reference())[0]["paths_off"] > 0

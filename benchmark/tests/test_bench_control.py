"""The checks that decide `correct` separate the program from what is
wrong: the control (the reference counting k-mers on their first 32 bases
alone) fails them, and a run whose timed path is broken underneath comes
out not correct.  CPU runs drive benchmark/run.py past its look for a
card, at a small genome; the `cuda` test reads the control at the cell's
own size."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import control, run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _small_config():
    with open(os.path.join(ROOT, "benchmark", "configs", "ecoli_k12_pe250.json")) as f:
        cfg = json.load(f)
    cfg["genome"] = {"genome_len": 20_000, "repeats": [{"copies": 3, "len": 1000}]}
    cfg["reads"]["pairs"] = 2400
    cfg["assembly"]["chunk_reads"] = 2048
    return cfg


def _run(seed=2**31 + 77):
    return run.run(["--workload", "ecoli.count", "--seed", str(seed), "--seconds", "0.5",
                    "--trace", "0"], device="cpu", config=_small_config())


def test_control_fails_and_the_program_passes():
    for rec in control.readings("ecoli.count", [2**31 + 1, 2**31 + 2, 2**31 + 3], device="cpu",
                                config=_small_config()):
        lim = rec["limits"]
        assert all(rec["program"][n] <= lim[n] for n in lim)
        assert any(rec["control"][n] > lim[n] for n in lim)


def test_a_sound_run_is_correct():
    res = _run()
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"


def _half_the_reads(real):
    def broken(bases, lengths, quals, k, **kw):
        return real(bases[::2], lengths[::2], quals[::2], k, **kw)
    return broken


def _one_count_altered(real):
    def broken(*a, **kw):
        d, hist = real(*a, **kw)
        d.cnt = d.cnt.clone()
        d.cnt[d.cnt.numel() // 2] += 1
        return d, hist
    return broken


def _one_context_altered(real):
    def broken(*a, **kw):
        d, hist = real(*a, **kw)
        ctx = d.ctx.clone()
        ctx[0] ^= 1
        d.ctx = ctx
        return d, hist
    return broken


def _histogram_altered(real):
    def broken(*a, **kw):
        d, hist = real(*a, **kw)
        hist = np.array(hist)
        hist[5] += 1
        return d, hist
    return broken


@pytest.mark.parametrize("fault", [_half_the_reads, _one_count_altered, _one_context_altered,
                                   _histogram_altered])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    from w2rap_contigger_tpu_torch.ops import kmer_engine

    monkeypatch.setattr(kmer_engine, "count_kmers_batched", fault(kmer_engine.count_kmers_batched))
    res = _run()
    assert res["correct"] is False and res["failed"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["ecoli.count", "yeast.count"])
def test_control_fails_at_the_cells_size(workload, card):
    seeds = [2**31 + 101, 2**31 + 102, 2**31 + 103]
    for rec in control.readings(workload, seeds, device="cuda"):
        lim = rec["limits"]
        assert all(rec["program"][n] <= lim[n] for n in lim)
        assert any(rec["control"][n] > lim[n] for n in lim)
    torch.cuda.empty_cache()

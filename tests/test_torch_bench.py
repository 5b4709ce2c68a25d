"""The port's benchmark (`python -m w2rap_contigger_tpu_torch.bench`) on
the CPU at a few hundred reads under the lax sort: its JSON line has the
keys of the repo root's bench.py, its chain's dictionary equals
count_kmers_device's and the JAX package's count, and without a card it
raises.  Tolerance: exact equality."""

import json

import numpy as np
import pytest
import torch

from w2rap_contigger_tpu.ops import kmer_engine as ke
from w2rap_contigger_tpu_torch import bench, state
from w2rap_contigger_tpu_torch.ops import kmer_engine as tke

READS = 256
# 256 reads of a 5 kb genome (about 10x in kmers): most kmers reach
# min_freq 4, so the dictionary is not empty
GENOME = 5000


def test_bench_line_on_cpu(monkeypatch, capsys):
    monkeypatch.delenv("W2RAP_SORT", raising=False)
    monkeypatch.setattr(bench, "GENOME_LEN", GENOME)
    bench.main(["--device", "cpu", "--reads", str(READS)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert line["metric"] == "k60_kmers_counted_per_sec_per_chip"
    assert line["unit"] == "kmers/s" and line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / bench.BASELINE_KMERS_PER_SEC)
    detail = line["detail"]
    assert detail["reads"] == READS and detail["kmer_windows"] == READS * (250 - 60 + 1)
    assert detail["sort_backend"] == "lax" and detail["device"] == "cpu"
    assert detail["chain_equals_count_kmers_device"] is True
    assert detail["radix_recounts"] == 0 and detail["dev_dict"] is True
    assert len(detail["chain_s"]) == bench.CHAINS
    assert detail["kernel_wall_s"] == sorted(detail["chain_s"])[bench.CHAINS // 2]
    for key in ("h2d_MBps", "d2h_MBps", "chain_max_memory_allocated", "card"):
        assert detail[key] is None  # card-only fields
    assert detail["launches_per_chain"] == {}  # plain versions launch nothing

    bases, lengths, quals = bench.synthetic_reads(READS)
    d, _ = tke.count_kmers_device(bases, lengths, quals, 60, device="cpu")
    assert detail["unique_kmers"] == d.size > 0
    assert detail["dict_sha256"] == bench.dict_sha256(d)
    jd, _ = ke.count_kmers(bases, lengths, quals, 60, min_freq=bench.MIN_FREQ)
    for got, want in zip(state.dict_to_numpy(d), (jd.words, jd.counts, jd.ctx)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_bench_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="never falls back"):
        bench.main(["--device", "cuda", "--reads", str(READS)])
    with pytest.raises(RuntimeError, match="never falls back"):
        bench.main(["--reads", str(READS)])  # cuda is the default

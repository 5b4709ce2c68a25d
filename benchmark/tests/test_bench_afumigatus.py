"""The A. fumigatus Af293 deployment and its cell, loaded as run.py loads
them: the configuration's file against its entry and the other
deployments' keys, each per-layer metric of the cell through run.reader
(SOURCE, LAYER, MOVES, UNIT against BENCHMARK.json), and a traced CPU run
of the cell at a small genome, forced into hash ranges by its
configuration's disk_batches, in which every one of them reads a value and
the unbatched count's spans read nothing.  The `cuda` tests run the cell's
count at its own size: two ranges within max_mem_gb, and the control
failing the checks that the program passes."""

import json

import pytest

from benchmark import control, data, entries, run

CELL = "afumigatus.count"
RANGE_METRICS = {"count.range.pack_s", "count.range.sizes_s", "count.range.kmerize_s",
                 "count.range.sort_s"}


def _config():
    spec, cell, conf, mix = run.spec_of(CELL)
    return spec, cell, conf, mix, run.load_json(conf["file"])


def test_configuration_is_the_deployment():
    spec, cell, conf, mix, cfg = _config()
    assert (cell["config"], cell["traffic"], cell["chips"]) == (cfg["name"], "count", 1)
    assert mix["entry"] == "count_kmers" and conf["reduced"] == []
    other = run.load_json("benchmark", "configs", "scerevisiae_s288c_pe250.json")
    assert set(cfg) == set(other)
    for group in ("genome", "reads", "assembly"):
        assert set(cfg[group]) == set(other[group])
    r, a = cfg["reads"], cfg["assembly"]
    assert cfg["windows_per_pass"] == 2 * r["pairs"] * (r["read_len"] - a["k"] + 1)
    assert 2 * r["pairs"] * r["read_len"] == r["coverage"] * cfg["genome"]["genome_len"]
    assert (a["k"], a["min_qual"], a["min_freq"], a["sort"]) == (60, 7, 4, "lax")
    assert a["max_mem_gb"] == 72 and a["disk_batches"] == 0
    assert "72 GiB" in cfg["guarantees"]


def test_the_cells_metrics_load_and_read_their_spans():
    spec = _config()[0]
    names = set()
    for m in run.metrics_of(spec["per_layer"], CELL):
        mod = run.reader(m)
        names.add(m["name"])
        assert mod.read({"passes": 4, "spans": {mod.SPAN: 2.0}}) == 0.5
        assert mod.read({"passes": 4, "spans": {"step2.count.sort": 2.0}}) is None
    assert names == RANGE_METRICS
    rates = [m for m in run.metrics_of(spec["end_to_end"], CELL)]
    assert {m["name"] for m in rates} == {"count_kmers_per_s", "peak_dev_gib", "setup_s"}


def test_a_traced_run_reads_every_range_metric():
    cfg = _config()[4]
    cfg = json.loads(json.dumps(cfg))
    cfg["genome"] = {"genome_len": 20_000, "repeats": [{"copies": 3, "len": 1000}]}
    cfg["reads"]["pairs"] = 1200
    cfg["assembly"]["chunk_reads"] = 1024
    cfg["assembly"]["disk_batches"] = 2
    res = run.run(["--workload", CELL, "--seed", str(2**31 + 29), "--seconds", "0.2",
                   "--trace", "1"], device="cpu", config=cfg)
    assert res["correct"] and res["failed"] == 0
    assert set(res["metrics"]) == RANGE_METRICS
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.cuda
def test_the_cells_count_runs_two_ranges_within_its_budget(card, monkeypatch):
    import torch

    from w2rap_contigger_tpu_torch import device as tdev

    cfg = _config()[4]
    monkeypatch.setenv("W2RAP_SORT", cfg["assembly"]["sort"])
    entry = entries.CountKmers(cfg, data.make_reads(cfg, 2**31 + 131, card), card)
    tdev.reset_launches()
    torch.cuda.reset_peak_memory_stats(card)
    out = entry.run_pass()
    peak = torch.cuda.max_memory_allocated(card)
    del out, entry
    torch.cuda.empty_cache()
    assert tdev.RANGED["counts"] == 1 and tdev.RANGED["ranges"] == 2
    assert peak <= cfg["assembly"]["max_mem_gb"] * (1 << 30)


@pytest.mark.cuda
def test_control_fails_at_the_cells_size(card):
    import torch

    for rec in control.readings(CELL, [2**31 + 132], device="cuda"):
        lim = rec["limits"]
        assert all(rec["program"][n] <= lim[n] for n in lim)
        assert any(rec["control"][n] > lim[n] for n in lim)
    torch.cuda.empty_cache()

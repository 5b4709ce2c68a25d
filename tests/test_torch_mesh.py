"""The port's mesh (parallel/mesh.py, --shard) on the CPU, against the JAX
package's mesh on its virtual 8-device CPU mesh and against its
unsharded path: the bucket hash, the sharded count (words, counts,
contexts, histogram) under each sort back end, list ranking, steps 2-3
with a mesh (HBV, paths, dictionaries), and the CLI's --shard /
W2RAP_SHARD clamp.  The port's meshes are D logical shards of the CPU
device, running the kernels' plain versions.  Tolerance: exact
equality."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from w2rap_contigger_tpu.core.reads import ReadSet as JReadSet
from w2rap_contigger_tpu.ops import kmer_engine as ke
from w2rap_contigger_tpu.parallel import mesh as pmesh
from w2rap_contigger_tpu.pipeline import step2_small_k as jstep2
from w2rap_contigger_tpu.pipeline import step3_repath as jstep3
from w2rap_contigger_tpu_torch import __main__ as cli
from w2rap_contigger_tpu_torch import device as tdev
from w2rap_contigger_tpu_torch import state
from w2rap_contigger_tpu_torch.core.reads import ReadSet
from w2rap_contigger_tpu_torch.graph import build as tgb
from w2rap_contigger_tpu_torch.ops import kmer_engine as tke
from w2rap_contigger_tpu_torch.ops import radix
from w2rap_contigger_tpu_torch.parallel import mesh as tmesh
from w2rap_contigger_tpu_torch.paths import flat_pather as tflat
from w2rap_contigger_tpu_torch.paths import pather as tpather
from w2rap_contigger_tpu_torch.pipeline import step2_small_k as tstep2
from w2rap_contigger_tpu_torch.pipeline import step3_repath as tstep3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cpu_mesh(D: int):
    return tmesh.make_mesh(["cpu"] * D)


def assert_dict_equal(d, words, counts, ctx, hist=None, ref_hist=None):
    got = state.dict_to_numpy(d)
    for a, b, name in zip(got, (words, counts, ctx), ("words", "counts", "ctx")):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    if ref_hist is not None:
        np.testing.assert_array_equal(hist, ref_hist)


def test_bucket_of_matches_jax():
    rng = np.random.default_rng(3)
    w = rng.integers(0, 1 << 31, size=4096).astype(np.uint32)
    w[::2] |= np.uint32(0x80000000)  # half with the top bit set
    for D in (2, 3, 4, 8):
        ref = np.asarray(pmesh._bucket_of(jnp.asarray(w[:, None]), D))
        got = tmesh.bucket_of(torch.from_numpy(w.astype(np.int64)), D)
        np.testing.assert_array_equal(got.numpy(), ref)
        # the same from raw int32 bits, as K1 writes them
        got32 = tmesh.bucket_of(torch.from_numpy(w.view(np.int32)), D)
        np.testing.assert_array_equal(got32.numpy(), ref)
        assert len(np.unique(ref)) == D


@pytest.fixture(scope="module")
def count_case():
    """tests/test_mesh.py:81's reads (k=60, 136 reads of which 40 are
    duplicates, min_freq=2; its rng fixture's draw).  Its uniform 0-40
    qualities leave no 60-base window above min_qual 7, so it counts no
    kmer; "hq" floors the same qualities at 7 with 0.3% of the bases at
    2 (1090 kmers kept).  The JAX mesh's count of "hq" on 8 devices, and
    the JAX package's unsharded count of both."""
    rng = np.random.default_rng(1234)
    n, L = 96, 120
    bases = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    lengths = rng.integers(70, L + 1, size=n).astype(np.int32)
    quals = rng.integers(0, 41, size=(n, L)).astype(np.uint8)
    bases = np.concatenate([bases, bases[:40]], axis=0)
    lengths = np.concatenate([lengths, lengths[:40]])
    quals = np.concatenate([quals, quals[:40]], axis=0)
    hq = np.maximum(quals, 7)
    hq[rng.random(hq.shape) < 0.003] = 2
    jmesh = pmesh.count_kmers_sharded(bases, lengths, hq, 60, pmesh.make_mesh(8),
                                      min_freq=2, chunk_reads=8)
    ref = {name: ke.count_kmers(bases, lengths, q, 60, min_freq=2, chunk_reads=32)
           for name, q in (("exact", quals), ("hq", hq))}
    return bases, lengths, {"exact": quals, "hq": hq}, jmesh, ref


def test_sharded_count_matches_jax_mesh(count_case):
    bases, lengths, quals, (jd, jhist), _ = count_case
    stats = {}
    d, hist = tke.count_kmers_sharded(bases, lengths, quals["hq"], 60, cpu_mesh(8),
                                      min_freq=2, chunk_reads=8, stats=stats)
    assert d.size == jd.size > 0 and d.device == torch.device("cpu")
    assert_dict_equal(d, jd.words, jd.counts, jd.ctx, hist, jhist)
    assert len(stats["rows"]) == 8 and min(stats["rows"]) > 0
    assert 0 < stats["exchanged_rows"] < sum(stats["rows"])
    assert stats["exchanged_bytes"] == 4 * 4 * stats["exchanged_rows"]  # W=4, ctx in pad


def test_timed_synchronises_every_device(monkeypatch):
    """timed(name, [d0, d1]) waits for both cards (each once, in order);
    a CPU device waits for nothing."""
    from w2rap_contigger_tpu_torch import device as tdev

    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: synced.append(dev))
    d0, d1 = torch.device("cuda:0"), torch.device("cuda:1")
    with tdev.timed("mesh.span", [d0, d1, d0]):
        assert synced == []
    assert synced == [d0, d1]
    synced.clear()
    with tdev.timed("one.span", d1):
        pass
    with tdev.timed("cpu.span", ["cpu", "cpu"]):
        pass
    assert synced == [d1]


def test_sharded_count_spans_wait_for_the_mesh(count_case, monkeypatch):
    """Each span of the sharded count covers its phase over every shard:
    .kmerize, .size, .exchange, .sort, .collapse and .gather each open
    once and name mesh.devices."""
    bases, lengths, quals, _, _ = count_case
    spans = {}
    timed = tke.timed

    def record(name, device):
        spans.setdefault(name.rsplit(".", 1)[-1], []).append(device)
        return timed(name, device)

    monkeypatch.setattr(tke, "timed", record)
    mesh = cpu_mesh(4)
    tke.count_kmers_sharded(bases, lengths, quals["hq"], 60, mesh, min_freq=2, chunk_reads=8)
    assert set(spans) == {"kmerize", "size", "exchange", "sort", "collapse", "gather"}
    for name, devices in spans.items():
        assert devices == [mesh.devices], name


def test_sharded_count_waits_do_not_grow_with_chunks(count_case):
    """4 shards of 34 reads in chunks of 34 (4 chunks) and of 9 (16): the
    same dictionary and histogram, the same host waits (the sizes, the
    epilogue's read back, the histograms), every owner's sort and K2
    enqueued before the epilogue's wait, and no wait inside a round of
    enqueues."""
    bases, lengths, quals, _, ref = count_case
    mesh = cpu_mesh(4)
    runs = []
    for chunk_reads, chunks in ((34, 4), (9, 16)):
        tdev.reset_host_waits()
        stats = {}
        d, hist = tke.count_kmers_sharded(bases, lengths, quals["hq"], 60, mesh, min_freq=2,
                                          chunk_reads=chunk_reads, stats=stats)
        events = list(tdev.EVENTS)
        assert min(stats["rows"]) > 0 and stats["owner_ms"] == [None] * 4
        assert events.count(("enqueue", "size:0")) == chunks // 4
        assert [e for e in events if e[0] == "wait"] == [
            ("wait", "sizes"), ("wait", "epilogue"), ("wait", "histogram")]
        epilogue = events.index(("wait", "epilogue"))
        for o in range(4):
            assert ("enqueue", f"sort:{o}") in events[:epilogue]
            assert ("enqueue", f"collapse:{o}") in events[:epilogue]
        assert tdev.waits_inside_rounds(events) == []
        runs.append((d, hist, tdev.HOST_WAITS))
    (d4, h4, w4), (d16, h16, w16) = runs
    assert w4 == w16 == 3
    assert_dict_equal(d16, *state.dict_to_numpy(d4), h16, h4)
    jd, jhist = ref["hq"]
    assert_dict_equal(d4, jd.words, jd.counts, jd.ctx, h4, jhist)


def test_waits_inside_rounds():
    """A wait between two shards' enqueues of one round is reported; one
    where a stage's round restarts is not."""
    ok = [("enqueue", "lookup:0"), ("enqueue", "lookup:1"), ("wait", "lookup"),
          ("enqueue", "lookup:0"), ("enqueue", "sort:0"), ("enqueue", "sort:1")]
    assert tdev.waits_inside_rounds(ok) == []
    bad = [("enqueue", "sort:0"), ("wait", "flags"), ("enqueue", "sort:1")]
    assert tdev.waits_inside_rounds(bad) == [("sort:0", "flags", "sort:1")]


def test_sharded_flat_count_prepares_each_chunk_once(monkeypatch):
    """count_kmers_flat(mesh=) makes each chunk's host arrays once for
    both passes, and equals the unsharded count at three host waits."""
    rng = np.random.default_rng(5)
    flat = rng.integers(0, 4, size=20000).astype(np.uint8)
    seg = np.array([0, 7000, 7050, 15000, 20000])
    starts = []
    orig = tke._flat_chunk_host
    monkeypatch.setattr(tke, "_flat_chunk_host",
                        lambda *a: starts.append(a[3]) or orig(*a))
    tdev.reset_host_waits()
    d = tke.count_kmers_flat(flat, seg, 31, chunk_pos=1024, device="cpu", mesh=cpu_mesh(4))
    assert tdev.HOST_WAITS == 3 and tdev.waits_inside_rounds(tdev.EVENTS) == []
    assert sorted(starts) == list(range(0, len(flat) - 30, 1024))
    ref = tke.count_kmers_flat(flat, seg, 31, chunk_pos=1024, device="cpu")
    assert d.size > 0
    assert_dict_equal(d, *state.dict_to_numpy(ref))


def test_sharded_pathers_wait_once_a_round(slice_case):
    """path_reads and path_flat_sequences on 4 logical shards give the
    unsharded calls' paths, with one host wait a round, after every shard
    of the round enqueued its lookup."""
    seqs, quals, _, _ = slice_case
    reads = ReadSet.from_sequences(seqs, quals)
    d, _ = tke.count_kmers_device(reads.bases, reads.lengths, reads.quals, 60,
                                  min_freq=2, device="cpu")
    tgb.recompute_adjacencies(d)
    hbv, fx, rx = tgb.build_hbv_from_edges(*tgb.build_unitigs(d), 60)
    mesh = cpu_mesh(4)
    ref = tpather.path_reads(reads, d, hbv, fx, rx, chunk_reads=64)
    tdev.reset_host_waits()
    got = tpather.path_reads(reads, d, hbv, fx, rx, chunk_reads=64, mesh=mesh)
    assert len(ref.edges) > 0
    for key in ("offsets", "edges", "start"):
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key), err_msg=key)
    events = list(tdev.EVENTS)
    assert tdev.HOST_WAITS == 4 and events[:5] == [
        *(("enqueue", f"lookup:{i}") for i in range(4)), ("wait", "lookup")]
    assert tdev.waits_inside_rounds(events) == []

    flat = np.concatenate([np.asarray(q, dtype=np.uint8) for q in seqs])
    seg = np.arange(0, len(flat) + 1, 150)
    ref = tflat.path_flat_sequences(flat, seg, d, hbv, fx, rx, chunk_pos=2048)
    tdev.reset_host_waits()
    got = tflat.path_flat_sequences(flat, seg, d, hbv, fx, rx, chunk_pos=2048, mesh=mesh)
    assert sum(len(p) for p in ref[0]) > 0
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(a, b)
    rounds = -(-(len(flat) - 59) // 2048 // 4)
    events = list(tdev.EVENTS)
    assert tdev.HOST_WAITS == rounds == events.count(("wait", "lookup"))
    assert tdev.waits_inside_rounds(events) == []


def test_sharded_count_of_no_valid_window(count_case):
    """Every owner empty: each takes count_epilogue's empty branch on its
    own device, and the gathered dictionary is empty too."""
    bases, lengths, quals, _, ref = count_case
    jd, jhist = ref["exact"]
    stats = {}
    d, hist = tke.count_kmers_sharded(bases, lengths, quals["exact"], 60, cpu_mesh(4),
                                      min_freq=2, chunk_reads=8, stats=stats)
    assert d.size == jd.size == 0 and stats["rows"] == [0, 0, 0, 0]
    assert_dict_equal(d, jd.words, jd.counts, jd.ctx, hist, jhist)


@pytest.mark.parametrize("sort", ["lax", "radix", "pallas"])
@pytest.mark.parametrize("D", [2, 4])
def test_sharded_count_matches_jax_unsharded(count_case, monkeypatch, D, sort):
    """2 and 4 shards under each sort back end against the JAX package's
    unsharded count.  Radix tiles of 256 rows: owners of >= 1024 rows
    take the partition sort, smaller ones the lax path."""
    bases, lengths, quals, _, ref = count_case
    jd, jhist = ref["hq"]
    monkeypatch.setattr(radix, "DEFAULT_TILE_ROWS", 2)
    monkeypatch.setattr(radix, "DEFAULT_REGION_ROWS", 64)
    monkeypatch.setenv("W2RAP_SORT", sort)
    sorts = []
    orig = radix.partition_sort
    monkeypatch.setattr(radix, "partition_sort",
                        lambda p, *a, **kw: sorts.append(p.shape[1]) or orig(p, *a, **kw))
    d, hist = tke.count_kmers_sharded(bases, lengths, quals["hq"], 60, cpu_mesh(D),
                                      min_freq=2, chunk_reads=16)
    assert_dict_equal(d, jd.words, jd.counts, jd.ctx, hist, jhist)
    assert (len(sorts) > 0) == (sort == "radix")


@pytest.mark.parametrize("case", ["tiled_read", "homopolymer"])
def test_sharded_count_skewed(case):
    """tests/test_mesh.py:110's skew (32 copies of one 64-base read, k=31:
    every kmer 32 times), and reads of one base, whose single kmer puts
    every row in one shard (count saturating at 255)."""
    rng = np.random.default_rng(1234)
    n, L, k = 32, 64, 31
    one = rng.integers(0, 4, size=L).astype(np.uint8)
    if case == "homopolymer":
        one[:] = 2
    bases = np.tile(one, (n, 1))
    lengths = np.full(n, L, dtype=np.int32)
    quals = np.full((n, L), 35, dtype=np.uint8)
    jd, jhist = ke.count_kmers(bases, lengths, quals, k, min_freq=1)
    stats = {}
    d, hist = tke.count_kmers_sharded(bases, lengths, quals, k, cpu_mesh(8), min_freq=1,
                                      chunk_reads=4, stats=stats)
    assert_dict_equal(d, jd.words, jd.counts, jd.ctx, hist, jhist)
    if case == "homopolymer":
        assert d.size == 1 and int(d.cnt[0]) == 255
        assert sorted(stats["rows"]) == [0] * 7 + [n * (L - k + 1)]


def test_list_rank_sharded_matches_jax():
    """tests/test_mesh.py:166's links (2M = 128 nodes, 8 shards)."""
    rng = np.random.default_rng(1234)
    nxt = rng.integers(-1, 128, size=128).astype(np.int32)
    ref = pmesh.list_rank_sharded(pmesh.make_mesh(8), jnp.asarray(nxt), 9)
    got = tmesh.list_rank_sharded(cpu_mesh(8), torch.from_numpy(nxt.astype(np.int64)), 9)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("D", [3, 4, 8, 128])
def test_list_rank_sharded_uneven_slices(D):
    """A node space (2M = 74) that no 2D divides: ceiling slices, the last
    short or empty, against the port's unsharded list_rank."""
    rng = np.random.default_rng(D)
    nxt = torch.from_numpy(rng.integers(-1, 74, size=74))
    for a, b in zip(tmesh.list_rank_sharded(cpu_mesh(D), nxt, 8), tgb.list_rank(nxt, 8)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def slice_case():
    """tests/test_mesh.py:30's genome (2 kb, 256 reads of 150 bases, its
    rng fixture's draw) through the JAX package's steps 2 and 3 (K2=128)."""
    rng = np.random.default_rng(1234)
    genome = rng.integers(0, 4, size=2000).astype(np.uint8)
    n, L = 256, 150
    starts = rng.integers(0, len(genome) - L, size=n)
    seqs = [genome[s : s + L] for s in starts]
    quals = [np.full(L, 35, np.uint8) for _ in seqs]
    hbv, paths, d = jstep2.build_read_q_graph(JReadSet.from_sequences(seqs, quals),
                                             chunk_reads=512, min_freq=2)
    hbv2, paths2, d2 = jstep3.repath(hbv, paths, 128)
    return seqs, quals, (hbv, paths, d), (hbv2, paths2, d2)


def assert_graph_equal(hbv, paths, ref_hbv, ref_paths):
    for key in ("edge_bases", "edge_start", "to_left", "to_right", "inv"):
        np.testing.assert_array_equal(getattr(hbv, key), getattr(ref_hbv, key), err_msg=key)
    for key in ("offsets", "edges", "start"):
        np.testing.assert_array_equal(getattr(paths, key), getattr(ref_paths, key),
                                      err_msg=key)


def test_slice_with_mesh_matches_jax(slice_case):
    """Steps 2 and 3 on 4 logical shards: the count, adjacencies, unitig
    links, list ranking, read paths, step 3's flat count and flat paths
    all sharded; HBV, paths and dictionaries equal the JAX package's."""
    seqs, quals, (jhbv, jpaths, jd), (jhbv2, jpaths2, jd2) = slice_case
    mesh = cpu_mesh(4)
    hbv, paths, d = tstep2.build_read_q_graph(ReadSet.from_sequences(seqs, quals),
                                              chunk_reads=64, min_freq=2, mesh=mesh)
    assert hbv.n_edges > 0 and len(paths.edges) > 0
    assert_graph_equal(hbv, paths, jhbv, jpaths)
    assert_dict_equal(d, jd.words, jd.counts, jd.ctx)
    hbv2, paths2, d2 = tstep3.repath(hbv, paths, 128, mesh=mesh)
    assert hbv2.n_edges > 0 and d2.size > 0
    assert_graph_equal(hbv2, paths2, jhbv2, jpaths2)
    assert_dict_equal(d2, jd2.words, jd2.counts, jd2.ctx)
    for dd, jj in ((d, jd), (d2, jd2)):
        np.testing.assert_array_equal(dd.edge_id, jj.edge_id)
        np.testing.assert_array_equal(dd.edge_offset, jj.edge_offset)


@pytest.mark.parametrize("asked,visible,want", [
    (-1, 1, None), (-1, 8, 8), (-1, 6, 4), (4, 3, 2), (4, 8, 4), (0, 8, None), (1, 8, None),
])
def test_auto_mesh_clamp(monkeypatch, asked, visible, want):
    """JAX auto_mesh's rule on `visible` cards (mesh.py:39-60); the cpu
    device shows one."""
    monkeypatch.delenv("W2RAP_SHARD", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    mesh = tmesh.auto_mesh(asked, "cuda")
    assert (mesh.size if mesh else None) == want
    if mesh:
        assert mesh.devices == tuple(torch.device("cuda", i) for i in range(want))
    assert tmesh.auto_mesh(asked, "cpu") is None
    monkeypatch.setenv("W2RAP_SHARD", "0")
    assert tmesh.auto_mesh(asked, "cuda") is None


def test_make_mesh_refuses_a_missing_card(monkeypatch):
    assert cpu_mesh(3).devices == (torch.device("cpu"),) * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="never falls back"):
        tmesh.make_mesh([torch.device("cuda")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="only 2 CUDA"):
        tmesh.make_mesh(["cuda:0", "cuda:2"])


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "make_synth_fastq.py"),
         str(out), "--glen", "12000", "--pairs", "1500", "--rlen", "250",
         "--insert", "500", "--seed", "42"],
        check=True, capture_output=True, timeout=300,
    )
    return f"{out}/reads_R1.fastq,{out}/reads_R2.fastq"


def test_cli_shard_clamps_to_visible_devices(fastq, tmp_path, capsys, monkeypatch):
    """--shard 4 and W2RAP_SHARD=4 with --device cpu (one device visible):
    no raise, the clamp line, and the outputs of --shard 0."""
    monkeypatch.delenv("W2RAP_SHARD", raising=False)
    base = ["-r", fastq, "--to_step", "3", "--device", "cpu", "--dump_all"]
    runs = {}
    for label, extra, env in (("off", ["--shard", "0"], None), ("flag", ["--shard", "4"], None),
                              ("env", [], "4")):
        if env is not None:
            monkeypatch.setenv("W2RAP_SHARD", env)
        capsys.readouterr()
        cli.main(["-o", str(tmp_path / label), *base, *extra])
        runs[label] = capsys.readouterr().out
    assert "--shard" not in runs["off"]
    for label in ("flag", "env"):
        assert "--shard 4: 1 cpu device(s) visible" in runs[label]
        assert "sharding over" not in runs[label]
        with open(tmp_path / "off" / "small_K.freqs", "rb") as a, \
                open(tmp_path / label / "small_K.freqs", "rb") as b:
            assert a.read() == b.read()
        for name in ("pe.small_K.hbv.npz", "pe.small_K.paths.npz", "pe.large_K.hbv.npz",
                     "pe.large_K.paths.npz"):
            za, zb = np.load(tmp_path / "off" / name), np.load(tmp_path / label / name)
            for key in za.files:
                np.testing.assert_array_equal(zb[key], za[key], err_msg=f"{name}:{key}")

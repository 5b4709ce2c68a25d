"""The step-5 slice (AssembleGaps2 + AddNewStuff + PartnersToEnds) and
steps 6-7 (Simplify, FindLines, MakeGaps, FinalFiles) through the CLI:
the port against the JAX package, exactly.

- tests/test_assemble_gaps.py's dip data: assemble_gaps2 with 1 and 4
  blob threads gives the JAX package's new_stuff in order, then
  add_new_stuff and partners_to_ends give its graph and paths;
- the CLI: steps 1-7 (--device cpu) against run_pipeline(to_step=7) on a
  40 kb genome with 4 repeat copies, 2 coverage dips and 0.3% errors,
  every checkpoint through large_K.final equal and small_K.freqs byte
  for byte, with at least one blob solved and one piece added; every
  step 6-7 file equal (pe.contig.*, a.lines.fasta, stats,
  a.fin.frags.dist, the a_contigs and pe_assembly GFA files), with
  Simplify deleting edges; --from_step 5, 6 and 7 on the JAX package's
  checkpoints, and the JAX package's loaders on the port's large_K.final
  and pe.contig;
- --path_finder --dump_pf from step 6 on both packages, then
  --dev_run_test pathfinder and pathfinder2 on both: every pf_*
  checkpoint and output equal;
- hbv2gfa on pe.contig, with and without -g: stdout and GFA equal;
- W2RAP_BLOB_POOL=proc raises once CUDA is up;
- on a card (skipped here), the GPU run equals the CPU run.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from w2rap_contigger_tpu import __main__ as jax_cli
from w2rap_contigger_tpu import hbv2gfa as jax_hbv2gfa
from w2rap_contigger_tpu.core import dna
from w2rap_contigger_tpu.core.reads import ReadSet
from w2rap_contigger_tpu.graph import build as jgb
from w2rap_contigger_tpu.graph.hbv import HyperBasevector as JHBV
from w2rap_contigger_tpu.ops import kmer_engine as jke
from w2rap_contigger_tpu.paths import extend as jextend
from w2rap_contigger_tpu.paths import pather as jpather
from w2rap_contigger_tpu.paths.partners import partners_to_ends as jpartners
from w2rap_contigger_tpu.paths.read_paths import ReadPathVec as JRPV
from w2rap_contigger_tpu.pipeline import step5_gaps as j5
from w2rap_contigger_tpu.pipeline.driver import run_pipeline
from w2rap_contigger_tpu_torch import __main__ as cli
from w2rap_contigger_tpu_torch import hbv2gfa
from w2rap_contigger_tpu_torch.core.reads import ReadSet as TReadSet
from w2rap_contigger_tpu_torch.graph.hbv import HyperBasevector
from w2rap_contigger_tpu_torch.paths.partners import partners_to_ends
from w2rap_contigger_tpu_torch.paths.read_paths import ReadPathVec
from w2rap_contigger_tpu_torch.pipeline import step5_gaps as t5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = tuple(
    f"pe.{step}.{kind}.npz"
    for step in ("small_K", "large_K", "large_K.clean", "large_K.final")
    for kind in ("hbv", "paths")
)
FINAL = ("pe.large_K.final.hbv.npz", "pe.large_K.final.paths.npz")
CONTIG = ("pe.contig.hbv.npz", "pe.contig.paths.npz")
# what steps 6-7 write when MakeGaps adds no gap (test_torch_step6.py
# covers pe_assembly.* and the rewritten line files)
STEP6_FILES = ("a.lines.fasta", "stats", "a.fin.frags.dist", "a_contigs_raw.gfa",
               "a_contigs_lines.gfa") + CONTIG
STEP7_FILES = ("pe_assembly_raw.gfa", "pe_assembly_lines.gfa")
PF = tuple(f"pf_{stage}.{kind}.npz" for stage in ("start", "unrolled_loops", "end")
           for kind in ("hbv", "paths"))
HBV_FIELDS = ("edge_bases", "edge_start", "to_left", "to_right", "inv")
PATH_FIELDS = ("offsets", "edges", "start")
PAIR_SAMPLE = 100  # below the default 200: smaller blobs, and the flag is passed through


def _same_graph(a, b):
    assert a.k == b.k and a.n_vertices == b.n_vertices
    for f in HBV_FIELDS:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)


def _same_paths(a, b):
    for f in PATH_FIELDS:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)


@pytest.fixture(scope="module")
def dip():
    """tests/test_assemble_gaps.py's data through the JAX package: a 6 kb
    genome whose 150 bp dip (coverage ~2) breaks the k=60 graph."""
    rng = np.random.default_rng(1234)
    k = 60
    genome = rng.integers(0, 4, size=6000).astype(np.uint8)
    rlen, insert = 150, 400
    g0, g1 = 3000, 3150
    seqs, quals = [], []
    dip_count = 0
    for s in range(0, 6000 - insert, 5):
        frag = genome[s : s + insert]
        s2 = s + insert - rlen
        touches_dip = not (s + rlen <= g0 or s >= g1) or not (s2 + rlen <= g0 or s2 >= g1)
        if touches_dip:
            dip_count += 1
            if dip_count % 12 != 0:
                continue
        seqs.extend([frag[:rlen], dna.revcomp_codes(frag[-rlen:])])
        quals.extend([np.full(rlen, 38, np.uint8)] * 2)
    reads = ReadSet.from_sequences(seqs, quals)
    d, _ = jke.count_kmers(reads.bases, reads.lengths, reads.quals, k, min_freq=4,
                           pad_quantum=1024)
    jgb.recompute_adjacencies(d)
    eb, es = jgb.build_unitigs(d)
    hbv, fx, rx = jgb.build_hbv_from_edges(eb, es, k)
    paths = jpather.path_reads(reads, d, hbv, fx, rx, chunk_reads=1024)
    paths = jextend.extend_paths(reads, paths, hbv)
    new_stuff = j5.assemble_gaps2(hbv, paths, reads)
    hbv2, paths2 = j5.add_new_stuff(hbv, paths, reads, new_stuff, chunk_reads=1024)
    paths3, _ = jpartners(hbv2, paths2, reads)
    port = (
        HyperBasevector(hbv.k, hbv.edge_bases, hbv.edge_start, hbv.to_left,
                        hbv.to_right, hbv.inv, hbv.n_vertices),
        ReadPathVec(paths.offsets, paths.edges, paths.start),
        TReadSet(reads.bases, reads.lengths, reads.quals),
    )
    return port, new_stuff, hbv2, paths3


def test_assemble_gaps2_add_new_stuff_partners_match_jax(dip):
    (hbv, paths, reads), want, jhbv2, jpaths3 = dip
    assert want
    for threads in (1, 4):
        stats = {}
        got = t5.assemble_gaps2(hbv, paths, reads, threads=threads, device="cpu",
                                stats=stats)
        assert stats["solved"] >= 1 and stats["pieces"] == len(want)
        assert len(got) == len(want)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)
    hbv2, paths2 = t5.add_new_stuff(hbv, paths, reads, got, chunk_reads=1024, device="cpu")
    paths3, _ = partners_to_ends(hbv2, paths2, reads)
    _same_graph(jhbv2, hbv2)
    _same_paths(jpaths3, paths3)
    assert int(hbv2.edge_len().max()) > 5000


def test_proc_blob_pool_refused_once_cuda_is_up(dip, monkeypatch):
    (hbv, paths, reads), _, _, _ = dip
    monkeypatch.setenv("W2RAP_BLOB_POOL", "proc")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="forked child cannot use CUDA"):
        t5._run_blobs_forked(hbv, paths, reads, None, [([0], [1])], hbv.k, 200, 100, 2,
                             torch.device("cpu"))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A 40 kb genome (4 copies of a 1 kb repeat, 2 coverage dips, 0.3%
    errors, 4800 PE250 pairs; seed 7, whose step 5 leaves Simplify edges
    to delete) through the JAX package's steps 1-7, blobs of at most
    PAIR_SAMPLE pairs."""
    out = tmp_path_factory.mktemp("step5")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "make_synth_fastq.py"),
         str(out), "--glen", "40000", "--pairs", "4800", "--rlen", "250",
         "--insert", "500", "--repeats", "4", "--repeat_len", "1000",
         "--dips", "2", "--err", "0.003", "--seed", "7"],
        check=True, capture_output=True, timeout=300,
    )
    fastq = f"{out}/reads_R1.fastq,{out}/reads_R2.fastq"
    jdir = str(out / "jax")
    run_pipeline(out_dir=jdir, read_spec=fastq, to_step=7, dump_all=True, shard_devices=0,
                 pair_sample=PAIR_SAMPLE)
    return fastq, jdir


@pytest.fixture(scope="module")
def port_run(jax_run, tmp_path_factory):
    """The same reads through the port's CLI, steps 1-7 with the CLI's
    defaults (--device cpu); returns its directory, the blob counts of
    step 5 and the CLI's result."""
    fastq, _ = jax_run
    tdir = str(tmp_path_factory.mktemp("step5_port"))
    stats = {}
    assemble_gaps2 = t5.assemble_gaps2

    def counted(*a, **kw):
        return assemble_gaps2(*a, stats=stats, **kw)

    t5.assemble_gaps2 = counted
    try:
        out = cli.main(["-r", fastq, "-o", tdir, "--device", "cpu",
                        "--pair_sample", str(PAIR_SAMPLE), "--dump_all", "--dump_perf"])
    finally:
        t5.assemble_gaps2 = assemble_gaps2
    return tdir, stats, out


def _same_files(a_dir, b_dir, names):
    """Every array of the npz files, every other file byte for byte."""
    for name in names:
        if not name.endswith(".npz"):
            with open(f"{a_dir}/{name}", "rb") as a, open(f"{b_dir}/{name}", "rb") as b:
                assert a.read() == b.read(), name
            continue
        za, zb = np.load(f"{a_dir}/{name}"), np.load(f"{b_dir}/{name}")
        assert sorted(za.files) == sorted(zb.files)
        for key in za.files:
            np.testing.assert_array_equal(zb[key], za[key], err_msg=f"{name}:{key}")


def _outputs(out_dir):
    """The files a run left, its timings (.perf) aside."""
    return sorted(n for n in os.listdir(out_dir) if not n.endswith(".perf"))


def _perf(out_dir):
    with open(f"{out_dir}/pe.perf") as f:
        return [line.split(",")[1].strip() for line in f]


def _copy(src, dst, names):
    os.makedirs(dst, exist_ok=True)
    for name in names:
        shutil.copy(f"{src}/{name}", dst)
    return dst


def test_step5_cli_matches_jax_pipeline(jax_run, port_run):
    _, jdir = jax_run
    tdir, stats, _ = port_run
    assert stats["solved"] >= 1 and stats["pieces"] >= 1
    with open(f"{jdir}/small_K.freqs", "rb") as a, open(f"{tdir}/small_K.freqs", "rb") as b:
        assert a.read() == b.read()
    _same_files(jdir, tdir, CHECKPOINTS)
    assert _perf(tdir) == ["ReadLoad", "SmallKGraph", "RepathInMemory", "Clean200x",
                           "AssembleGaps", "Simplify", "MakeGaps+FinalFiles"]
    # the JAX package's loaders read the port's final checkpoints
    _same_graph(HyperBasevector.load(f"{tdir}/{FINAL[0]}"), JHBV.load(f"{tdir}/{FINAL[0]}"))
    _same_paths(ReadPathVec.load(f"{tdir}/{FINAL[1]}"), JRPV.load(f"{tdir}/{FINAL[1]}"))


def test_from_step5_on_jax_checkpoints(jax_run, tmp_path):
    """Step 5 alone from the JAX package's large_K.clean checkpoints and
    reads, with --pair_sample and -t passed through."""
    _, jdir = jax_run
    out = str(tmp_path)
    for name in ("frag_reads_orig.npz", "pe.large_K.clean.hbv.npz",
                 "pe.large_K.clean.paths.npz"):
        shutil.copy(f"{jdir}/{name}", out)
    cli.main(["-o", out, "--from_step", "5", "--to_step", "5", "--device", "cpu",
              "-t", "2", "--pair_sample", str(PAIR_SAMPLE), "--dump_perf"])
    assert _perf(out) == ["AssembleGaps"]
    _same_files(jdir, out, FINAL)


def test_steps6_7_cli_match_jax_pipeline(jax_run, port_run):
    """Every file of steps 6-7 equal, with Simplify deleting edges; the
    CLI returns step 7's graph, and the JAX package's loaders read the
    port's pe.contig."""
    _, jdir = jax_run
    tdir, _, (hbv, paths, _) = port_run
    assert _outputs(tdir) == _outputs(jdir)
    assert set(STEP6_FILES + STEP7_FILES) <= set(_outputs(tdir))
    _same_files(jdir, tdir, STEP6_FILES + STEP7_FILES)
    final, contig = (HyperBasevector.load(f"{tdir}/{n}") for n in (FINAL[0], CONTIG[0]))
    assert contig.n_edges < final.n_edges
    _same_graph(contig, hbv)
    jh, jp = JHBV.load(f"{tdir}/{CONTIG[0]}"), JRPV.load(f"{tdir}/{CONTIG[1]}")
    _same_graph(hbv, jh)
    _same_paths(paths, jp)
    with open(f"{tdir}/stats") as f:
        assert f.read().endswith("cn_frac_good: 1.0\n")


def test_from_step6_and_7_on_jax_checkpoints(jax_run, tmp_path):
    """Step 6-7 from the JAX package's large_K.final (and reads), and step 7
    alone from its pe.contig."""
    _, jdir = jax_run
    out6 = _copy(jdir, str(tmp_path / "from6"), ("frag_reads_orig.npz",) + FINAL)
    cli.main(["-o", out6, "--from_step", "6", "--device", "cpu", "--dump_perf"])
    assert _perf(out6) == ["Simplify", "MakeGaps+FinalFiles"]
    _same_files(jdir, out6, STEP6_FILES + STEP7_FILES)
    out7 = _copy(jdir, str(tmp_path / "from7"), CONTIG)
    cli.main(["-o", out7, "--from_step", "7", "--device", "cpu", "--dump_perf"])
    assert _perf(out7) == ["MakeGaps+FinalFiles"]
    assert _outputs(out7) == sorted(CONTIG + STEP7_FILES)
    _same_files(jdir, out7, STEP7_FILES)


def test_pathfinder_replay_matches_jax(jax_run, tmp_path, capsys):
    """--path_finder --dump_pf from step 6, then --dev_run_test pathfinder
    and pathfinder2, on both packages: the log lines, the pf_*
    checkpoints and every output equal after each run, and the JAX
    package's loaders read the port's pf_* checkpoints."""
    _, jdir = jax_run
    inputs = ("frag_reads_orig.npz",) + FINAL
    jd, td = (_copy(jdir, str(tmp_path / name), inputs) for name in ("jax", "port"))
    runs = (
        (lambda: run_pipeline(out_dir=jd, from_step=6, path_finder=True, dump_pf=True,
                              shard_devices=0),
         lambda: cli.main(["-o", td, "--from_step", "6", "--path_finder", "--dump_pf",
                           "--device", "cpu"])),
    ) + tuple(
        (lambda t=test: jax_cli.main(["-o", jd, "--dev_run_test", t]),
         lambda t=test: cli.main(["-o", td, "--dev_run_test", t, "--device", "cpu"]))
        for test in ("pathfinder", "pathfinder2")
    )
    for jax_step, port_step in runs:
        jax_step()
        want_log = capsys.readouterr().out
        hbv = port_step()[0]
        assert capsys.readouterr().out == want_log
        assert "line_fw: " in want_log or "DONE!" in want_log
        assert _outputs(td) == _outputs(jd)
        _same_files(jd, td, [n for n in _outputs(jd) if n not in inputs])
        _same_graph(HyperBasevector.load(f"{td}/{CONTIG[0]}"), hbv)
    assert set(PF) < set(_outputs(td)) and "pf_after_loops.hbv.npz" in _outputs(td)
    for name in _outputs(td):
        if name.startswith("pf_") and ".hbv." in name:
            _same_graph(HyperBasevector.load(f"{td}/{name}"), JHBV.load(f"{td}/{name}"))
        elif name.startswith("pf_"):
            _same_paths(ReadPathVec.load(f"{td}/{name}"), JRPV.load(f"{td}/{name}"))


def test_hbv2gfa_matches_jax(port_run, tmp_path, capsys):
    """hbv2gfa on the port's pe.contig, with and without a genome size,
    and with --stats_only: stdout and the GFA file equal."""
    tdir = port_run[0]
    for i, extra in enumerate(([], ["-g", "40"], ["-g", "40", "--stats_only"])):
        outs = []
        for name, main in (("jax", jax_hbv2gfa.main), ("port", hbv2gfa.main)):
            main(["-i", f"{tdir}/pe.contig", "-o", str(tmp_path / f"{name}{i}"), *extra])
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1] and "N50: " in outs[1]
        assert ("NG50: " in outs[1]) == bool(extra)
    for i in (0, 1):
        with open(tmp_path / f"jax{i}_raw.gfa", "rb") as a, \
                open(tmp_path / f"port{i}_raw.gfa", "rb") as b:
            assert a.read() == b.read()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "jax0_raw.gfa", "jax1_raw.gfa", "port0_raw.gfa", "port1_raw.gfa"]


@pytest.mark.cuda
def test_step5_gpu_matches_cpu(dip):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    (hbv, paths, reads), _, _, _ = dip
    outs = {}
    for dev in ("cuda", "cpu"):
        ns = t5.assemble_gaps2(hbv, paths, reads, threads=4, device=dev)
        h2, p2 = t5.add_new_stuff(hbv, paths, reads, ns, chunk_reads=1024, device=dev)
        outs[dev] = (ns, h2, partners_to_ends(h2, p2, reads)[0])
    (ga, gh, gp), (ca, ch, cp) = outs["cuda"], outs["cpu"]
    assert len(ga) == len(ca)
    for a, b in zip(ca, ga):
        np.testing.assert_array_equal(b, a)
    _same_graph(ch, gh)
    _same_paths(cp, gp)

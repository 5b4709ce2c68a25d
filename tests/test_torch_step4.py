"""The step-4 slice end to end: the port's CLI (--to_step 4 --device cpu,
W2RAP_SORT=pallas: the bitonic sort in steps 2 and 3) against the JAX
package's run_pipeline(to_step=4) on one synthetic FASTQ pair with
sequencing errors kept by --min_freq 2, so that Clean200x has branches
to delete — small_K.freqs byte-identical and every array of the small_K,
large_K and large_K.clean checkpoints equal; then --from_step 4 on the
large_K checkpoints that the JAX package wrote.  Tolerance: exact
equality."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from w2rap_contigger_tpu.pipeline.driver import run_pipeline
from w2rap_contigger_tpu_torch import __main__ as cli
from w2rap_contigger_tpu_torch.graph.hbv import HyperBasevector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_K = ("pe.small_K.hbv.npz", "pe.small_K.paths.npz")
LARGE_K = ("pe.large_K.hbv.npz", "pe.large_K.paths.npz")
CLEAN = ("pe.large_K.clean.hbv.npz", "pe.large_K.clean.paths.npz")
MIN_FREQ = 2


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A 20 kb genome at 60x with 0.3% errors through the JAX package's
    steps 1-4, every checkpoint kept."""
    out = tmp_path_factory.mktemp("step4")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "make_synth_fastq.py"),
         str(out), "--glen", "20000", "--pairs", "2400", "--rlen", "250",
         "--insert", "500", "--err", "0.003", "--seed", "42"],
        check=True, capture_output=True, timeout=300,
    )
    fastq = f"{out}/reads_R1.fastq,{out}/reads_R2.fastq"
    jdir = str(out / "jax")
    run_pipeline(out_dir=jdir, read_spec=fastq, to_step=4, min_freq=MIN_FREQ,
                 dump_all=True, shard_devices=0)
    return fastq, jdir


def _same(a_dir, b_dir, names):
    for name in names:
        za, zb = np.load(f"{a_dir}/{name}"), np.load(f"{b_dir}/{name}")
        assert sorted(za.files) == sorted(zb.files)
        for key in za.files:
            np.testing.assert_array_equal(zb[key], za[key], err_msg=f"{name}:{key}")


def _perf(out_dir):
    with open(f"{out_dir}/pe.perf") as f:
        return [line.split(",")[1].strip() for line in f]


def test_step4_cli_pallas_matches_jax_pipeline(jax_run, tmp_path, monkeypatch):
    fastq, jdir = jax_run
    tdir = str(tmp_path / "port")
    monkeypatch.setenv("W2RAP_SORT", "pallas")
    hbv, paths, d = cli.main(["-r", fastq, "-o", tdir, "--to_step", "4", "--device", "cpu",
                              "--min_freq", str(MIN_FREQ), "--dump_all", "--dump_perf"])
    assert hbv.k == 200 and d.size > 0
    with open(f"{jdir}/small_K.freqs", "rb") as a, open(f"{tdir}/small_K.freqs", "rb") as b:
        assert a.read() == b.read()
    _same(jdir, tdir, SMALL_K + LARGE_K + CLEAN)
    # Clean200x did work on this graph
    large = HyperBasevector.load(f"{tdir}/{LARGE_K[0]}")
    assert hbv.n_edges < large.n_edges
    assert _perf(tdir) == ["ReadLoad", "SmallKGraph", "RepathInMemory", "Clean200x"]


def test_from_step4_on_jax_checkpoints(jax_run, tmp_path):
    """Step 4 alone from the JAX package's large_K checkpoints and reads,
    with -s (tiny standalone edges) at its default and above it."""
    _, jdir = jax_run
    for min_size, out in ((0, tmp_path / "s0"), (30, tmp_path / "s30")):
        os.makedirs(out)
        for name in ("frag_reads_orig.npz",) + LARGE_K:
            shutil.copy(f"{jdir}/{name}", out)
        cli.main(["-o", str(out), "--from_step", "4", "--to_step", "4", "--device", "cpu",
                  "-s", str(min_size), "--dump_perf"])
        assert _perf(out) == ["Clean200x"]
        if min_size == 0:
            _same(jdir, str(out), CLEAN)
        else:
            jx = str(tmp_path / "jax_s30")
            os.makedirs(jx)
            for name in ("frag_reads_orig.npz",) + LARGE_K:
                shutil.copy(f"{jdir}/{name}", jx)
            run_pipeline(out_dir=jx, from_step=4, to_step=4, min_size=min_size,
                         shard_devices=0)
            _same(jx, str(out), CLEAN)

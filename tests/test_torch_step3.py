"""The step-3 slice end to end: the port's CLI (--to_step 3 --device cpu)
against the JAX package's run_pipeline(to_step=3) on one synthetic FASTQ
pair — every array of the large_K HBV and paths checkpoints equal; then
--from_step 3 on small_K checkpoints that the JAX package wrote (under
both sort back ends), and --extend_paths.  Tolerance: exact equality."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from w2rap_contigger_tpu.pipeline.driver import run_pipeline
from w2rap_contigger_tpu_torch import __main__ as cli
from w2rap_contigger_tpu_torch.graph import validate
from w2rap_contigger_tpu_torch.ops import kmer_engine as tke
from w2rap_contigger_tpu_torch.ops import radix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LARGE_K = ("pe.large_K.hbv.npz", "pe.large_K.paths.npz")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The 30 kb fixture of test_torch_slice.py through the JAX package's
    steps 1-3, every checkpoint kept."""
    out = tmp_path_factory.mktemp("step3")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "make_synth_fastq.py"),
         str(out), "--glen", "30000", "--pairs", "3600", "--rlen", "250",
         "--insert", "500", "--seed", "42"],
        check=True, capture_output=True, timeout=300,
    )
    fastq = f"{out}/reads_R1.fastq,{out}/reads_R2.fastq"
    jdir = str(out / "jax")
    run_pipeline(out_dir=jdir, read_spec=fastq, to_step=3, dump_all=True,
                 shard_devices=0)
    return fastq, jdir


def _same(a_dir, b_dir, names=LARGE_K):
    for name in names:
        za, zb = np.load(f"{a_dir}/{name}"), np.load(f"{b_dir}/{name}")
        assert sorted(za.files) == sorted(zb.files)
        for key in za.files:
            np.testing.assert_array_equal(zb[key], za[key], err_msg=f"{name}:{key}")


def test_step3_cli_matches_jax_pipeline(jax_run, tmp_path):
    fastq, jdir = jax_run
    tdir = str(tmp_path / "port")
    hbv, paths, d = cli.main(["-r", fastq, "-o", tdir, "--to_step", "3",
                              "--device", "cpu", "--dump_perf"])
    assert hbv.k == 200 and hbv.n_edges > 0 and d.size > 0
    validate.test_involution(hbv)
    validate.validate_paths(hbv, paths)
    _same(jdir, tdir)
    with open(f"{tdir}/pe.perf") as f:
        assert [line.split(",")[1].strip() for line in f] == [
            "ReadLoad", "SmallKGraph", "RepathInMemory"]


@pytest.mark.parametrize("sort", ["lax", "radix"])
def test_from_step3_on_jax_checkpoints(jax_run, tmp_path, monkeypatch, sort):
    """Step 3 alone from the JAX package's small_K checkpoints; radix with
    a tile small enough that the partition sort runs at this size."""
    _, jdir = jax_run
    tdir = str(tmp_path)
    for name in ("pe.small_K.hbv.npz", "pe.small_K.paths.npz"):
        shutil.copy(f"{jdir}/{name}", tdir)
    monkeypatch.setenv("W2RAP_SORT", sort)
    # 2048-row tiles: 15 of them hold the 29,743 K=200 rows, 4 bins each
    monkeypatch.setattr(radix, "DEFAULT_TILE_ROWS", 16)
    recounts = tke.RADIX_RECOUNTS
    cli.main(["-o", tdir, "--from_step", "3", "--to_step", "3", "--device", "cpu"])
    assert tke.RADIX_RECOUNTS == recounts
    _same(jdir, tdir)


def test_extend_paths_matches_jax(jax_run, tmp_path):
    _, jdir = jax_run
    jx, tx = str(tmp_path / "jax"), str(tmp_path / "port")
    for d in (jx, tx):
        os.makedirs(d)
        for name in ("pe.small_K.hbv.npz", "pe.small_K.paths.npz"):
            shutil.copy(f"{jdir}/{name}", d)
    run_pipeline(out_dir=jx, from_step=3, to_step=3, extend_paths=True,
                 shard_devices=0)
    cli.main(["-o", tx, "--from_step", "3", "--to_step", "3", "--device", "cpu",
              "--extend_paths"])
    _same(jx, tx)

"""The step-2 slice end to end: the port's CLI (--to_step 2 --device cpu)
against the JAX package's run_pipeline(to_step=2) on one synthetic
FASTQ pair — small_K.freqs byte-identical, every array of the HBV and
paths checkpoints equal.  Also: the port imports no jax, runs every
sort back end, and refuses what it does not run instead of carrying
on."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from w2rap_contigger_tpu.pipeline.driver import run_pipeline
from w2rap_contigger_tpu_torch import __main__ as cli
from w2rap_contigger_tpu_torch import device as tdev

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "make_synth_fastq.py"),
         str(out), "--glen", "30000", "--pairs", "3600", "--rlen", "250",
         "--insert", "500", "--seed", "42"],
        check=True, capture_output=True, timeout=300,
    )
    return f"{out}/reads_R1.fastq,{out}/reads_R2.fastq"


def test_step2_cli_matches_jax_pipeline(fastq, tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    run_pipeline(out_dir=jdir, read_spec=fastq, to_step=2, shard_devices=0)
    hbv, paths, d = cli.main(
        ["-r", fastq, "-o", tdir, "--to_step", "2", "--device", "cpu",
         "--dump_perf"]
    )
    assert hbv.n_edges > 0 and d.size > 0
    with open(f"{jdir}/small_K.freqs", "rb") as a, open(f"{tdir}/small_K.freqs", "rb") as b:
        assert a.read() == b.read()
    for name in ("pe.small_K.hbv.npz", "pe.small_K.paths.npz"):
        za, zb = np.load(f"{jdir}/{name}"), np.load(f"{tdir}/{name}")
        assert sorted(za.files) == sorted(zb.files)
        for key in za.files:
            np.testing.assert_array_equal(zb[key], za[key], err_msg=f"{name}:{key}")
    with open(f"{tdir}/pe.perf") as f:
        assert [line.split(",")[1].strip() for line in f] == ["ReadLoad", "SmallKGraph"]


def test_cli_refuses_what_is_not_ported(fastq, tmp_path, monkeypatch):
    out = str(tmp_path)
    # every option is ported: --shard 2 runs (one cpu device visible:
    # unsharded, as the JAX package's auto_mesh), and the bitonic sort
    # (K3) runs under W2RAP_SORT=pallas
    monkeypatch.setenv("W2RAP_SORT", "pallas")
    hbv, paths, d = cli.main(["-r", fastq, "-o", out, "--to_step", "2", "--device", "cpu",
                              "--shard", "2"])
    assert hbv.n_edges > 0 and d.size > 0 and os.path.exists(f"{out}/small_K.freqs")
    monkeypatch.setenv("W2RAP_SORT", "bogus")
    with pytest.raises(ValueError, match="lax, radix or pallas"):
        cli.main(["-r", fastq, "-o", out, "--to_step", "2", "--device", "cpu"])
    monkeypatch.delenv("W2RAP_SORT")
    # range batching with a spill directory and the fill/join passes run
    hbv, paths, d = cli.main(["-r", fastq, "-o", out, "--to_step", "2", "--device", "cpu",
                              "--fill_join", "-d", "4", "--tmp_dir", f"{out}/tmp"])
    assert hbv.n_edges > 0 and d.size > 0 and os.listdir(f"{out}/tmp") == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="never falls back"):
        tdev.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="never falls back"):
        cli.main(["-r", fastq, "-o", out, "--to_step", "2"])
    # steps 6-7 and their replay are host numpy, and still refuse a
    # missing card when cuda is asked
    with pytest.raises(RuntimeError, match="never falls back"):
        cli.main(["-o", out, "--from_step", "6"])
    with pytest.raises(RuntimeError, match="never falls back"):
        cli.main(["-o", out, "--dev_run_test", "pathfinder"])


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke, imports with jax and the
    JAX package both blocked (a subprocess: this test process has them
    loaded already)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['w2rap_contigger_tpu'] = None\n"
        "import w2rap_contigger_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names + ['chip_smoke']: importlib.import_module(n)\n"
        "assert not any(m.split('.')[0] in ('jax', 'w2rap_contigger_tpu')\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "assert 'w2rap_contigger_tpu_torch.graph.gapfill' in names\n"
        "assert 'w2rap_contigger_tpu_torch.parallel.mesh' in names\n"
        "assert 'w2rap_contigger_tpu_torch.bench' in names\n"
        "assert 'w2rap_contigger_tpu_torch.ops.align' in names\n"
        "print(len(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 78


# the JAX package's Pallas files -> the port's modules of their kernels
PALLAS_PORTS = {"ops/pallas_kmer.py": "ops/kmerize.py", "ops/pallas_collapse.py": "ops/collapse.py",
                "ops/pallas_sort.py": "ops/bitonic.py", "ops/pallas_radix.py": "ops/radix.py"}


def _py_files(package: str) -> set[str]:
    root = os.path.join(REPO, package)
    return {os.path.relpath(os.path.join(d, f), root).replace(os.sep, "/")
            for d, _, files in os.walk(root) for f in files if f.endswith(".py")}


def test_port_has_every_jax_module():
    """Every module of the JAX package has a counterpart under the same
    relative path in the port, but the four Pallas files, whose kernels
    the port's ops/{kmerize,collapse,bitonic,radix}.py hold."""
    jax_files, port_files = (_py_files(p) for p in ("w2rap_contigger_tpu",
                                                     "w2rap_contigger_tpu_torch"))
    assert set(PALLAS_PORTS) <= jax_files
    missing = sorted(PALLAS_PORTS.get(f, f) for f in jax_files
                     if PALLAS_PORTS.get(f, f) not in port_files)
    assert missing == []

"""The step-2 slice end to end: the port's CLI (--to_step 2 --device cpu)
against the JAX package's run_pipeline(to_step=2) on one synthetic
FASTQ pair — small_K.freqs byte-identical, every array of the HBV and
paths checkpoints equal.  Also: the port imports no jax, and refuses
what it does not run instead of carrying on."""

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
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cli.main(["-r", fastq, "-o", out, "--to_step", "3", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cli.main(["-r", fastq, "-o", out, "--to_step", "2", "--device", "cpu",
                  "--fill_join"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="never falls back"):
        tdev.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="never falls back"):
        cli.main(["-r", fastq, "-o", out, "--to_step", "2"])


def test_port_imports_no_jax():
    """Every module of the port imports with jax blocked (a subprocess:
    this test process has jax loaded already)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import w2rap_contigger_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names + ['chip_smoke']: importlib.import_module(n)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "print(len(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15

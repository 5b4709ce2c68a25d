"""Nothing the harness or the reference loads is jax or the JAX package
(whole top-level names: the port's name begins with the JAX package's),
and the reference loads nothing of the port."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HARNESS = ["benchmark.run", "benchmark.entries", "benchmark.data", "benchmark.trace",
           "benchmark.roofline", "benchmark.control"]
REFERENCE = ["benchmark.reference.count"]


def _loaded(modules: list, extra: str = "") -> set:
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            f"{extra}\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    # the entry imports the port when a cell is built: load it too
    top = _loaded(HARNESS, "import w2rap_contigger_tpu_torch.ops.kmer_engine")
    assert not top & {"jax", "jaxlib", "flax", "w2rap_contigger_tpu"}
    assert "w2rap_contigger_tpu_torch" in top


def test_reference_loads_nothing_of_the_port():
    top = _loaded(REFERENCE)
    assert not top & {"jax", "jaxlib", "flax", "w2rap_contigger_tpu", "w2rap_contigger_tpu_torch"}


@pytest.mark.parametrize("name", ["w2rap_contigger_tpu", "jax", "jaxlib", "flax"])
def test_forbidden_names_are_whole(name, monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, name + "_torch.ops", sys.modules["os"])
    assert name + "_torch" not in run.forbidden_modules()
    assert name not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, name + ".core", sys.modules["os"])
    assert name in run.forbidden_modules()

"""Native (C++) host leaves of the port, built with g++ and loaded with ctypes.

Copied from w2rap_contigger_tpu/native/__init__.py with the leaves the
port calls (`pack_kernel.cc`: 2-bit packing + usable read lengths;
`fastq_loader.cc`: FASTQ parsing; and for step 5's blob-local graphs
`count_kernel.cc`: kmer counting, `graph_kernel.cc`: adjacency pruning,
unitig links and list ranking, `path_kernel.cc`: read and flat-sequence
pathing).  Each module builds on demand into `native/build/` (listed in
.gitignore), never next to the sources, and is rebuilt when a source is
newer than its library.  Every leaf is required: none has a second
implementation to fall back on, so `load` raises when a module does not
build (g++, and zlib for the FASTQ loader).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "build")
_LOCK = threading.Lock()
_LIBS: dict = {}


def _build(name: str, sources, libs=()) -> str:
    so_path = os.path.join(BUILD_DIR, f"lib{name}.so")
    src_paths = [os.path.join(_DIR, s) for s in sources]
    if os.path.exists(so_path) and all(
            os.path.getmtime(so_path) >= os.path.getmtime(s)
            for s in src_paths):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
           *src_paths, "-o", tmp, *[f"-l{lib}" for lib in libs]]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, so_path)
    return so_path


def load(name: str, sources, libs=()):
    """Build (if stale) and dlopen a native module; returns the CDLL.
    Raises RuntimeError naming the module and its sources, with the
    compiler's stderr, when the module does not build or load."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        what = f"native module {name} ({', '.join(sources)})"
        try:
            lib = ctypes.CDLL(_build(name, sources, libs))
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"{what} did not build:\n"
                               f"{e.stderr.decode(errors='replace')}") from e
        except OSError as e:  # no g++, or a library that does not load
            raise RuntimeError(f"{what} did not build or load: {e}") from e
        _LIBS[name] = lib
        return lib

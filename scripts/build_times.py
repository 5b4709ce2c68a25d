"""Time the CUDA kernel library's build two ways, on a machine with nvcc:
one nvcc per `csrc/*.cu` run one after another, then all started together
(as `ops/_build.py` builds), each followed by the one link.

    python3 scripts/build_times.py [--rounds 2]

Prints one line a build (`serial` or `parallel`, wall seconds), and
after each serial build one line a source (its nvcc's wall seconds); the
objects go to a scratch folder under the gitignored build directory,
removed at the end.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from w2rap_contigger_tpu_torch.ops import _build  # noqa: E402


def build(parallel: bool, out_dir: str) -> tuple[float, dict]:
    nvcc = _build._nvcc()
    srcs = _build.sources()
    objs = [os.path.join(out_dir, os.path.basename(s)[:-3] + ".o") for s in srcs]
    cmds = [[nvcc, *_build.NVCC_FLAGS, "-c", "-o", o, s] for s, o in zip(srcs, objs)]
    per_source = {}
    t0 = time.time()
    if parallel:
        _build._run(cmds)
    else:
        for src, cmd in zip(srcs, cmds):
            t1 = time.time()
            _build._run([cmd])
            per_source[os.path.basename(src)] = time.time() - t1
    _build._run([[nvcc, *_build.ARCH_FLAGS, "-shared", "-o",
                  os.path.join(out_dir, "lib.so"), *objs]])
    return time.time() - t0, per_source


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    out_dir = os.path.join(_build.BUILD_DIR, f"times.{os.getpid()}")
    os.makedirs(out_dir)
    try:
        print(f"sources={len(_build.sources())}", flush=True)
        for _ in range(args.rounds):
            for parallel in (False, True):
                secs, per_source = build(parallel, out_dir)
                print(f"{'parallel' if parallel else 'serial'} seconds={secs:.2f}", flush=True)
                for name, t in per_source.items():
                    print(f"  source={name} seconds={t:.2f}", flush=True)
    finally:
        shutil.rmtree(out_dir)


if __name__ == "__main__":
    main()

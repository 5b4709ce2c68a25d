"""sha256 of a run's output files, so that a run on another machine (the
card's, which has no jax) can be held to the JAX package's outputs.

    python scripts/output_hashes.py OUT_DIR [--reads DATA_DIR] > hashes.json

An npz file hashes each array over its dtype, shape and bytes (the zip
holds timestamps), as `<file>:<key>`; every other file hashes its bytes.
Timing files (`*.perf`) and logs are left out.  With --reads, the two
FASTQ files of DATA_DIR are hashed too, under `reads/<name>`.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os

import numpy as np

READS = ("reads_R1.fastq", "reads_R2.fastq")
SKIP = (".perf", ".log", ".json")


def array_sha256(arr: np.ndarray) -> str:
    """sha256 over an array's dtype, shape and C-order bytes."""
    arr = np.ascontiguousarray(arr)
    h = hashlib.sha256(f"{arr.dtype.str}|{arr.shape}|".encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def output_hashes(out_dir: str, names=None) -> dict:
    """{`<npz>:<key>` or file name: sha256} for `names` (default: every
    regular file of out_dir but timings and logs); a missing name is
    left out."""
    if names is None:
        names = sorted(n for n in os.listdir(out_dir)
                       if os.path.isfile(os.path.join(out_dir, n)) and not n.endswith(SKIP))
    out = {}
    for name in names:
        path = os.path.join(out_dir, name)
        if not os.path.exists(path):
            continue
        if name.endswith(".npz"):
            with np.load(path) as z:
                for key in sorted(z.files):
                    out[f"{name}:{key}"] = array_sha256(z[key])
        else:
            out[name] = file_sha256(path)
    return out


def reads_hashes(data_dir: str) -> dict:
    return {f"reads/{n}": file_sha256(os.path.join(data_dir, n)) for n in READS}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("--reads", default=None, help="hash this directory's FASTQ pair too")
    args = ap.parse_args(argv)
    hashes = output_hashes(args.out_dir)
    if args.reads:
        hashes.update(reads_hashes(args.reads))
    print(json.dumps(hashes, indent=1, sort_keys=True))


if __name__ == "__main__":
    main()

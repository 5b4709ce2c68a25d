"""K1 (csrc/kmerize.cu) checked and timed in one process on one GPU,
beside other checkouts' K1.

    python3 scripts/kmerize_ab.py [--parent DIR ...] [--rounds 3] [--reps 50]
        [--variants plain_stores offset16]

Prints this checkout's K1 registers, spilled (local) bytes and static
shared memory at W = 4, 13, 17, 40 (cudaFuncGetAttributes); holds every
library's K1 bit for bit against `kmerize_plain` on small ragged inputs
(k = 31, 60, 200, 272, 320, 640 on 300 and 301 reads; a DIR's K1 only at
the W its wrapper takes) and on step 2's chunk (65,536 reads of L=250,
`chip_smoke.py`'s) at k = 60 and 200; then times them there in turns
(a, b, ..., b, a) over --rounds turns, each turn --reps launches into one
preallocated output between two CUDA events, after a warm-up.  With
--parent DIR ..., unpacked checkouts of other commits of the port (in a
directory .gitignore lists), each DIR's K1 is built from its own csrc/
and timed under the DIR's name.  Two variants of this checkout's K1 are
timed in the same turns: `plain_stores` (its 16-byte stores without the
streaming hint) and `offset16` (its own kernel writing planes that start
16 bytes past a 32-byte sector, so that each warp's 512-byte store
straddles 17 sectors instead of filling 16).  Prints each mean, its
bound (the planes written and the packed rows read, at 3.35 TB/s) and
its share of it, and the card's name and power limit last.  Exits
non-zero on any mismatch.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import chip_smoke as cs  # noqa: E402
from sort_kernel_ab import build_variant, load_parent  # noqa: E402
from w2rap_contigger_tpu_torch.ops import _build  # noqa: E402
from w2rap_contigger_tpu_torch.ops import bitkmer as bk  # noqa: E402
from w2rap_contigger_tpu_torch.ops import kmerize as kkm  # noqa: E402

# variant name -> (source, pattern, replacement) on this checkout's csrc/
VARIANTS = {
    "plain_stores": ("kmerize.cu", r"__stcs\(p, v\);", "*p = v;"),
}
OFFSET_WORDS = 4  # offset16: the planes 16 bytes past a 32-byte sector
SMALL = ((31, 340), (60, 250), (200, 250), (272, 660), (320, 660), (640, 700))
PARENT_MAX_W = 17  # the first form's instances


def check(libs: dict, parents: set, pr_d, gl_d, k: int, L: int, label: str) -> torch.Tensor:
    """Every library's K1 (a parent's at W <= 17) against the plain
    version; the plain planes."""
    want = kkm.kmerize_plain(pr_d, gl_d, k, L)
    for name, lib in libs.items():
        if name in parents and bk.nwords(k) > PARENT_MAX_W:
            continue
        out = torch.full_like(want, 0x5A5A5A5A)
        cs.kmerize_c(lib, pr_d, gl_d, k, L, out)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            cs.fail(f"{name} K1 {label} k={k} L={L} differs from its plain version "
                    f"(max_abs_err {cs.max_abs_err([out], [want])})")
    return want


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", nargs="*", default=[],
                    help="unpacked checkouts of other commits of the port")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--variants", nargs="*", default=["plain_stores", "offset16"],
                    choices=[*VARIANTS, "offset16"])
    args = ap.parse_args()
    card = cs.phase_probe()
    cs.phase_build()
    parents = {os.path.basename(os.path.normpath(d)): load_parent(d) for d in args.parent}
    libs = {"new": _build.library(), **parents,
            **{v: build_variant(v, VARIANTS[v]) for v in args.variants if v in VARIANTS}}
    for W in cs.K1_ATTRS_W:
        cs.say("attrs", kernel="kmerize", W=W, **kkm.kmerize_attrs(W))

    cases = 0
    for k, L in SMALL:
        for n in (300, 301):
            pr_d, gl_d = cs.k1_inputs(k, n, L, ragged=True)
            check(libs, set(parents), pr_d, gl_d, k, L, f"small n={n}")
            cases += 1
    cs.say("small", cases=cases, libraries=len(libs), identical=True)

    for k in (60, 200):
        pr_d, gl_d = cs.k1_inputs(k)
        want = check(libs, set(parents), pr_d, gl_d, k, cs.READ_LEN, "chunk")
        b, by = cs.bound_ms(want.numel() * 4 + pr_d.numel() * 4 + gl_d.numel() * 4)
        outs = {name: torch.empty_like(want) for name in libs}
        if "offset16" in args.variants:
            libs_t = {**libs, "offset16": libs["new"]}
            buf = torch.empty(want.numel() + OFFSET_WORDS, dtype=want.dtype, device=want.device)
            outs["offset16"] = buf[OFFSET_WORDS:].view(want.shape)
        else:
            libs_t = libs

        def timed(name):
            lib, out = libs_t[name], outs[name]
            return lambda: cs.time_ms(
                lambda: cs.kmerize_c(lib, pr_d, gl_d, k, cs.READ_LEN, out), args.reps)

        names = list(libs_t)
        acc = {name: [] for name in names}
        for _ in range(args.rounds):
            for name in names + names[::-1]:
                acc[name].append(timed(name)())
        for name in names:
            if not torch.equal(outs[name], want):
                cs.fail(f"{name} K1 k={k}: the timed launches differ from the plain version")
            ms = sum(acc[name]) / len(acc[name])
            cs.say("time", k=k, variant=name, rows=want.shape[1], ms=f"{ms:.4f}",
                   min_ms=f"{min(acc[name]):.4f}", max_ms=f"{max(acc[name]):.4f}",
                   bound_ms=f"{b:.4f}", bound_by=by, share=f"{b / ms:.3f}",
                   turns=len(acc[name]), reps=args.reps)
        del want, outs
        torch.cuda.empty_cache()
    print(card, flush=True)


if __name__ == "__main__":
    main()

"""Unified heuristics/config layer — the `long_heuristics` analogue.

The reference scatters its tuning constants between a ~100-knob
string-parsed config object (src/paths/long/Heuristics.h:75-200) and
hardwired per-algorithm blocks (w2rap-contigger.cc:180-181,432-437,
477-494; Clean200.cc:29-31; Unsat.cc:130-134; MakeGaps.cc:42-49;
AssembleGaps.cc:243-249; FindErrorsCore.h:19-37).  SURVEY §5.6 asks for
exactly this lift: one config object holding every knob the 7-step
pipeline consumes, with the reference defaults preserved bit-for-bit.

Use:

    from w2rap_contigger_tpu_torch.config import Heuristics, DEFAULT
    heur = parse_heuristics("PAIR_SAMPLE=400,MAX_BPATHS=50000")

Step modules read their module-level constants from DEFAULT at import
time (so the documented reference defaults live in exactly one place)
and accept a `heur` argument where runtime override matters.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Heuristics:
    # ---- step 2: buildReadQGraph (w2rap-contigger.cc:132,180-181) ----
    SMALL_K: int = 60
    MIN_QUAL: int = 7          # quality gate (BuildReadQGraph.cc:962)
    MIN_FREQ: int = 4          # dict count filter (BuildReadQGraph.cc:1095)

    # ---- step 4: Clean200x (Clean200.cc:29-31,391-445) ---------------
    CLEAN_MAX_EXTS: int = 10
    CLEAN_MAX_RL: int = 250
    CLEAN_MAX_DEL: int = 15    # AnalyzeScores max_del
    CLEAN_MIN_WIN: int = 100
    CLEAN_MAX_LOSE: int = 50
    CLEAN_MIN_RATIO: int = 5
    CLEAN_NPASSES: int = 2

    # ---- step 5: Unsat (Unsat.cc:130-134,252,317,325,369) ------------
    UNSAT_MAX_DEPTH: int = 15
    UNSAT_MAX_VERTS: int = 50
    UNSAT_RADIUS: int = 3
    UNSAT_MERGE_PASSES: int = 10
    UNSAT_MAX_CLUSTER: int = 20
    UNSAT_OVERLAP_PASSES: int = 2
    UNSAT_MAX_OVERLAP_RHS: int = 5
    UNSAT_OVERLAP_L: int = 100
    UNSAT_CLUSTER_RATIO: int = 10

    # ---- step 5: AssembleGaps2 (w2rap-contigger.cc:432-437) -----------
    MAX_PROX_LEFT: int = 400
    MAX_PROX_RIGHT: int = 400
    PAIR_SAMPLE: int = 200
    MAX_BPATHS: int = 100000
    K2_FLOOR_SEQUENCE: tuple = (0, 100, 128, 144, 172, 200)
    K2FRAC: float = 0.22       # SelectK2 (LongProtoTools.cc:45)

    # ---- step 5: pre-correction PC_Params (FindErrorsCore.h:19-37) ---
    PC_K: int = 25
    PC_N_KMERS_MIN: int = 6
    PC_Q_HIGH: int = 20
    PC_N_Q_HIGH_MAX_TO_LOSE: int = 1
    PC_Q_SUM_MIN_TO_WIN: int = 60
    PC_RATIO_LOSER: float = 0.25

    # ---- step 5: CorrectionSuite (LoadCorrectCore.cc, Heuristics.h) --
    FF_MAX_FREQ: int = 1000
    MAX_STACK: int = 10000
    Q_SOLID: int = 30
    PROTECTED_BASES: int = 10
    Q_TO_PROTECT: int = 20
    CLOSE_PAIRS_K2: int = 80   # LoadCorrectCore.cc:273

    # ---- step 6: Simplify (Simplify.cc:33-244, cc:477-494) -----------
    MAX_SUPP_DEL: int = 0
    MIN_MULT: int = 10         # unsupported-branch ratio (Simplify.cc:44)
    TAMP_EARLY: bool = True
    MAX_DEL2: int = 200
    ANALYZE_BRANCHES_MIN_RATIO2: int = 8
    DEGLOOP_MIN_DIST: float = 2.5
    EXT_MIN_GAIN: int = 20
    REMOVE_HANGS: tuple = (100, 200, 700)

    # ---- step 6/7: lines + scaffolding (MakeGaps.cc:42-49) -----------
    MAX_CELL_PATHS: int = 50
    MAX_CELL_DEPTH: int = 10
    MIN_LINE: int = 5000
    MIN_LINK_COUNT: int = 3
    GAP_MAX_HANG: int = 800
    GAP_MAX_DEPTH: int = 2
    GAP_MAX_INT: int = 1500
    GAP_PASSES: int = 3
    GAP_MAX_COV_PC_OFF: float = 20.0
    GAP_MAX_LINE_TO_IGNORE: int = 500


DEFAULT = Heuristics()


def parse_heuristics(spec: str, base: Heuristics | None = None) -> Heuristics:
    """Parse "NAME=value,NAME=value" overrides (the reference parses
    long_heuristics from exactly this kind of string, Heuristics.h:75)."""
    heur = dataclasses.replace(base or DEFAULT)
    if not spec:
        return heur
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        name, _, val = item.partition("=")
        name = name.strip()
        if not hasattr(heur, name):
            raise ValueError(f"unknown heuristic {name!r}")
        cur = getattr(heur, name)
        if isinstance(cur, bool):
            parsed = val.strip().lower() in ("1", "true", "yes", "on")
        elif isinstance(cur, int):
            parsed = int(val)
        elif isinstance(cur, float):
            parsed = float(val)
        elif isinstance(cur, tuple):
            parsed = tuple(int(x) for x in val.split("/") if x)
        else:
            parsed = val
        setattr(heur, name, parsed)
    return heur

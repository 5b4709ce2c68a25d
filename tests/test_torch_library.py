"""The port's copies of the JAX package's library modules (utils/random,
reporting, peaks; core/efasta, pairs; ops/spectra, packalign, readstack,
align, ultra) against the originals: each case runs one function of the
same data, mostly the JAX tests' (tests/test_{align,ultra,readstack,
packalign,pairs_spectra,utils_support}.py), through both packages and
compares every result, arrays with their dtypes.  banded_costs_batch,
the one device function (torch in the port, jax.vmap over lax.scan in
the JAX package), runs on device='cpu' against the JAX function on the
CPU at bandwidth 0, 3 and 8 with ragged lengths.  Tolerance: exact
equality."""

import dataclasses
import importlib
import io
from types import SimpleNamespace

import numpy as np
import pytest
import torch

MODULES = ("utils.random", "utils.reporting", "utils.peaks", "core.efasta", "core.pairs",
           "ops.spectra", "ops.packalign", "ops.readstack", "ops.align", "ops.ultra")
PACKAGES = ("w2rap_contigger_tpu", "w2rap_contigger_tpu_torch")


def _modules(pkg: str) -> SimpleNamespace:
    return SimpleNamespace(**{name.split(".")[1]: importlib.import_module(f"{pkg}.{name}")
                              for name in MODULES})


def _plain(x):
    """Results as comparable data: arrays as (dtype, values), objects of
    either package as their class name and fields."""
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.tolist())
    if isinstance(x, np.generic):
        return ("scalar", x.dtype.str, x.item())
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) or type(x).__module__.startswith(PACKAGES[0]):
        return (type(x).__name__, _plain(dict(vars(x))))
    return x


def _gauss_hist(centers_heights, n=2000, sigma=40.0):
    x = np.arange(1, n + 1, dtype=np.float64)
    y = np.zeros(n)
    for c, h in centers_heights:
        y += h * np.exp(-0.5 * ((x - c) / sigma) ** 2)
    return x, np.round(y).astype(np.int64)


def _raises(fn, *args):
    try:
        return fn(*args)
    except Exception as e:  # the exception type is the result
        return type(e).__name__


def case_random(m):
    g = m.random.RNGen(1)
    seq = [g.next() for _ in range(40)]
    g.seed(12345)
    seq += [g.next() for _ in range(40)]
    m.random.srandomx(7)
    system = ([m.random.randomx() for _ in range(10)] + [m.random.randint(97) for _ in range(10)]
              + [m.random.big_random() for _ in range(5)])
    grid = np.linspace(-7.0, 7.0, 57)
    return {
        "seq": seq, "system": system,
        "density": [m.random.normal_density(a, 0.3, 1.7) for a in grid],
        "std_integral": [m.random.standard_normal_distribution_integral(a) for a in grid],
        "integral": [m.random.normal_distribution_integral(a, 1.0, 2.0) for a in grid],
        "bernoulli": [m.random.partial_bernoulli_sum(n, k) for n in (1, 5, 10, 30)
                      for k in (0, 1, 2, n)],
        "deviate": [m.random.normal_deviate(u, v) for u, v in
                    ((0.9, 0.6), (0.1, 0.2), (0.5, 0.5), (0.99, 0.01))],
    }


def case_reporting(m):
    buf = io.StringIO()
    ps = m.reporting.PerfStatLogger(stream=buf)
    ps.log("contig_N50", 59775, "N50 of contig lines")
    ps.log("n_lines", 14)
    t = m.reporting.TextTable()
    t.add_row("step", "wall", "cpu")
    t.add_row("2", "10.5", "80.1")
    t.add_row("repath", "3", "")
    lg = m.reporting.Logger("err")
    for msg in ("bad read", "bad read", "other", "bad read"):
        lg.log(msg)
    dump = io.StringIO()
    lg.dump(dump)
    samples = np.random.default_rng(5).integers(300, 700, 500)
    d = m.reporting.IntDistribution.from_samples(samples)
    return {
        "perfstat": buf.getvalue(), "rows": ps.rows, "table": t.render(),
        "table_sep": t.render(sep=" | "), "log": dump.getvalue(), "count": lg.count("bad read"),
        "dist": [d.x_min, d.x_max, d.prob, d.mean(), d.sd(), d.median(),
                 [d.quantile(q) for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0)],
                 [d.prob_at(x) for x in (299, 300, 450, 699, 700)],
                 [d.prob_le(x) for x in (299, 300, 450, 699, 700)],
                 [d.prob_in(a, b) for a, b in ((450, 550), (0, 1000), (600, 400))]],
    }


def case_peaks(m):
    hists = [_gauss_hist([(500, 10000)]), _gauss_hist([(400, 10000), (800, 3000)]),
             _gauss_hist([(300, 2000), (600, 40000)])]
    x = np.arange(1, 201, dtype=np.float64)
    y = np.full(200, 1000, dtype=np.int64)
    y[49] += 10
    hists.append((x, y))
    out = []
    for x, y in hists:
        f = m.peaks.CN1PeakFinder()
        cov = f.find_peak(x, y)
        out.append([m.peaks.PeakFinder().find_peaks(x, y), m.peaks.PeakFinder().find_peaks_y(y),
                    cov, _plain(f)])
    return out


def case_efasta(m):
    out = []
    for s in ("AC{G,T}A{,C}G", "ACGT", "{A,C,G}{T,TT}A", "A{C,G}{C,G}{C,G}T", ""):
        out.append([m.efasta.parse(s), m.efasta.amb_count(s), m.efasta.expand_to(s),
                    m.efasta.expand_to(s, max_count=3), m.efasta.flatten_to(s),
                    m.efasta.expand_to_codes(s), m.efasta.expand_to_codes(s, max_count=2)])
    out.append(m.efasta.to_codes("ACGTTGCA"))
    return out


def case_pairs(m):
    pm = m.pairs.PairsManager(20)
    a = pm.add_library(sep=300, sd=40, name="pe300", pair_range=(0, 5))
    b = pm.add_library(sep=5000, sd=500, pair_range=(5, 10))
    pm.estimate_library_stats([280, 300, 320, 333], a)
    pm.change_library_sep_sd(b, 4800, 450)
    per_pair = [[pm.lib_of_pair(p), pm.sep(p), pm.sd(p), pm.id1(p), pm.id2(p)]
                for p in range(pm.n_pairs)]
    per_read = [[pm.pair_id(r), pm.partner(r)] for r in range(pm.n_reads)]
    rl = m.pairs.ReadNameLookup.from_names(["a", "b", "c"])
    rl2 = m.pairs.ReadNameLookup()
    rl2.add("p", 4)
    return [pm.n_pairs, pm.libraries, per_pair, per_read, rl.get("b"), "c" in rl, "z" in rl,
            len(rl), _raises(rl.get, "z"), _raises(rl.add, "a", 5), rl2.get("p.1"),
            rl2.get("p.2"), _raises(rl2.get, "q.1")]


def case_spectra(m):
    counts = np.zeros(101, dtype=np.int64)
    counts[1], counts[2] = 100000, 20000
    f = np.arange(101)
    counts += np.round(5000 * np.exp(-0.5 * ((f - 30) / 5.0) ** 2)).astype(np.int64)
    out = []
    for ploidy in (1, 2):
        ks = m.spectra.KmerSpectrum(60, counts)
        ks.analyze(ploidy=ploidy)
        out.append(_plain(ks))
    ks2 = m.spectra.KmerSpectrum(60)
    ks2.increment(1, 7)
    ks2.increment(200, 3)
    tot = m.spectra.KmerSpectrum(60, counts) + ks2
    fk = m.spectra.KmerSpectrum.from_kmer_counts(31, [1, 1, 2, 5, 5, 5, 0])
    return out + [_plain(tot), tot.sum(), tot.sum_weighted(), _plain(fk), fk.sum()]


def case_packalign(m):
    rng = np.random.default_rng(0)
    s2 = rng.integers(0, 4, size=50).astype(np.uint8)
    s1 = np.concatenate([s2[3:10], s2[12:23]]).astype(np.uint8)
    s1[2] = (s1[2] + 1) % 4
    aligns = [m.packalign.Align(0, 3, [0, -2, 1, 1], [5, 1, 2, 5]),
              m.packalign.Align(5000, 12, [0, -40, 7], [2000, 17, 900]),
              m.packalign.Align(0, 3, [0, 2], [7, 11]),
              m.packalign.Align.from_ops(0, 0, "MMMDDIIM"),
              m.packalign.Align.from_ops(4, 9, "MMIIIMMMMDMM")]
    out = []
    for a in aligns:
        w = m.packalign.pack(a)
        f = a.flip()
        out.append([w, _plain(m.packalign.unpack(w)), _plain(f), a.nblocks, a.extent1(),
                    a.extent2(), f.extent1(), f.extent2()])
    out.append([aligns[2].errors(s1, s2), aligns[2].flip().errors(s2, s1)])
    return out


def case_readstack(m):
    rng = np.random.default_rng(1234)
    rows, cols = 30, 50
    bases = rng.integers(0, 4, size=(rows, cols)).astype(np.int8)
    quals = rng.integers(0, 41, size=(rows, cols)).astype(np.int16)
    undef = rng.random((rows, cols)) < 0.2
    bases[undef], quals[undef] = -1, -1
    bases[: rows // 2, :10], quals[: rows // 2, :10] = 2, 35
    sb, sq = m.readstack.make_stack(12, 30)
    founder = rng.integers(0, 4, size=30).astype(np.int8)
    for r in range(12):
        m.readstack.add_read(sb, sq, r, r % 3, founder.copy(), np.full(30, 30))
    sb[6:, 5] = (founder[5] + 1) % 4
    sb[3, 7] = (sb[3, 7] + 1) % 4
    sq[4, 9] = 5
    out = [m.readstack.consensus1(bases, quals), sb, sq]
    for top in (1, 2):
        out.append(m.readstack.high_qual_diff(sb, sq, n=25, top=top))
        sus = m.readstack.clean_columns(sb, sq, top=top)
        out += [sus, m.readstack.erase_rows(sb, sq, sus)]
    return out


def case_align(m):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(12):
        n = int(rng.integers(5, 40))
        mlen = n + int(rng.integers(0, 20))
        S = rng.integers(0, 4, n).astype(np.int8)
        T = rng.integers(0, 4, mlen).astype(np.int8)
        off, bw = int(rng.integers(0, 8)), int(rng.integers(2, 12))
        out.append([m.align.sw_banded(S, T, off, bw), m.align.sw_banded(S, T, 0, max(n, mlen)),
                    m.align._banded_matrix(S, T, off, bw, 2, 3),
                    [m.align.sw_free(S, T, pl, pr) for pl in (False, True) for pr in (False, True)],
                    m.align.sw_affine(S[: n // 2 + 2], T[: mlen // 2 + 2]),
                    m.align.sw_affine(S, T, mis=2, gap_open=5, gap_extend=2)])
    return out


def case_ultra(m):
    model = m.ultra.ConsensusScoreModel(0.01, 0.01, 0.01)
    a = np.array([0, 1, 2, 3], dtype=np.int8)
    b = a.copy()
    b[2] = 0
    rng = np.random.default_rng(0)
    truth = rng.integers(0, 4, 120).astype(np.int8)
    founder = truth.copy()
    founder[60] = (founder[60] + 1) % 4
    offsets = [0, 5, 10, 15, 2, 7, 12, 20]
    friends = [truth[o:o + 100].copy() for o in offsets]
    tb = m.ultra.make_blocks(founder, friends, offsets, k=11)
    rng = np.random.default_rng(1)
    truth2 = rng.integers(0, 4, 100).astype(np.int8)
    founder2 = truth2.copy()
    founder2[50] = (founder2[50] + 2) % 4
    offsets2 = [0, 4, 8, 12, 16, 20]
    friends2 = [truth2[o:o + 80].copy() for o in offsets2]
    return [_plain(model), model.score(a, a), model.score(a, b), model.score(a, a[:-1]),
            model.score_threads(a, [a, b, a[:-1]]), _plain(tb), tb.n_blocks, tb.n_gaps,
            [tb.gap_threads(g) for g in range(tb.n_gaps)],
            [tb.gap_consensus(g) for g in range(tb.n_gaps)], tb.assemble(k=11),
            m.ultra.prefab_correct(founder2, friends2, offsets2, k=9),
            m.ultra.prefab_correct(np.array([0, 1, 2, 3] * 5, dtype=np.int8), [], [], k=9)]


CASES = {name[5:]: fn for name, fn in dict(globals()).items() if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_library_module_matches_jax(case):
    want, got = (CASES[case](_modules(pkg)) for pkg in PACKAGES)
    assert _plain(got) == _plain(want)


@pytest.mark.parametrize("bandwidth", [0, 3, 8])
def test_banded_costs_batch_matches_jax(bandwidth):
    from w2rap_contigger_tpu.ops import align as jalign
    from w2rap_contigger_tpu_torch.ops import align as talign

    rng = np.random.default_rng(bandwidth)
    B, Ls, Lt = 6, 30, 44
    Ts = rng.integers(0, 4, (B, Lt)).astype(np.int8)
    Ss = np.zeros((B, Ls), np.int8)
    lens_s = rng.integers(1, Ls + 1, B).astype(np.int32)
    lens_t = rng.integers(Ls // 2, Lt + 1, B).astype(np.int32)
    lens_s[0], lens_t[0] = Ls, Lt  # one full-length pair
    for b in range(B):  # S a mutated window of T, then padding
        off = int(rng.integers(0, 6))
        S = Ts[b, off:off + lens_s[b]].copy()
        S[rng.random(len(S)) < 0.1] = rng.integers(0, 4)
        Ss[b, :len(S)] = S
    offset = 3
    want = np.asarray(jalign.banded_costs_batch(Ss, Ts, lens_s, lens_t, offset, bandwidth))
    got = talign.banded_costs_batch(Ss, Ts, lens_s, lens_t, offset, bandwidth, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert tuple(got.shape) == (B, Ls + 1, 2 * bandwidth + 1) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < jalign.BIG).any()  # some cells reachable
    # the rows at lens_s give the host DP's costs
    for b in range(B):
        D, _ = talign._banded_matrix(Ss[b, :lens_s[b]], Ts[b, :lens_t[b]], offset, bandwidth, 2, 3)
        np.testing.assert_array_equal(np.minimum(got.numpy()[b, lens_s[b]], talign.BIG),
                                      np.minimum(D[-1], talign.BIG))


def test_banded_costs_batch_without_a_card_raises(monkeypatch):
    from w2rap_contigger_tpu_torch.ops import align as talign

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    S = np.zeros((1, 4), np.int8)
    with pytest.raises(RuntimeError, match="never falls back"):
        talign.banded_costs_batch(S, S, [4], [4], 0, 2)


"""Interval algebra vs brute force (bedtools-semantics checks)."""

import numpy as np
import pytest

from telr_jax.ops.intervals import (Intervals, closest, intersect_wao,
                                    merge_intervals)


def _random_intervals(rng, n, chroms=("c1", "c2"), span=1000, cols=False):
    rows = []
    for i in range(n):
        c = chroms[rng.integers(len(chroms))]
        s = int(rng.integers(0, span))
        e = s + int(rng.integers(1, 50))
        if cols:
            rows.append((c, s, e, f"n{i}", int(rng.integers(0, 60)),
                         "+" if rng.random() < 0.5 else "-"))
        else:
            rows.append((c, s, e))
    names = ("name", "score", "strand") if cols else ()
    return Intervals.from_rows(rows, names)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("dist", [0, 10])
def test_merge_brute(seed, dist):
    rng = np.random.default_rng(seed)
    iv = _random_intervals(rng, 40)
    merged = merge_intervals(iv, dist=dist)
    # every input interval is contained in exactly one merged interval
    for i in range(len(iv)):
        hits = [j for j in range(len(merged))
                if merged.chrom[j] == iv.chrom[i]
                and merged.start[j] <= iv.start[i]
                and merged.end[j] >= iv.end[i]]
        assert len(hits) == 1
    # merged intervals on the same chrom are separated by > dist
    for j in range(len(merged) - 1):
        if merged.chrom[j] == merged.chrom[j + 1]:
            assert merged.start[j + 1] - merged.end[j] > dist


def test_merge_collapse_distinct():
    iv = Intervals.from_rows(
        [("c", 0, 10, "a"), ("c", 5, 15, "b"), ("c", 12, 20, "a"),
         ("c", 100, 110, "z")], ("fam",))
    m = merge_intervals(iv, dist=0, collapse={"fam": "distinct"}, delim="|")
    assert len(m) == 2
    assert m.cols["fam"][0] == "a|b"
    assert m.cols["fam"][1] == "z"
    m2 = merge_intervals(iv, dist=0, collapse={"fam": "collapse"}, delim=";")
    assert m2.cols["fam"][0] == "a;b;a"


@pytest.mark.parametrize("seed", range(4))
def test_intersect_wao_brute(seed):
    rng = np.random.default_rng(seed)
    a = _random_intervals(rng, 25)
    b = _random_intervals(rng, 25)
    got = intersect_wao(a, b)
    # brute force
    want = []
    for i in range(len(a)):
        found = False
        for j in range(len(b)):
            if a.chrom[i] == b.chrom[j]:
                ov = min(a.end[i], b.end[j]) - max(a.start[i], b.start[j])
                if ov > 0:
                    want.append((i, j, int(ov)))
                    found = True
        if not found:
            want.append((i, -1, 0))
    assert sorted(got) == sorted(want)


def test_closest_distance_semantics():
    # bedtools: overlap -> 0; abutting -> 1
    a = Intervals.from_rows([("c", 10, 20)])
    b = Intervals.from_rows([("c", 20, 30)])
    res = closest(a, b)[0]
    assert res == [(0, 0, 1)]
    b2 = Intervals.from_rows([("c", 15, 30)])
    assert closest(a, b2)[0] == [(0, 0, 0)]
    b3 = Intervals.from_rows([("c", 0, 5)])
    assert closest(a, b3)[0] == [(0, 0, 6)]


def test_closest_signed_dref():
    a = Intervals.from_rows([("c", 100, 200)])
    up = ("c", 50, 90)     # upstream: negative
    dn = ("c", 210, 250)   # downstream: positive
    b = Intervals.from_rows([up, dn])
    res = closest(a, b, signed=True, k=2)[0]
    dists = {b_idx: d for _, b_idx, d in res}
    assert dists[0] == -11
    assert dists[1] == 11


def test_closest_same_strand_and_ties():
    a = Intervals.from_rows([("c", 100, 200, "x", 0, "+")],
                            ("name", "score", "strand"))
    b = Intervals.from_rows(
        [("c", 210, 220, "p", 0, "+"), ("c", 80, 90, "m", 0, "+"),
         ("c", 205, 215, "neg", 0, "-")], ("name", "score", "strand"))
    res = closest(a, b, same_strand=True)[0]
    # both '+' hits at distance 11, '-' hit excluded; ties all reported
    assert {b_idx for _, b_idx, _ in res} == {0, 1}
    assert all(d == 11 for _, _, d in res)


def test_closest_no_candidates():
    a = Intervals.from_rows([("c", 0, 10)])
    b = Intervals.from_rows([("other", 0, 10)])
    assert closest(a, b)[0] == [(0, -1, -1)]


def test_sort_lexicographic():
    iv = Intervals.from_rows(
        [("chr10", 5, 6), ("chr2", 1, 2), ("chr10", 1, 3), ("chr1", 9, 10)])
    s = iv.sort()
    assert s.chrom == ["chr1", "chr10", "chr10", "chr2"]
    assert list(s.start) == [9, 1, 5, 1]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("same_strand,signed", [(False, False), (True, True)])
def test_closest_brute_random(seed, k, same_strand, signed):
    """Pruned-window closest vs an exhaustive per-row reference, with
    coordinate collisions to force distance ties (-t all)."""
    rng = np.random.default_rng(seed)
    nb, na = 200, 40
    chroms = ["c1", "c2"]
    def mk(n):
        ch = [chroms[i] for i in rng.integers(0, 2, n)]
        s = rng.integers(0, 500, n)          # small range -> many ties
        e = s + rng.integers(1, 40, n)
        st = [["+", "-"][i] for i in rng.integers(0, 2, n)]
        return Intervals(chrom=ch, start=s, end=e, cols={"strand": st})
    a, b = mk(na), mk(nb)

    def dist_u(as_, ae, bs, be):
        if bs < ae and be > as_:
            return 0
        return bs - ae + 1 if bs >= ae else as_ - be + 1

    got = closest(a, b, same_strand=same_strand, signed=signed, k=k)
    for ai in range(na):
        cands = []
        for bi in range(nb):
            if b.chrom[bi] != a.chrom[ai]:
                continue
            if same_strand and b.cols["strand"][bi] != a.cols["strand"][ai]:
                continue
            d = dist_u(int(a.start[ai]), int(a.end[ai]),
                       int(b.start[bi]), int(b.end[bi]))
            if signed and d != 0 and int(b.end[bi]) <= int(a.start[ai]):
                d = -d
            cands.append((abs(d), bi, d))
        if not cands:
            assert got[ai] == [(ai, -1, -1)]
            continue
        cands.sort(key=lambda t: (t[0], t[1]))
        kept, ranks = [], []
        for absd, bi, d in cands:
            if absd not in ranks:
                if len(ranks) >= k:
                    break
                ranks.append(absd)
            kept.append((ai, bi, d))
        assert got[ai] == kept, f"ai={ai}"

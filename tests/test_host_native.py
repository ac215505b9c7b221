"""Parity: native host runtime (host_native.cpp) vs the NumPy oracles."""
import copy

import numpy as np
import pytest

from hypo_tpu.config import MINIMIZER_SETTINGS as MS
from hypo_tpu.dna import canonical_kmers, kmer_codes
from hypo_tpu.native import host_api

@pytest.fixture(autouse=True)
def _native_built():
    """Builds (on first use) and loads the native libraries; decided
    here rather than at import, where xdist workers would all compile
    while collecting."""
    if not (host_api.available()):
        pytest.skip("native host lib unavailable")


class FakeAln:
    def __init__(self, codes, rb, re):
        self.codes = np.asarray(codes, dtype=np.uint8)
        self.rb = rb
        self.re = re


def _random_genome(rng, n):
    return rng.integers(0, 4, n).astype(np.uint8)


def test_count_kmers_dense_parity():
    rng = np.random.default_rng(0)
    k = 7
    codes = rng.integers(0, 4, 5000).astype(np.uint8)
    codes[rng.integers(0, 5000, 30)] = 4  # sprinkle N separators
    km, valid = kmer_codes(codes, k)
    can = canonical_kmers(km[valid], k)
    expect = np.bincount(can, minlength=4 ** k).astype(np.uint32)
    table = np.zeros(4 ** k, dtype=np.uint32)
    host_api.count_kmers_dense(codes, k, table)
    assert np.array_equal(table, expect)


def _fake_contig_for_skmer(rng, n, k, nsolid):
    class C:
        pass

    c = C()
    pos = np.sort(rng.choice(n - k, nsolid, replace=False))
    c.solid_pos = pos.astype(np.int64)
    c.genome = _random_genome(rng, n)
    km, _ = kmer_codes(c.genome, k)
    c.kids = km[pos]
    c.kmer_coverage = np.zeros(nsolid, dtype=np.int64)
    c.kmer_support = np.zeros(nsolid, dtype=np.int64)
    return c


def test_skmer_support_parity():
    from hypo_tpu.segment.support import update_solidkmers_support
    rng = np.random.default_rng(1)
    k = 9
    n = 4000
    c1 = _fake_contig_for_skmer(rng, n, k, 200)
    c2 = copy.deepcopy(c1)
    alns = []
    for _ in range(150):
        rb = int(rng.integers(0, n - 200))
        ln = int(rng.integers(50, 180))
        re = min(n, rb + ln)
        codes = c1.genome[rb:re].copy()
        # add noise so matches are non-trivial
        idx = rng.integers(0, len(codes), max(1, len(codes) // 30))
        codes[idx] = rng.integers(0, 4, len(idx))
        alns.append(FakeAln(codes, rb, re))
    update_solidkmers_support(c1, alns, k)
    host_api.skmer_support(c2, alns, k, nthreads=4)
    assert np.array_equal(c1.kmer_coverage, c2.kmer_coverage)
    assert np.array_equal(c1.kmer_support, c2.kmer_support)


def _fake_contig_for_minimizer(rng, n):
    from hypo_tpu.segment.minimizers import build_mw_minimizer_info

    class C:
        pass

    c = C()
    c.genome = _random_genome(rng, n)
    # alternating SR / MW regions of uneven sizes
    cuts = np.sort(rng.choice(np.arange(50, n - 50), 11, replace=False))
    starts = np.concatenate([[0], cuts, [n]]).astype(np.int64)
    c.stage1_starts = starts
    c.is_win_even = True  # regions 0,2,4,... are MegaWindows
    nreg = len(starts) - 1
    vs, ps = [], []
    off = [0]
    for j in range(nreg):
        if (j % 2 == 0) == c.is_win_even:
            s, e = int(starts[j]), int(starts[j + 1])
            mi = build_mw_minimizer_info(c.genome[s:e])
            vs.append(mi.minimisers)
            ps.append(s + np.cumsum(mi.rel_pos))
            off.append(off[-1] + len(mi.minimisers))
    c.mw_off = np.array(off, np.int64)
    c.mw_vals = (np.concatenate(vs) if vs else np.zeros(0, np.int64))
    c.mw_pos = (np.concatenate(ps) if ps else np.zeros(0, np.int64))
    c.mw_cov = np.zeros(len(c.mw_vals), np.int32)
    c.mw_sup = np.zeros(len(c.mw_vals), np.int32)
    return c


def test_minimizer_support_parity():
    from hypo_tpu.segment.support import update_minimisers_support
    rng = np.random.default_rng(2)
    n = 6000
    c1 = _fake_contig_for_minimizer(rng, n)
    c2 = copy.deepcopy(c1)
    alns = []
    for _ in range(200):
        rb = int(rng.integers(0, n - 250))
        ln = int(rng.integers(80, 240))
        re = min(n, rb + ln)
        codes = c1.genome[rb:re].copy()
        idx = rng.integers(0, len(codes), max(1, len(codes) // 25))
        codes[idx] = rng.integers(0, 4, len(idx))
        alns.append(FakeAln(codes, rb, re))
    update_minimisers_support(c1, alns)
    host_api.minimizer_support(c2, alns, MS.k, MS.w, nthreads=4)
    assert np.array_equal(c1.mw_cov, c2.mw_cov)
    assert np.array_equal(c1.mw_sup, c2.mw_sup)


def test_mw_minimizer_build_parity():
    """Native flat MW-minimizer builder == the per-MW python oracle
    (build_mw_minimizer_info), including N handling and poly/unique
    filters."""
    from hypo_tpu.config import MINIMIZER_SETTINGS as MS2
    from hypo_tpu.segment.minimizers import _POLY, build_mw_minimizer_info
    rng = np.random.default_rng(7)
    n = 20000
    genome = _random_genome(rng, n)
    genome[rng.integers(0, n, 25)] = 4          # sprinkle N
    cuts = np.sort(rng.choice(np.arange(100, n - 100), 29, replace=False))
    bounds = np.concatenate([[0], cuts, [n]]).astype(np.int64)
    begs, ends = bounds[:-1], bounds[1:]
    min_len = 100
    off, vals, pos = host_api.mw_minimizer_build(
        genome, begs, ends, MS2.k, MS2.w, min_len,
        np.array(_POLY, np.int64), nthreads=4)
    for i in range(len(begs)):
        b, e = int(begs[i]), int(ends[i])
        got_v = vals[off[i]:off[i + 1]]
        got_p = pos[off[i]:off[i + 1]]
        if e - b <= min_len:
            assert len(got_v) == 0
            continue
        mi = build_mw_minimizer_info(genome[b:e])
        assert np.array_equal(got_v, mi.minimisers), f"MW {i} values"
        assert np.array_equal(got_p, b + np.cumsum(mi.rel_pos)), \
            f"MW {i} positions"

"""Native (C++) POA engine must match the Python oracle exactly."""
import numpy as np
import pytest

from hypo_tpu.config import ScoreParams
from hypo_tpu.dna import encode
from hypo_tpu import native
from hypo_tpu.poa import Graph, PoaAligner, NW, LOV, ROV
from hypo_tpu.poa.engine import ConsensusEngine
from hypo_tpu.pipeline.window import Window, SHORT, LONG

@pytest.fixture(autouse=True)
def _native_built():
    """Builds (on first use) and loads the native libraries; decided
    here rather than at import, where xdist workers would all compile
    while collecting."""
    if not (native.available()):
        pytest.skip("native lib unavailable (no g++)")


def rand_seq(rng, lo, hi):
    return "".join(rng.choice(list("ACGT"), size=int(rng.integers(lo, hi))))


def mutate(rng, seq, rate):
    out = []
    for c in seq:
        r = rng.random()
        if r < rate / 3:
            continue
        if r < 2 * rate / 3:
            out.append(rng.choice(list("ACGT")))
        out.append(c)
    return "".join(out)


@pytest.mark.parametrize("scores", [(5, -4, -8), (3, -5, -4)])
def test_native_graph_matches_python(scores):
    rng = np.random.default_rng(30)
    for trial in range(10):
        base = rand_seq(rng, 30, 120)
        py = Graph()
        nat = native.NativeGraph()
        aligner = PoaAligner(*scores)
        seqs = [("J" + mutate(rng, base, 0.1) + "O", NW)
                for _ in range(3)]
        cut = int(rng.integers(5, len(base)))
        seqs.append(("J" + mutate(rng, base[:cut], 0.1), LOV))
        seqs.append((mutate(rng, base[cut:], 0.1) + "O", ROV))
        for seq, mode in seqs:
            want = aligner.align(seq, py, mode)
            got = nat.align(seq, mode, *scores)
            assert got == want, trial
            py.add_alignment(want, seq)
            nat.add_alignment(got, seq)
            assert nat.num_nodes() == len(py.nodes)
        assert nat.consensus() == py.generate_consensus()
        pc, pd = py.generate_consensus_custom()
        nc, nd = nat.consensus_custom()
        assert (nc, nd) == (pc, pd)


def test_native_extract_matches_python():
    from hypo_tpu.poa import jax_poa
    rng = np.random.default_rng(31)
    base = rand_seq(rng, 40, 80)
    py = Graph()
    nat = native.NativeGraph()
    aligner = PoaAligner(5, -4, -8)
    for _ in range(4):
        s = mutate(rng, base, 0.15)
        a = aligner.align(s, py, NW)
        py.add_alignment(a, s)
        nat.add_alignment(a, s)
    want = jax_poa.extract_graph_arrays(py, 256, 8)
    got = nat.extract(256, 8)
    assert got is not None and want is not None
    wn, wp, wc, we, wnn = want
    gn, gp, gc, ge, gnn, grank = got
    assert gnn == wnn
    assert np.array_equal(gn[:gnn], wn[:wnn])
    assert np.array_equal(gp[:gnn], wp[:wnn])
    assert np.array_equal(gc[:gnn], wc[:wnn])
    assert np.array_equal(ge[:gnn], we[:wnn])
    assert grank[:gnn].tolist() == py.rank_to_node_id


def _window(rng, wtype):
    base = rand_seq(rng, 40, 140)
    w = Window(encode(base), wtype)
    for _ in range(int(rng.integers(0, 6))):
        w.add_internal(encode(mutate(rng, base, 0.08)))
    for _ in range(int(rng.integers(0, 3))):
        cut = int(rng.integers(5, len(base)))
        w.add_prefix(encode(mutate(rng, base[:cut], 0.08)))
    for _ in range(int(rng.integers(0, 3))):
        cut = int(rng.integers(5, len(base)))
        w.add_suffix(encode(mutate(rng, base[cut:], 0.08)))
    for _ in range(int(rng.integers(0, 2))):
        w.add_empty()
    return w


def test_native_window_consensus_matches_oracle():
    sp = ScoreParams()
    py_eng = ConsensusEngine(sp, use_native=False)
    nat_eng = ConsensusEngine(sp, use_native=True)
    assert nat_eng.use_native
    rng = np.random.default_rng(32)
    wins_py = [_window(rng, SHORT if i % 3 else LONG) for i in range(30)]
    rng = np.random.default_rng(32)
    wins_nat = [_window(rng, SHORT if i % 3 else LONG) for i in range(30)]
    for i, (wp, wn) in enumerate(zip(wins_py, wins_nat)):
        py_eng.generate_consensus(wp)
        nat_eng.generate_consensus(wn)
        assert wn.consensus == wp.consensus, i


def test_native_edit_distance_matches_python_twin():
    """hypo_edit_distance_banded == the banded numpy DP in
    utils.alnutil (same band rule), on random edits."""
    import random

    import numpy as np

    from hypo_tpu.native.host_api import edit_distance_banded
    if edit_distance_banded(b"A", b"A") is None:
        import pytest
        pytest.skip("native host lib unavailable")

    def py_ed(a, b, band=0):
        if a == b:
            return 0
        x = np.frombuffer(a.encode(), dtype=np.uint8).astype(np.int64)
        y = np.frombuffer(b.encode(), dtype=np.uint8).astype(np.int64)
        if len(x) > len(y):
            x, y = y, x
        n, m = len(x), len(y)
        if band <= 0:
            band = 2 * (m - n) + 64
        band = min(band, m)
        INF = 1 << 40
        prev = np.full(2 * band + 1, INF, dtype=np.int64)
        prev[band:] = np.arange(band + 1)
        for i in range(1, n + 1):
            cur = np.full(2 * band + 1, INF, dtype=np.int64)
            lo, hi = max(0, i - band), min(m, i + band)
            js = np.arange(lo, hi + 1)
            ks = js - i + band
            sub = np.full(len(js), 1, dtype=np.int64)
            valid = js >= 1
            sub[valid] = (y[js[valid] - 1] != x[i - 1]).astype(np.int64)
            diag = prev[ks]
            up = np.full(len(js), INF, dtype=np.int64)
            up_ok = ks + 1 <= 2 * band
            up[up_ok] = prev[ks[up_ok] + 1]
            cand = np.minimum(diag + sub, up + 1)
            if js[0] == 0:
                cand[0] = i
            cur[ks] = cand
            tt = np.arange(len(ks))
            left = np.minimum.accumulate(cur[ks] - tt)
            cur[ks] = np.minimum(cur[ks], left + tt)
            prev = cur
        return int(prev[m - n + band])

    random.seed(3)
    for _ in range(25):
        n = random.randint(1, 250)
        a = "".join(random.choice("ACGT") for _ in range(n))
        b = list(a)
        for _ in range(random.randint(0, 10)):
            i = random.randrange(len(b)) if b else 0
            op = random.random()
            if op < 0.4 and b:
                b[i] = random.choice("ACGT")
            elif op < 0.7 and b:
                del b[i]
            else:
                b.insert(i, random.choice("ACGT"))
        b = "".join(b)
        assert edit_distance_banded(a.encode(), b.encode()) == py_ed(a, b)

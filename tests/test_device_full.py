"""Tests for the fully on-device POA kernel (hypo_tpu.poa.device_full)
against its executable NumPy spec (hypo_tpu.poa.colpoa_ref), and for the
spec against the spoa-semantics oracle."""
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hypo_tpu.poa.colpoa_ref import ColPoa
from hypo_tpu.poa import device_full as DF
from hypo_tpu.poa.jax_poa import GLOBAL_ALPHABET, GLOBAL_CODE

NW, LOV, ROV = 0, 1, 2


def _mutate(rng, codes, rate):
    out = []
    for c in codes:
        r = rng.random()
        if r < rate / 3:
            continue
        elif r < 2 * rate / 3:
            out.append(int(rng.integers(4)))
            out.append(c)
        elif r < rate:
            out.append(int(rng.integers(4)))
        else:
            out.append(c)
    return out


def _random_jobs(rng, B, K, L, tlen, err, with_modes=True):
    arms = np.zeros((B, K, L), np.int32)
    alen = np.zeros((B, K), np.int32)
    amode = np.zeros((B, K), np.int32)
    narms = np.zeros(B, np.int32)
    specs = []
    for b in range(B):
        truth = [int(x) for x in rng.integers(0, 4, size=tlen)]
        seqs = []
        for _ in range(int(rng.integers(3, K))):
            md = (int(rng.choice([NW, NW, NW, LOV, ROV]))
                  if with_modes else NW)
            s = _mutate(rng, truth, err)
            if md == NW:
                s = [4] + s + [5]
            elif md == LOV:
                s = [4] + s[:max(1, len(s) // 2)]
            else:
                s = s[len(s) // 2:] + [5]
            seqs.append((s[:L], md))
        narms[b] = len(seqs)
        for k, (s, md) in enumerate(seqs):
            arms[b, k, :len(s)] = s
            alen[b, k] = len(s)
            amode[b, k] = md
        specs.append(seqs)
    return arms, alen, amode, narms, specs


@pytest.mark.parametrize("caps", [(128, 64, 12, 8), (96, 48, 10, 4)])
def test_kernel_matches_colpoa_spec(caps):
    N, L, K, P = caps
    rng = np.random.default_rng(N + P)
    B = 8
    arms, alen, amode, narms, specs = _random_jobs(
        rng, B, K, L, tlen=36, err=0.12)
    cc, cs, cl, ovf = DF.poa_full_batch(
        arms, alen, amode, narms, N=N, L=L, K=K, P=P, m=5, n=-4, g=-8)
    cc, cs, cl, ovf = map(np.asarray, (cc, cs, cl, ovf))
    n_checked = 0
    for b in range(B):
        if ovf[b]:
            continue
        cp = ColPoa(5, -4, -8)
        for s, md in specs[b]:
            cp.add(s, md)
        codes, sup = cp.consensus()
        assert cc[b, :cl[b]].tolist() == codes
        assert cs[b, :cl[b]].tolist() == sup
        n_checked += 1
    assert n_checked >= B // 2


def test_kernel_flags_overflow_and_matches_elsewhere():
    N, L, K, P = 64, 48, 12, 2
    rng = np.random.default_rng(99)
    B = 16
    arms, alen, amode, narms, specs = _random_jobs(
        rng, B, K, L, tlen=30, err=0.25)
    cc, cs, cl, ovf = DF.poa_full_batch(
        arms, alen, amode, narms, N=N, L=L, K=K, P=P, m=5, n=-4, g=-8)
    cc, cs, cl, ovf = map(np.asarray, (cc, cs, cl, ovf))
    for b in range(B):
        cp = ColPoa(5, -4, -8)
        ref_ovf = False
        for s, md in specs[b]:
            cp.add(s, md)
            if (len(cp.node_code) > N
                    or max((len(p) for p in cp.pred_nd), default=0) > P):
                ref_ovf = True
                break
        if ref_ovf:
            assert ovf[b], "device must flag what the spec overflows"
        elif not ovf[b]:
            codes, sup = cp.consensus()
            assert cc[b, :cl[b]].tolist() == codes
            assert cs[b, :cl[b]].tolist() == sup


def test_colpoa_spec_matches_spoa_oracle_consensus():
    """The deliberate tie-order differences (colpoa_ref docstring) do not
    change the consensus on randomized realistic windows."""
    from hypo_tpu.poa.graph import Graph
    from hypo_tpu.poa.align import PoaAligner
    rng = np.random.default_rng(5)
    n_ident = 0
    trials = 15
    for _ in range(trials):
        truth = [int(x) for x in rng.integers(0, 4, size=50)]
        seqs = []
        for _ in range(int(rng.integers(4, 10))):
            s = [4] + _mutate(rng, truth, 0.1) + [5]
            seqs.append("".join(GLOBAL_ALPHABET[c] for c in s))
        g = Graph()
        al = PoaAligner(5, -4, -8)
        for s in seqs:
            g.add_alignment(al.align(s, g, 0), s)
        cons_o = g.generate_consensus()
        cp = ColPoa(5, -4, -8)
        for s in seqs:
            cp.add([GLOBAL_CODE[c] for c in s], NW)
        codes, _sup = cp.consensus()
        cons_c = "".join(GLOBAL_ALPHABET[c] for c in codes)
        if cons_o == cons_c:
            n_ident += 1
    assert n_ident >= trials - 1


def test_full_runner_end_to_end_quality(tmp_path):
    """Pipeline with device_poa_mode='full' must polish as well as the
    host engine."""
    from hypo_tpu.config import InputFlags, get_kmer_len
    from hypo_tpu.pipeline.polish import polish
    from hypo_tpu.sim import SimConfig, simulate
    from hypo_tpu.eval_qv import compare
    paths = simulate(SimConfig(genome_size=8000, seed=7,
                               draft_error_rate=0.012), str(tmp_path))
    flags = InputFlags(
        sr_filenames=[paths["reads"]],
        sr_bam_filename=paths["sr_bam"],
        draft_filename=paths["draft"],
        output_filename=str(tmp_path / "polished.fa"),
        k=max(2, get_kmer_len(str(paths["genome_size"]))),
        cov=paths["short_cov"],
        use_device_poa=True,
        device_poa_mode="full",
    )
    polish(flags)
    before = compare(paths["truth"], paths["draft"])
    after = compare(paths["truth"], flags.output_filename)
    assert after["edit_distance"] < 0.25 * before["edit_distance"]


def test_weighted_add_equals_sequential_duplicates():
    """spec.add(arm, mode, w=k) must be bit-identical to k sequential
    adds of the same arm (the dedup optimization's contract)."""
    rng = np.random.default_rng(11)
    for _ in range(10):
        truth = [int(x) for x in rng.integers(0, 4, size=40)]
        variants = []
        for _ in range(4):
            s = [4] + _mutate(rng, truth, 0.08) + [5]
            variants.append(s)
        plan = [(variants[int(rng.integers(4))],
                 int(rng.integers(1, 4))) for _ in range(5)]
        a = ColPoa(5, -4, -8)
        b = ColPoa(5, -4, -8)
        for s, w in plan:
            a.add(s, NW, w=w)
            for _ in range(w):
                b.add(s, NW)
        assert a.consensus() == b.consensus()
        assert a.node_sup == b.node_sup
        assert a.pred_w == b.pred_w


def test_runner_dedup_matches_weighted_spec():
    """FullDeviceRunner's packed+deduped device path must match the
    weighted spec on the same dedup plan."""
    from hypo_tpu.poa.full_runner import _dedup
    rng = np.random.default_rng(13)
    truth = [int(x) for x in rng.integers(0, 4, size=30)]
    seqs = []
    for _ in range(12):
        s = [4] + _mutate(rng, truth, 0.05) + [5]
        seqs.append(("".join(GLOBAL_ALPHABET[c] for c in s), NW))
    dd = _dedup(seqs)
    assert sum(w for _s, _m, w in dd) == len(seqs)
    assert len(dd) < len(seqs)  # err 0.05 on len 30 -> duplicates exist
    # weighted spec == sequential spec
    a = ColPoa(5, -4, -8)
    for s, md, w in dd:
        a.add([GLOBAL_CODE[c] for c in s], md, w=w)
    b = ColPoa(5, -4, -8)
    for s, md, w in dd:   # device order = dedup order
        for _ in range(w):
            b.add([GLOBAL_CODE[c] for c in s], md)
    assert a.consensus() == b.consensus()


# -- exactness of the one-hot products ------------------------------------

def _tile_program(ci, B):
    from hypo_tpu.poa.full_runner import CLASSES, P_FULL
    L, N, K, _B, _A = CLASSES[ci]
    A = 2 * B * K
    fn = DF.build_tile_program(N=N, L=L, K=K, P=P_FULL, m=5, n=-4, g=-8,
                               B=B, A=A, ndev=1)
    return fn, (L, N, K, A)


def _zero_tile(B, L, K, A):
    return (np.zeros((A, L), np.int8), np.zeros(A, np.int32),
            np.full((B, K), -1, np.int32), np.zeros((B, K), np.int8),
            np.zeros((B, K), np.int32), np.zeros(B, np.int32),
            np.zeros(B, np.int32))


@pytest.mark.parametrize("ci", [0, 1])
def test_tile_program_products_are_exact(ci):
    """A float32 product at DEFAULT precision may run in TF32 on a GPU
    and round integers above 2048; every dot_general of the tile
    program must be HIGHEST or integer."""
    B = 8
    fn, (L, N, K, A) = _tile_program(ci, B)
    text = fn.lower(*_zero_tile(B, L, K, A)).as_text()
    dots = [ln for ln in text.splitlines() if "stablehlo.dot_general" in ln]
    assert len(dots) >= 10
    for ln in dots:
        types = re.findall(r"tensor<[0-9x]*x([a-z]+[0-9]+)>",
                           ln.split(" : ", 1)[1])
        exact = "precision = [HIGHEST, HIGHEST]" in ln or all(
            t.startswith(("i", "ui")) for t in types)
        assert exact, ln


def _heavy_tie_window(rng, L):
    """Two arms that differ in one base, deduplicated to weights 3001
    and 3000.  The join node's two in-edges then weigh 3001 and 3000;
    rounded to TF32 (11 significant bits) both are 3000, and the tie
    rule takes the later predecessor: the lighter branch."""
    x = [int(c) for c in rng.integers(0, 4, 20)]
    y = [int(c) for c in rng.integers(0, 4, 20)]
    heavy = [4] + x + [0] + y + [5]
    light = [4] + x + [1] + y + [5]
    assert len(heavy) <= L
    return [(heavy, NW, 3001), (light, NW, 3000)]


def _tf32(x):
    """Round float32 to TF32's 10 stored mantissa bits (half to even)."""
    bits = jax.lax.bitcast_convert_type(x, jnp.uint32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~jnp.uint32(0x1FFF)
    return jax.lax.bitcast_convert_type(bits, jnp.float32)


def _run_tile_on(fn, B, L, K, A, windows):
    """Packs [(arm codes, mode, weight), ...] per window into one tile
    and returns the unpacked (codes, lengths, ovf)."""
    pool = np.zeros((A, L), np.int8)
    plen = np.zeros(A, np.int32)
    idx = np.full((B, K), -1, np.int32)
    amode = np.zeros((B, K), np.int8)
    aw = np.zeros((B, K), np.int32)
    narms = np.zeros(B, np.int32)
    r = 0
    for b, arms in enumerate(windows):
        narms[b] = len(arms)
        for k, (s, md, w) in enumerate(arms):
            pool[r, :len(s)] = s
            plen[r] = len(s)
            idx[b, k] = r
            amode[b, k] = md
            aw[b, k] = w
            r += 1
    packed = np.asarray(fn(pool, plen, idx, amode, aw, narms,
                           np.zeros(B, np.int32)))
    half = packed.shape[1] - 4
    nib = packed[:, :half].view(np.uint8)
    codes = np.stack([nib & 0xF, nib >> 4], axis=2).reshape(B, 2 * half)
    clen = (packed[:, half].view(np.uint8).astype(np.int32)
            | (packed[:, half + 1].view(np.uint8).astype(np.int32) << 8))
    return codes, clen, packed[:, half + 2] != 0


def test_heavy_weight_window_matches_colpoa(monkeypatch):
    """Weights 3001/3000 through the tile program and poa_full_batch
    give ColPoa's consensus; with TF32-rounded products they would
    not (so the window really tests exactness)."""
    rng = np.random.default_rng(3001)
    B = 8
    fn, (L, N, K, A) = _tile_program(0, B)
    arms = _heavy_tie_window(rng, L)
    cp = ColPoa(5, -4, -8)
    for s, md, w in arms:
        cp.add(s, md, w=w)
    ref_codes, ref_sup = cp.consensus()
    assert ref_codes[21] == 0 and max(ref_sup) == 6001

    codes, clen, ovf = _run_tile_on(fn, B, L, K, A, [arms])
    assert not ovf[0]
    assert codes[0, :clen[0]].tolist() == ref_codes

    a = np.zeros((1, K, L), np.int32)
    alen = np.zeros((1, K), np.int32)
    amode = np.zeros((1, K), np.int32)
    aw = np.zeros((1, K), np.int32)
    for k, (s, md, w) in enumerate(arms):
        a[0, k, :len(s)] = s
        alen[0, k], amode[0, k], aw[0, k] = len(s), md, w
    cc, cs, cl, fl = map(np.asarray, DF.poa_full_batch(
        a, alen, amode, np.array([len(arms)], np.int32), N=N, L=L, K=K,
        P=8, m=5, n=-4, g=-8, arm_w=aw))
    assert not fl[0]
    assert cc[0, :cl[0]].tolist() == ref_codes
    assert cs[0, :cl[0]].tolist() == ref_sup

    def ohdot_tf32(spec, x, y):
        return jnp.einsum(spec, _tf32(x.astype(jnp.float32)),
                          _tf32(y.astype(jnp.float32)),
                          precision=jax.lax.Precision.HIGHEST
                          ).astype(jnp.int32)

    monkeypatch.setattr(DF, "_ohdot", ohdot_tf32)
    DF.build_tile_program.cache_clear()
    try:
        fn_tf32, _shape = _tile_program(0, B)
        codes, clen, _ovf = _run_tile_on(fn_tf32, B, L, K, A, [arms])
        assert codes[0, :clen[0]].tolist() != ref_codes
    finally:
        DF.build_tile_program.cache_clear()


@pytest.mark.gpu
def test_tile_program_on_gpu_matches_colpoa(gpu):
    """On the card: a class-0 tile of random windows plus the heavy
    3001/3000 window equals ColPoa exactly."""
    rng = np.random.default_rng(77)
    B = 64
    fn, (L, N, K, A) = _tile_program(0, B)
    windows = [_heavy_tie_window(rng, L)]
    arms, alen, amode, narms, specs = _random_jobs(
        rng, B - 1, K, L, tlen=60, err=0.08)
    windows += [[(s, md, 1) for s, md in spec] for spec in specs]
    codes, clen, ovf = _run_tile_on(fn, B, L, K, A, windows)
    for b, win in enumerate(windows):
        cp = ColPoa(5, -4, -8)
        for s, md, w in win:
            cp.add(s, md, w=w)
        if not ovf[b]:
            assert codes[b, :clen[b]].tolist() == cp.consensus()[0], b
    assert not ovf[0] and ovf.sum() < B // 4

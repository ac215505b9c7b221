#!/usr/bin/env python3
"""Smoke test of the window-consensus device path on a GPU.

Run from the repository root:

    python3 chip_smoke.py           # one card
    python3 chip_smoke.py --four    # the four-card path, and nothing else

One card, in this order:

  a. device   JAX's default backend must be a GPU; prints its kind and
              count, and nvidia-smi's name and power limit.
  b. compile  the tile program of shape classes 0 and 1 at the
              production tile size: compile seconds, memory_analysis().
  d. short    an E. coli-sized draft (4.6 Mbp, 30x short reads) polished
              through the CLI path with the device engine and with the
              host engine: equal md5, polished edit distance below the
              draft's, tiles dispatched.
  e. hybrid   phase d with 25x noisy long reads and short-read dropout.
  c. parity   about 2,000 class-0 windows captured from the tiles the
              native job builder packed in phases d and e, 200 class-1
              windows (synthetic where those runs route none to class
              1), and one constructed window with arm weights
              3001/3000, through the tile program and through
              poa_full_batch: compared exactly with the ColPoa reference.

--four: an 8-contig 4.6 Mbp draft polished once with --nproc 4 (one
process per card) and once in one process whose tiles are sharded over
all four cards; both byte-equal to the host engine's output.

Every phase that fails stops the script with a non-zero exit.  The last
line of stdout is {"ok": true, "device": {...}} and is printed only
when every phase passed.
"""
import argparse
import contextlib
import hashlib
import io
import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke")
GENOME = 4_600_000
SCORES = (5, -4, -8)            # short-read match, mismatch, gap
WANT = {0: 2000, 1: 200}        # windows per class for phase c


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"[smoke] FAIL: {msg}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def md5(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.md5(fh.read()).hexdigest()


def simulate(name: str, *flags: str) -> str:
    out = os.path.join(WORK, name)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "hypo_tpu.sim", "--out", out,
                    *flags], cwd=REPO, check=True, capture_output=True,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
    log(f"simulated {name} ({' '.join(flags)}) in "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def cli_args(sim: str, out: str, device: bool, threads: int,
             extra=()) -> list:
    args = ["-r", f"{sim}/reads.fq.gz", "-d", f"{sim}/draft.fa",
            "-b", f"{sim}/sr.bam", "-c", "30", "-s", str(GENOME),
            "-t", str(threads), "-o", out,
            "--aux-dir", out + ".aux",
            "--device-poa" if device else "--no-device-poa", *extra]
    if os.path.exists(f"{sim}/lr.bam"):
        args += ["-B", f"{sim}/lr.bam"]
    return args


def polish(argv: list):
    """The CLI's path in this process (as hypo_tpu.cli.main runs it),
    returning the Polisher and what it printed to stdout."""
    from hypo_tpu.cli import build_parser, flags_from_args
    from hypo_tpu.pipeline.polish import Polisher
    p = Polisher(flags_from_args(build_parser().parse_args(argv)))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        p.polish()
    sys.stderr.write(buf.getvalue())
    return p, buf.getvalue()


def stage_seconds(p, prefix: str) -> float:
    return next(s for msg, s in p.monitor.times if msg.startswith(prefix))


def poa_windows(p) -> int:
    msg = next(m for m, _s in p.monitor.times if "POA over" in m)
    return int(re.search(r"POA over (\d+) windows", msg).group(1))


def end_to_end(tag: str, sim: str, threads: int, expect_devices: int):
    """Device engine vs host engine on one simulated dataset."""
    from hypo_tpu.eval_qv import compare
    dev_out = os.path.join(sim, "device.fa")
    host_out = os.path.join(sim, "host.fa")
    pd, printed = polish(cli_args(sim, dev_out, True, threads))
    line = next((ln for ln in printed.splitlines()
                 if "device POA:" in ln), "")
    log(f"{tag}: {line.strip()}")
    if ("platform=gpu" not in line
            or f"devices={expect_devices}" not in line):
        fail(f"{tag}: device runner line {line!r}")
    ph, _ = polish(cli_args(sim, host_out, False, threads))
    st = pd.device_runner.stats
    routes = {k: int(st[k]) for k in (
        "full_windows", "full_dispatches", "trivial_windows",
        "full_overflows", "host_fallbacks", "host_long_windows")}
    nwin = poa_windows(pd)
    rows = {}
    for name, p in (("device", pd), ("host", ph)):
        poa_s = stage_seconds(p, "[hypo_tpu] POA over")
        rows[name] = dict(
            poa_s=poa_s, total_s=stage_seconds(p, "[hypo_tpu] Overall"),
            windows=poa_windows(p), windows_per_s=poa_windows(p) / poa_s)
    log(f"{tag}: routes {json.dumps(routes)}")
    for name, r in rows.items():
        log(f"{tag}: {name} engine: POA stage {r['poa_s']:.2f} s, total "
            f"{r['total_s']:.2f} s, {r['windows']} windows, "
            f"{r['windows_per_s']:.0f} windows/s")
    h_dev, h_host = md5(dev_out), md5(host_out)
    draft = compare(f"{sim}/truth.fa", f"{sim}/draft.fa")["edit_distance"]
    after = compare(f"{sim}/truth.fa", dev_out)["edit_distance"]
    log(f"{tag}: md5 device {h_dev} host {h_host}; edit distance draft "
        f"{draft} -> polished {after}")
    if h_dev != h_host:
        fail(f"{tag}: device output differs from the host engine's")
    if not after < draft:
        fail(f"{tag}: polishing did not lower the edit distance")
    if routes["full_dispatches"] <= 0 or routes["full_windows"] <= 0:
        fail(f"{tag}: no tile reached the device ({routes})")
    if nwin != rows["host"]["windows"]:
        fail(f"{tag}: window counts differ")
    return pd


# -- phase c: exact parity with the ColPoa reference ---------------------

def reference(job):
    """ColPoa on one window's [(codes, mode, weight), ...]: (codes,
    supports, overflowed) with the tile program's node and predecessor
    caps."""
    from hypo_tpu.poa.colpoa_ref import ColPoa
    arms, N, P = job
    cp = ColPoa(*SCORES)
    for s, md, w in arms:
        cp.add(s, md, w=w)
        if (len(cp.node_code) > N
                or max(map(len, cp.pred_nd), default=0) > P):
            return None, None, True
    codes, sups = cp.consensus()
    return codes, sups, False


def tile_windows(tile):
    """Per occupied row of a packed tile: its [(codes, mode, weight)]."""
    pool, plen, idx, amode, aw, narms, _th = tile
    rows = np.nonzero(narms > 0)[0]
    return rows, [[(pool[idx[b, k], :plen[idx[b, k]]].tolist(),
                    int(amode[b, k]), int(aw[b, k]))
                   for k in range(narms[b])] for b in rows]


def pack_tiles(windows, B: int, K: int, L: int, A: int):
    """Greedy packing of [(codes, mode, weight), ...] windows into tiles
    of at most B windows and A pool rows (one row per arm)."""
    tiles, lo = [], 0
    while lo < len(windows):
        hi, rows = lo, 0
        while (hi < len(windows) and hi - lo < B
               and rows + len(windows[hi]) <= A):
            rows += len(windows[hi])
            hi += 1
        pool = np.zeros((A, L), np.int8)
        plen = np.zeros(A, np.int32)
        idx = np.full((B, K), -1, np.int32)
        amode = np.zeros((B, K), np.int8)
        aw = np.zeros((B, K), np.int32)
        narms = np.zeros(B, np.int32)
        r = 0
        for b, win in enumerate(windows[lo:hi]):
            narms[b] = len(win)
            for k, (s, md, w) in enumerate(win):
                pool[r, :len(s)] = s
                plen[r] = len(s)
                idx[b, k], amode[b, k], aw[b, k] = r, md, w
                r += 1
        tiles.append((pool, plen, idx, amode, aw, narms,
                      np.zeros(B, np.int32)))
        lo = hi
    return tiles


def synthetic_windows(n: int, K: int, L: int, seed: int):
    """n windows of L/4 to L-30 bases (128-480 for class 1): 3..K arms per
    window, each the truth with ~1% substitutions and indels, mostly
    J..O arms (NW) with some prefix (LOV) and suffix (ROV) arms, and
    weights 1-4 as deduplication leaves them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        truth = rng.integers(0, 4, int(rng.integers(L // 4 + 1, L - 30)))
        win = []
        for _a in range(int(rng.integers(3, K + 1))):
            s = truth.copy()
            for _e in range(int(rng.integers(0, 5))):
                p = int(rng.integers(len(s)))
                kind = int(rng.integers(3))
                if kind == 0:
                    s[p] = (s[p] + 1) % 4
                elif kind == 1:
                    s = np.delete(s, p)
                else:
                    s = np.insert(s, p, int(rng.integers(4)))
            md = int(rng.choice([0, 0, 0, 1, 2]))
            s = s.tolist()
            if md == 0:
                s = [4] + s + [5]
            elif md == 1:
                s = [4] + s[:len(s) // 2]
            else:
                s = s[len(s) // 2:] + [5]
            win.append((s[:L], md, int(rng.integers(1, 5))))
        out.append(win)
    return out


def heavy_tie_tile(B: int, K: int, L: int, A: int):
    """One class-0 tile holding one window of two arms that differ in
    one base, deduplicated to weights 3001 and 3000.  Rounded to TF32
    (11 significant bits) both weights are 3000, and the tie rule then
    takes the later predecessor: the lighter branch."""
    rng = np.random.default_rng(3001)
    x = rng.integers(0, 4, 20).tolist()
    y = rng.integers(0, 4, 20).tolist()
    arms = [[4] + x + [0] + y + [5], [4] + x + [1] + y + [5]]
    pool = np.zeros((A, L), np.int8)
    plen = np.zeros(A, np.int32)
    idx = np.full((B, K), -1, np.int32)
    aw = np.zeros((B, K), np.int32)
    for k, (s, w) in enumerate(zip(arms, (3001, 3000))):
        pool[k, :len(s)] = s
        plen[k] = len(s)
        idx[0, k] = k
        aw[0, k] = w
    narms = np.zeros(B, np.int32)
    narms[0] = 2
    return (pool, plen, idx, np.zeros((B, K), np.int8), aw, narms,
            np.zeros(B, np.int32))


def unpack(packed: np.ndarray):
    half = packed.shape[1] - 4
    nib = packed[:, :half].view(np.uint8)
    codes = np.stack([nib & 0xF, nib >> 4], axis=2).reshape(
        len(packed), 2 * half)
    clen = (packed[:, half].view(np.uint8).astype(np.int32)
            | (packed[:, half + 1].view(np.uint8).astype(np.int32) << 8))
    return codes, clen, packed[:, half + 2] != 0


def compare_tile(runner, ci: int, tile, pool):
    """Mismatches of the tile program and of poa_full_batch against
    ColPoa on every occupied row of one packed tile: (windows,
    mismatches, reference results)."""
    from hypo_tpu.poa.device_full import poa_full_batch
    from hypo_tpu.poa.full_runner import P_FULL
    L, N, K, _B, _A = runner._class_shape(ci)
    rows, wins = tile_windows(tile)
    refs = pool.map(reference, [(w, N, P_FULL) for w in wins],
                    chunksize=16)
    codes, clen, ovf = unpack(np.asarray(
        runner._program(ci, SCORES)(*tile)))
    arm_pool, plen, idx, amode, aw, narms, th = tile
    valid = idx >= 0
    r = np.maximum(idx, 0)
    arms = np.where(valid[:, :, None], arm_pool[r], 0).astype(np.int32)
    alen = np.where(valid, plen[r], 0)
    cc, cs, cl, fl = map(np.asarray, poa_full_batch(
        arms, alen, amode.astype(np.int32), narms, N=N, L=L, K=K,
        P=P_FULL, m=SCORES[0], n=SCORES[1], g=SCORES[2], arm_w=aw))
    bad = 0
    for b, (rc, rs, rovf) in zip(rows, refs):
        if rovf:
            bad += int(not ovf[b]) + int(not fl[b])
            continue
        keep = [c for c, s in zip(rc, rs) if s >= th[b]]
        bad += int(bool(ovf[b]) or codes[b, :clen[b]].tolist() != keep)
        bad += int(bool(fl[b]) or cc[b, :cl[b]].tolist() != rc
                   or cs[b, :cl[b]].tolist() != rs)
    return len(rows), bad, refs


def parity(runner, captured, pool) -> int:
    """Phase c: mismatches against ColPoa over the captured tiles and
    the constructed heavy-weight window."""
    total = 0
    for ci, tiles in sorted(captured.items()):
        n_real = sum(int((t[5] > 0).sum()) for t in tiles)
        if n_real < WANT[ci]:
            L, N, K, B, A = runner._class_shape(ci)
            extra = pack_tiles(synthetic_windows(
                WANT[ci] - n_real, K, L, seed=ci), B, K, L, A)
            log(f"c. class {ci}: {n_real} windows from the pipeline, "
                f"{WANT[ci] - n_real} synthetic in {len(extra)} tiles")
            tiles = tiles + extra
        n_win = bad = 0
        for tile in tiles:
            n, b, _refs = compare_tile(runner, ci, tile, pool)
            n_win += n
            bad += b
        log(f"c. class {ci}: {n_win} windows in {len(tiles)} tiles, "
            f"{bad} mismatches")
        total += bad
    L, N, K, B, A = runner._class_shape(0)
    _n, bad, refs = compare_tile(runner, 0, heavy_tie_tile(B, K, L, A),
                                 pool)
    rc, rs, _ovf = refs[0]
    log(f"c. 3001/3000-weight window: max support {max(rs)}, branch base "
        f"{'ACGTJO'[rc[21]]}, {bad} mismatches")
    return total + bad


def capture_tiles(captured):
    """Wraps FullDeviceRunner._program so that the host-side inputs of
    the first real tiles of each class are kept for phase c."""
    from hypo_tpu.poa.full_runner import FullDeviceRunner
    orig = FullDeviceRunner._program

    def program(self, ci, scores):
        fn = orig(self, ci, scores)

        def tile(*args):
            have = sum(int((t[5] > 0).sum()) for t in captured[ci])
            if args[5].max() > 0 and have < WANT[ci]:
                captured[ci].append(tuple(np.array(a) for a in args))
            return fn(*args)
        return tile

    FullDeviceRunner._program = program
    return orig


def one_card() -> dict:
    import jax
    jax.config.update("jax_cuda_visible_devices", "0")
    from hypo_tpu.utils.jax_cache import enable_compilation_cache
    cache = enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        fail(f"JAX's default backend is {dev.platform!r}, not a GPU")
    smi = nvidia_smi()
    log(f"a. device: platform={dev.platform} kind={dev.device_kind} "
        f"count={jax.device_count()}; compile cache {cache}")
    log(f"a. nvidia-smi: {smi}")

    from hypo_tpu.config import ScoreParams
    from hypo_tpu.poa.full_runner import FullDeviceRunner
    runner = FullDeviceRunner(ScoreParams())
    for ci in (0, 1):
        L, N, K, B, A = runner._class_shape(ci)
        zero = (np.zeros((A, L), np.int8), np.zeros(A, np.int32),
                np.full((B, K), -1, np.int32), np.zeros((B, K), np.int8),
                np.zeros((B, K), np.int32), np.zeros(B, np.int32),
                np.zeros(B, np.int32))
        fn = runner._program(ci, SCORES)
        t0 = time.perf_counter()
        mem = fn.lower(*zero).compile().memory_analysis()
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*zero))
        log(f"b. class {ci} (L={L} N={N} K={K} B={B} A={A}): compile "
            f"{compile_s:.1f} s, first call {time.perf_counter() - t0:.1f}"
            f" s; memory_analysis: temp {mem.temp_size_in_bytes} B, "
            f"arguments {mem.argument_size_in_bytes} B, output "
            f"{mem.output_size_in_bytes} B")

    threads = os.cpu_count() or 1
    captured = {0: [], 1: []}
    orig = capture_tiles(captured)
    try:
        end_to_end("d. short", simulate(
            "short", "--genome-size", str(GENOME), "--short-cov", "30",
            "--seed", "1"), threads, 1)
        end_to_end("e. hybrid", simulate(
            "hybrid", "--genome-size", str(GENOME), "--short-cov", "30",
            "--long-cov", "25", "--dropout", "0.30,0.33", "--seed", "3"),
            threads, 1)
    finally:
        FullDeviceRunner._program = orig
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(threads) as pool:
        bad = parity(runner, captured, pool)
    log(f"c. mismatches against ColPoa: {bad}")
    if bad:
        fail(f"{bad} mismatches against ColPoa")
    if not captured[0]:
        fail("phase c captured no class-0 tile from the pipeline")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": jax.device_count()}


def four_cards() -> dict:
    """The --nproc processes run first, while this process is still off
    JAX (a JAX process reserves most of every card it opens)."""
    sim = simulate("four", "--genome-size", str(GENOME), "--num-contigs",
                   "8", "--short-cov", "30", "--seed", "2")
    threads = os.cpu_count() or 1
    host_out = os.path.join(sim, "host.fa")
    polish(cli_args(sim, host_out, False, threads))
    nproc_out = os.path.join(sim, "nproc.fa")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hypo_tpu.cli",
         *cli_args(sim, nproc_out, True, max(1, threads // 4),
                   ["--nproc", "4", "--procid", str(i)])],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(4)]
    try:
        outs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        line = next((ln for ln in out.splitlines() if "device POA:" in ln),
                    "")
        log(f"--nproc 4, rank {i}: rc={p.returncode} {line.strip()}")
        if p.returncode != 0 or "devices=1" not in line:
            sys.stderr.write(out[-4000:])
            fail(f"--nproc rank {i} failed")
    log(f"--nproc 4: {time.perf_counter() - t0:.1f} s wall")

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu" or jax.device_count() != 4:
        fail(f"need four GPUs, JAX sees {jax.device_count()} "
             f"{dev.platform}")
    log(f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={jax.device_count()}")
    log(f"nvidia-smi: {nvidia_smi()}")
    one_out = os.path.join(sim, "four_cards.fa")
    p, printed = polish(cli_args(sim, one_out, True, threads))
    st = p.device_runner.stats
    log(f"one process over 4 cards: "
        f"{next(ln for ln in printed.splitlines() if 'device POA:' in ln)}"
        f"; POA stage {stage_seconds(p, '[hypo_tpu] POA over'):.2f} s; "
        f"{st['full_dispatches']} tiles, rows per card "
        f"{st['rows_per_device'].tolist()}")
    hashes = {name: md5(os.path.join(sim, f"{name}.fa"))
              for name in ("host", "nproc", "four_cards")}
    log(f"md5 {json.dumps(hashes)}")
    if len(set(hashes.values())) != 1:
        fail("four-card outputs differ from the host engine's")
    if st["full_dispatches"] <= 0 or min(st["rows_per_device"]) <= 0:
        fail("some card ran no tile rows")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": jax.device_count()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    device = four_cards() if args.four else one_card()
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()

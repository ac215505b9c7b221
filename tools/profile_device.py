"""Per-scope times of the device tile program, on the card.

Builds a mid-POA window state on the device (a few mutated arms per
window through the arm step), then times each part of one arm step and
of the tile's finish, each as its own jitted program, with
block_until_ready after a warm-up call:

  rank   _rank_arrays_batch          (topological ranks, once per arm step)
  dp     vmapped _dp row scan        (graph-vs-arm alignment)
  tb     _traceback_matched_batch    (lockstep backpointer walk)
  merge  vmapped _merge              (graph merge of the aligned arm)
  cons   _consensus_batch            (heaviest-bundle wavefront, once per tile)
  step   one whole _arm_step_batch
  tile   the production tile program on a tile of synthetic windows

Options:
  --classes 0 1      shape classes (poa.full_runner.CLASSES) to time
  --sweep-b B ...    also time class 0's tile program at these tile sizes
  --reps R           timed calls per measurement (median reported)

Every result is one JSON line on stdout, after a line with the card's
``nvidia-smi`` name and power limit.

Usage: python tools/profile_device.py --classes 0 1 --sweep-b 1024 4096
"""
import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hypo_tpu.poa import device_full as df  # noqa: E402
from hypo_tpu.poa.full_runner import CLASSES, P_FULL  # noqa: E402
from hypo_tpu.utils.jax_cache import enable_compilation_cache  # noqa: E402

M, X, G = 5, -4, -8


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def timed(fn, *args, reps: int):
    """(compile+first call seconds, median seconds of `reps` calls)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts))


def synthetic_arms(rng, B: int, n_arms: int, L: int):
    """n_arms mutated copies (~3% substitutions, every third with one
    deletion) of one random base sequence per window, as J..O arms."""
    base_len = L - 6
    arms = np.zeros((n_arms, B, L), np.int32)
    alens = np.zeros((n_arms, B), np.int32)
    base = rng.integers(0, 4, (B, base_len))
    nmut = max(1, int(0.03 * base_len))
    for a in range(n_arms):
        s = base.copy()
        for w in range(B):
            pos = rng.choice(base_len, nmut, replace=False)
            s[w, pos] = (s[w, pos] + rng.integers(1, 4, nmut)) % 4
        cut = base_len if a % 3 != 1 else base_len - 1
        arms[a, :, 0] = 4
        arms[a, :, 1:1 + cut] = s[:, :cut]
        arms[a, :, 1 + cut] = 5
        alens[a] = cut + 2
    return arms, alens


def tile_inputs(arms, alens, A: int, K: int):
    """Packs the synthetic arms as a tile: every arm its own pool row
    (weight 1), as many arms per window as the pool cap A holds (2 at
    the CLASSES caps, where A = 2 B)."""
    n_arms, B, L = arms.shape
    per = max(1, min(n_arms, A // B, K))
    pool = np.zeros((A, L), np.int8)
    plen = np.zeros(A, np.int32)
    idx = np.full((B, K), -1, np.int32)
    for a in range(per):
        rows = a * B + np.arange(B)
        pool[rows] = arms[a]
        plen[rows] = alens[a]
        idx[:, a] = rows
    return (pool, plen, idx, np.zeros((B, K), np.int8),
            np.ones((B, K), np.int32), np.full(B, per, np.int32),
            np.zeros(B, np.int32))


def profile_class(ci: int, reps: int, rng) -> None:
    L, N, K, B, A = CLASSES[ci]
    P = P_FULL
    kw = dict(N=N, L=L, P=P)
    n_pre = 5
    arms, alens = synthetic_arms(rng, B, n_pre + 1, L)
    mode = jnp.zeros(B, jnp.int32)
    active = jnp.ones(B, bool)
    step = jax.jit(functools.partial(df._arm_step_batch, m=M, n=X, g=G,
                                     **kw))
    st = df._bcast_state(N, P, B)
    t0 = time.perf_counter()
    for a in range(n_pre):
        st = step(st, arms[a], alens[a], mode, active)
    jax.block_until_ready(st)
    emit(cls=ci, what="state", B=B, arm_steps=n_pre,
         seconds=time.perf_counter() - t0,
         mean_nodes=float(np.mean(np.asarray(st.n_nodes))))
    arm, alen = jnp.asarray(arms[n_pre]), jnp.asarray(alens[n_pre])

    rank = jax.jit(functools.partial(df._rank_arrays_batch, N=N))
    ra = rank(st)
    dp = jax.jit(jax.vmap(functools.partial(df._dp, m=M, n=X, g=G, **kw)))
    dp_args = (ra.node_code_r, ra.pred_rows, ra.pred_cnt_r, ra.is_end_r,
               st.n_nodes, arm, alen, mode)
    bp, max_row = dp(*dp_args)
    tb = jax.jit(functools.partial(df._traceback_matched_batch, **kw))
    matched = tb(bp, ra.pred_rows, alen, mode, max_row)
    merge = jax.jit(jax.vmap(functools.partial(df._merge, **kw)))
    w1 = jnp.ones(B, jnp.int32)
    cons = jax.jit(functools.partial(df._consensus_batch, N=N, P=P))
    scopes = (("rank", rank, (st,)),
              ("dp", dp, dp_args),
              ("tb", tb, (bp, ra.pred_rows, alen, mode, max_row)),
              ("merge", merge, (st, ra.order, ra.node_col_r, matched,
                                arm, alen, w1)),
              ("cons", cons, (st,)),
              ("step", step, (st, arm, alen, mode, active)))
    for name, fn, args in scopes:
        first, med = timed(fn, *args, reps=reps)
        emit(cls=ci, what="scope", scope=name, B=B, first_s=first,
             ms=med * 1e3)

    tile_once(ci, B, A, tile_inputs(arms, alens, A, K), reps)


def tile_once(ci: int, B: int, A: int, tile_args, reps: int):
    L, N, K, _B, _A = CLASSES[ci]
    fn = df.build_tile_program(N=N, L=L, K=K, P=P_FULL, m=M, n=X, g=G,
                               B=B, A=A, ndev=1)
    t0 = time.perf_counter()
    compiled = fn.lower(*tile_args).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    _first, med = timed(compiled, *tile_args, reps=reps)
    emit(cls=ci, what="tile", B=B, A=A,
         arm_steps=int(tile_args[5].max()), compile_s=compile_s,
         ms=med * 1e3, windows_per_s=B / med,
         temp_bytes=int(mem.temp_size_in_bytes),
         argument_bytes=int(mem.argument_size_in_bytes),
         output_bytes=int(mem.output_size_in_bytes))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--classes", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--sweep-b", type=int, nargs="*", default=[])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform == "gpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    else:
        smi = "no GPU: these times are not device metrics"
    print(f"[prof] {dev.platform} {dev.device_kind} x{jax.device_count()}"
          f" | nvidia-smi: {smi}", flush=True)
    rng = np.random.default_rng(0)
    for ci in args.classes:
        profile_class(ci, args.reps, rng)
    L, N, K, _B, _A = CLASSES[0]
    for B in args.sweep_b:
        arms, alens = synthetic_arms(rng, B, 6, L)
        tile_once(0, B, 2 * B, tile_inputs(arms, alens, 2 * B, K),
                  args.reps)


if __name__ == "__main__":
    main()

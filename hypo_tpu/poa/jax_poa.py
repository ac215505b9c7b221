"""Batched sequence-to-graph DP on device (JAX/XLA), tie-exact with the
NumPy oracle in hypo_tpu.poa.align.

Design: the POA inner loop is one fused jitted
program per (N, L, P) bucket, vmapped over a batch of windows.  Each
window's graph is a set of fixed-capacity arrays in topological rank
order; one lax.scan row sweep computes the DP matrix AND an int8
backpointer plane whose per-cell code is chosen in exactly the
reference's traceback priority (diag pred0.., vert pred0.., horizontal —
sisd_alignment_engine.cpp:363-428), so the host traceback is a cheap
pointer walk with no score re-derivation.  The in-row horizontal
dependency is a cummax associative scan (the reference's SIMD engine
resolves the same dependency with a log-step prefix max,
simd_alignment_engine.cpp:727-799).

Alphabet is global and fixed (A,C,G,T + J/O markers), so the device
never sees per-graph code tables.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

import jax
import jax.numpy as jnp

NW, LOV, ROV = 0, 1, 2
NEG = -(2 ** 30)
# plain Python int: a module-level jnp scalar would be captured as a
# device-array constant and destroys kernel perf (~600x, measured)
NEG16 = -16384

# global alphabet codes (order fixed; host graphs keep their own coders)
GLOBAL_ALPHABET = "ACGTJO"
GLOBAL_CODE = {c: i for i, c in enumerate(GLOBAL_ALPHABET)}


def encode_global(seq: str) -> np.ndarray:
    return np.array([GLOBAL_CODE[c] for c in seq], dtype=np.int32)


@functools.partial(jax.jit,
                   static_argnames=("N", "L", "P", "m", "n", "g"))
def poa_dp_batch(node_code, pred_rows, pred_cnt, is_end, n_nodes, arm,
                 arm_len, mode, *, N: int, L: int, P: int, m: int, n: int,
                 g: int):
    """One DP round for a batch of windows.

    Shapes: node_code [B,N] i32 (rank order, global codes);
    pred_rows [B,N,P] i32 (H-row indices = rank+1; no-pred nodes get one
    entry 0); pred_cnt [B,N] i32; is_end [B,N] bool (no out-edges);
    n_nodes [B] i32; arm [B,L] i32; arm_len [B] i32; mode [B] i32.

    Returns (bp [B,N+1,L+1] int8, max_row [B] i32).  bp codes:
    0..P-1 diag via pred p, P..2P-1 vertical via pred p, 2P horizontal.
    """
    def one(node_code, pred_rows, pred_cnt, is_end, n_nodes, arm, arm_len,
            mode):
        return _dp_one(node_code, pred_rows, pred_cnt, is_end, n_nodes,
                       arm, arm_len, mode, N=N, L=L, P=P, m=m, n=n, g=g)

    return jax.vmap(one)(node_code, pred_rows, pred_cnt, is_end, n_nodes,
                         arm, arm_len, mode)


@functools.partial(jax.jit,
                   static_argnames=("N", "L", "P", "m", "n", "g"))
def poa_dp_tb_batch(node_code, pred_rows, pred_cnt, is_end, n_nodes, arm,
                    arm_len, mode, *, N: int, L: int, P: int, m: int,
                    n: int, g: int):
    """DP + in-kernel traceback.  Returns (ti, tj, steps, max_row):
    ti [B,S] int16 = emitted graph rank or -1 per step (backward order),
    tj [B,S] int16 = emitted query index or -1, steps [B] int32.
    S = N + L + 1.  Host converts ranks to node ids and reverses."""
    S = N + L + 1

    def one(node_code, pred_rows, pred_cnt, is_end, n_nodes, arm,
            arm_len, mode):
        bp, max_row = _dp_one(node_code, pred_rows, pred_cnt, is_end,
                              n_nodes, arm, arm_len, mode,
                              N=N, L=L, P=P, m=m, n=n, g=g)

        def cond(state):
            i, j, t, _ti, _tj = state
            stop_nw = (i == 0) & (j == 0)
            stop_rov = (i == 0) | (j == 0)
            stop = jnp.where(mode == ROV, stop_rov, stop_nw)
            return (~stop) & (t < S)

        def body(state):
            i, j, t, ti, tj = state
            code = bp[i, j].astype(jnp.int32)
            is_vert = (code >= P) & (code < 2 * P)
            is_horiz = code == 2 * P
            pidx = jnp.where(code < P, code, code - P)
            pred = pred_rows[jnp.maximum(i - 1, 0), pidx]
            prev_i = jnp.where(is_horiz, i, pred)
            prev_j = jnp.where(is_vert, j, j - 1)
            # row 0: only horizontal moves are possible
            prev_i = jnp.where(i == 0, 0, prev_i)
            prev_j = jnp.where(i == 0, j - 1, prev_j)
            emit_rank = jnp.where(prev_i == i, -1, i - 1)
            emit_seq = jnp.where(prev_j == j, -1, j - 1)
            ti = ti.at[t].set(emit_rank.astype(jnp.int16))
            tj = tj.at[t].set(emit_seq.astype(jnp.int16))
            return (prev_i, prev_j, t + 1, ti, tj)

        ti0 = jnp.full((S,), -2, dtype=jnp.int16)
        tj0 = jnp.full((S,), -2, dtype=jnp.int16)
        i0 = max_row
        j0 = arm_len
        i_f, j_f, t_f, ti, tj = jax.lax.while_loop(
            cond, body, (i0, j0, jnp.int32(0), ti0, tj0))
        return ti, tj, t_f, max_row

    return jax.vmap(one)(node_code, pred_rows, pred_cnt, is_end, n_nodes,
                         arm, arm_len, mode)


def _dp_one(node_code, pred_rows, pred_cnt, is_end, n_nodes, arm,
            arm_len, mode, *, N, L, P, m, n, g):
    """Single-window DP (shared by poa_dp_batch and poa_dp_tb_batch).

    Scores are int16: |H| <= max(|m|,|n|,|g|)*(N+L) plus the NEG16
    sentinel drift stays well inside int16 for every bucket shape we
    emit (N+L <= ~1.5k at |g|<=8), and int16 halves the bytes of the
    row sweep against int32."""
    jj = (jnp.arange(L + 1, dtype=jnp.int32) * g).astype(jnp.int16)
    parange = jnp.arange(P, dtype=jnp.int32)
    H = jnp.full((N + 1, L + 1), NEG16, dtype=jnp.int16)
    H = H.at[0].set(jj)
    m16, n16, g16 = jnp.int16(m), jnp.int16(n), jnp.int16(g)

    def row_step(H, r):
        code = node_code[r]
        prows = pred_rows[r]
        if P == 1:
            # every node carries >= 1 predecessor entry, so no masking
            Hp = H[prows]
        else:
            pvalid = parange < pred_cnt[r]
            Hp = jnp.where(pvalid[:, None], H[prows], NEG16)
        prof = jnp.where(arm == code, m16, n16)
        diag = Hp[:, :-1] + prof[None, :]
        vert = Hp[:, 1:] + g16
        tmp = jnp.max(jnp.maximum(diag, vert), axis=0)
        col0 = jnp.where(mode == ROV, jnp.int16(0),
                         jnp.max(Hp[:, 0]) + g16).astype(jnp.int16)
        val = jnp.concatenate([col0[None], tmp])
        run = jax.lax.cummax(val - jj)
        row = run + jj
        h = row[1:]
        # tie-exact backpointers by priority select chain (first hit in
        # [diag p0..pP-1, vert p0..pP-1, horiz] wins — the reference's
        # traceback order, sisd_alignment_engine.cpp:363-428).  Invalid
        # predecessor slots hold NEG-ish scores and can never equal h.
        bp_j = jnp.full(h.shape, 2 * P, dtype=jnp.int8)
        for p in range(P - 1, -1, -1):
            bp_j = jnp.where(vert[p] == h, jnp.int8(P + p), bp_j)
        for p in range(P - 1, -1, -1):
            bp_j = jnp.where(diag[p] == h, jnp.int8(p), bp_j)
        bp_0 = jnp.int8(P)
        if P > 1:
            vert0 = (Hp[:, 0] + g16 == col0)
            bp_0 = (P + jnp.argmax(vert0)).astype(jnp.int8)
        bp_row = jnp.concatenate([jnp.broadcast_to(bp_0, (1,)), bp_j])
        H = jax.lax.dynamic_update_slice(H, row[None, :], (r + 1, 0))
        return H, bp_row

    H, bp_rows = jax.lax.scan(row_step, H,
                              jnp.arange(N, dtype=jnp.int32))
    at_L = H[1:, arm_len]
    valid_row = jnp.arange(N) < n_nodes
    elig = jnp.where(mode == LOV, valid_row, valid_row & is_end)
    masked = jnp.where(elig, at_L, NEG16)
    max_row = (jnp.argmax(masked) + 1).astype(jnp.int32)
    bp = jnp.concatenate([jnp.zeros((1, L + 1), jnp.int8), bp_rows],
                         axis=0)
    return bp, max_row


def alignment_from_steps(ti: np.ndarray, tj: np.ndarray, steps: int,
                         rank_ids: np.ndarray) -> List[Tuple[int, int]]:
    """Convert a device traceback (backward order, ranks) into the
    alignment pair list (forward order, node ids), vectorized."""
    ti = ti[:steps][::-1].astype(np.int64)
    tj = tj[:steps][::-1].astype(np.int64)
    nodes = np.where(ti < 0, -1, rank_ids[np.maximum(ti, 0)])
    return list(zip(nodes.tolist(), tj.tolist()))


def traceback_from_bp(bp: np.ndarray, pred_rows: np.ndarray,
                      rank_to_node_id: List[int], arm_len: int, mode: int,
                      max_row: int, P: int) -> List[Tuple[int, int]]:
    """Host pointer walk; mirrors the oracle traceback loop structure
    (row 0 can only move horizontally, H[0,j] = j*g)."""
    i = int(max_row)
    j = int(arm_len)
    alignment: List[Tuple[int, int]] = []
    while True:
        if mode in (NW, LOV):
            if i == 0 and j == 0:
                break
        else:  # ROV
            if i == 0 or j == 0:
                break
        if i == 0:
            alignment.append((-1, j - 1))
            j -= 1
            continue
        code = int(bp[i, j])
        if code < P:          # diagonal
            prev_i = int(pred_rows[i - 1, code])
            prev_j = j - 1
        elif code < 2 * P:    # vertical
            prev_i = int(pred_rows[i - 1, code - P])
            prev_j = j
        else:                 # horizontal
            prev_i = i
            prev_j = j - 1
        alignment.append((
            -1 if prev_i == i else rank_to_node_id[i - 1],
            -1 if prev_j == j else j - 1))
        i, j = prev_i, prev_j
    alignment.reverse()
    return alignment


def extract_graph_arrays(graph, N: int, P: int):
    """Flatten a host Graph into the fixed-shape arrays the DP consumes.
    Returns None if the graph exceeds the (N, P) caps."""
    nn = len(graph.rank_to_node_id)
    if nn > N:
        return None
    rank_of = {}
    for r, nid in enumerate(graph.rank_to_node_id):
        rank_of[nid] = r
    node_code = np.zeros(N, dtype=np.int32)
    pred_rows = np.zeros((N, P), dtype=np.int32)
    pred_cnt = np.ones(N, dtype=np.int32)
    is_end = np.zeros(N, dtype=bool)
    for r, nid in enumerate(graph.rank_to_node_id):
        node = graph.nodes[nid]
        node_code[r] = GLOBAL_CODE[graph.decoder[node.code]]
        if node.in_edges:
            if len(node.in_edges) > P:
                return None
            pred_cnt[r] = len(node.in_edges)
            for p, e in enumerate(node.in_edges):
                pred_rows[r, p] = rank_of[e.begin] + 1
        is_end[r] = not node.out_edges
    return node_code, pred_rows, pred_cnt, is_end, nn

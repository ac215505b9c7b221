"""Fully on-device POA: the entire multi-arm partial-order-alignment of
a window — DP, traceback, graph merge, topological maintenance, and
heaviest-bundle consensus — runs as ONE jitted device program per window
batch tile.

Motivation: the reference's per-arm loop (align -> add_alignment ->
re-topo-sort, external/spoa/src/graph.cpp:154-353) forces one
host<->device round trip per arm round when only the DP runs on device.
This program removes every round trip: the host uploads packed arms once
and downloads the finished consensus once.

Algorithm ("column-POA"): the executable NumPy twin with identical
tie-breaking lives in hypo_tpu.poa.colpoa_ref (see its docstring for
the two deliberate tie-order differences vs spoa).  Key ideas:

- spoa's aligned-node groups become *columns*: ``col_node[c, base]``
  resolves the group search (graph.cpp:206-259) with one lookup.
- the topological order is (column position, node id); every column
  holds at most NCODES nodes, so ranks are computed by COUNTING
  (nodes in earlier columns + smaller ids in the same column) — no
  argsort anywhere.
- irregular indexing is expressed as one-hot compare+reduce or one-hot
  matrix products.  Every such product goes through ``_ohdot``, which
  is exact for the integer values carried here (node ids, supports,
  edge weights): a float32 product at the default precision may run in
  TF32 on a GPU, which rounds any value above 2048.
- the merge of an alignment path is fully vectorized: the path reduces
  to per-arm-position arrays (matched rank, last-matched cummax), and
  all node creation / column insertion / edge upsert / support updates
  are unique-index one-hot updates.
- traceback runs as a batched while loop whose body does O(B) work per
  step; heaviest-bundle consensus is a data-parallel wavefront
  relaxation iterated to its fixpoint.

Everything is fixed-shape: N node/column capacity, L arm length cap,
K arm count cap, P predecessor cap.  Windows that overflow any cap get
a sticky per-window ``ovf`` flag and fall back to the host engine.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

NW, LOV, ROV = 0, 1, 2
NEG = -(2 ** 30)
BIG = 2 ** 30
NCODES = 6  # A C G T J O


class PoaState(NamedTuple):
    node_code: jnp.ndarray   # [N] i32
    node_col: jnp.ndarray    # [N] i32
    node_sup: jnp.ndarray    # [N] i32
    pred_nd: jnp.ndarray     # [N, P] i32 (node ids, -1 empty)
    pred_w: jnp.ndarray      # [N, P] i32 (sequence counts)
    pred_cnt: jnp.ndarray    # [N] i32
    out_cnt: jnp.ndarray     # [N] i32
    col_pos: jnp.ndarray     # [N] i32 (column -> topo position)
    col_node: jnp.ndarray    # [N, NCODES] i32 (-1 empty)
    n_nodes: jnp.ndarray     # i32
    n_cols: jnp.ndarray      # i32
    ovf: jnp.ndarray         # bool


def init_state(N: int, P: int) -> PoaState:
    return PoaState(
        node_code=jnp.zeros(N, jnp.int32),
        node_col=jnp.zeros(N, jnp.int32),
        node_sup=jnp.zeros(N, jnp.int32),
        pred_nd=jnp.full((N, P), -1, jnp.int32),
        pred_w=jnp.zeros((N, P), jnp.int32),
        pred_cnt=jnp.zeros(N, jnp.int32),
        out_cnt=jnp.zeros(N, jnp.int32),
        col_pos=jnp.zeros(N, jnp.int32),
        col_node=jnp.full((N, NCODES), -1, jnp.int32),
        n_nodes=jnp.int32(0),
        n_cols=jnp.int32(0),
        ovf=jnp.bool_(False),
    )


class RankArrays(NamedTuple):
    """Per-rank views of the graph (leading batch dim B everywhere)."""
    order: jnp.ndarray       # [B, N] node id at rank r (0 past n_nodes)
    rank_of: jnp.ndarray     # [B, N] rank of node v (BIG invalid)
    node_code_r: jnp.ndarray  # [B, N]
    node_col_r: jnp.ndarray   # [B, N]
    node_sup_r: jnp.ndarray   # [B, N]
    pred_nd_r: jnp.ndarray    # [B, N, P] node ids (-1 empty)
    pred_ranks: jnp.ndarray   # [B, N, P] pred ranks (-1 empty)
    pred_rows: jnp.ndarray    # [B, N, P] pred rank + 1 (0 empty)
    pred_cnt_r: jnp.ndarray   # [B, N] (clamped >= 1)
    pred_w_r: jnp.ndarray     # [B, N, P]
    is_end_r: jnp.ndarray     # [B, N] bool


# -- one-hot helpers ----------------------------------------------------------
#
# All irregular reads/writes below hit UNIQUE indices (an alignment
# path visits each column/node/edge at most once — see colpoa_ref), so
# gather reduces to a masked max over a one-hot and scatter reduces to
# sum-over-sources.


def _oh(idx, mask, M: int):
    """Boolean one-hot [..., M] of idx, all-false where ~mask."""
    sel = jnp.where(mask, idx, -1)
    return sel[..., None] == jnp.arange(M, dtype=jnp.int32)


def _ohdot(spec: str, a, b):
    """Exact integer einsum of two integer/boolean operands -> int32.

    The operands are one-hots and integer values below 2^24, so a
    float32 product is exact only at HIGHEST precision (DEFAULT may use
    TF32, which keeps 11 significant bits)."""
    return jnp.einsum(spec, a.astype(jnp.float32), b.astype(jnp.float32),
                      precision=jax.lax.Precision.HIGHEST
                      ).astype(jnp.int32)


def _selmax(ohb, vals, default):
    """vals[idx[l]] per source l (unique-hit gather): max over the
    one-hot row, `default` where no hit.  vals [..., M] broadcastable
    against ohb [..., L, M]."""
    return jnp.max(jnp.where(ohb, vals, default), axis=-1)


def _mv(oh, vals):
    """sum_l oh[l, m] * vals[l] -> [M] i32 (per window; vmapped)."""
    return _ohdot("lm,l->m", oh, vals)


def _set_oh(old, oh, vals):
    val = _mv(oh, vals)
    cov = jnp.any(oh, axis=0)
    return jnp.where(cov, val.astype(old.dtype), old)


def _rank_arrays_batch(st: PoaState, N: int) -> RankArrays:
    """Topological order: (column position, node id) — computed by
    counting instead of argsort.  rank(v) = #nodes in columns placed
    before v's column + #smaller-id nodes in v's column."""
    B = st.node_code.shape[0]
    P = st.pred_nd.shape[2]
    idx = jnp.arange(N, dtype=jnp.int32)
    nvalid = idx[None, :] < st.n_nodes[:, None]          # [B, N]
    cvalid = idx[None, :] < st.n_cols[:, None]
    col_cnt = jnp.sum(st.col_node >= 0, axis=2)          # [B, N]
    pos = st.col_pos
    before = ((pos[:, None, :] < pos[:, :, None])
              & cvalid[:, None, :])                      # [B, c, c']
    base_col = _ohdot("bcd,bd->bc", before, col_cnt)
    oh_ncol = _oh(st.node_col, nvalid, N)                # [B, v, c]
    base_at = _selmax(oh_ncol, base_col[:, None, :], 0)
    within = jnp.sum(
        (st.node_col[:, :, None] == st.node_col[:, None, :])
        & (idx[None, None, :] < idx[None, :, None])
        & nvalid[:, None, :], axis=2).astype(jnp.int32)
    rank_of = jnp.where(nvalid, base_at + within, BIG)
    oh_rank = _oh(rank_of, nvalid, N)                    # [B, v, r]
    order = jnp.max(jnp.where(oh_rank, idx[None, :, None], 0),
                    axis=1).astype(jnp.int32)            # [B, r]
    # pred ranks (node-id space), via one flat one-hot reduce
    pn = st.pred_nd.reshape(B, N * P)
    ohp = _oh(pn, pn >= 0, N)                            # [B, N*P, v]
    pred_rank_un = _selmax(ohp, rank_of[:, None, :], -1
                           ).reshape(B, N, P)
    # permute every per-node array to rank order with ONE product
    payload = jnp.concatenate([
        st.node_code[:, :, None], st.node_col[:, :, None],
        st.node_sup[:, :, None], st.pred_cnt[:, :, None],
        st.out_cnt[:, :, None], st.pred_nd, st.pred_w,
        pred_rank_un], axis=2)                           # [B, v, D]
    perm = _ohdot("bvr,bvd->brd", oh_rank, payload)      # [B, r, D]
    node_code_r = perm[:, :, 0]
    node_col_r = perm[:, :, 1]
    node_sup_r = perm[:, :, 2]
    pred_cnt_r = jnp.maximum(perm[:, :, 3], 1)
    is_end_r = perm[:, :, 4] == 0
    pred_nd_r = perm[:, :, 5:5 + P]
    pred_w_r = perm[:, :, 5 + P:5 + 2 * P]
    pred_ranks = perm[:, :, 5 + 2 * P:5 + 3 * P]
    pred_rows = jnp.where(pred_nd_r >= 0, pred_ranks + 1, 0)
    return RankArrays(order, rank_of, node_code_r, node_col_r,
                      node_sup_r, pred_nd_r, pred_ranks, pred_rows,
                      pred_cnt_r, pred_w_r, is_end_r)


def _dp(node_code_r, pred_rows, pred_cnt_r, is_end_r, n_nodes, arm,
        arm_len, mode, *, N, L, P, m, n, g):
    """Graph-vs-sequence DP, tie-exact with jax_poa._dp_one (the XLA
    twin of the Pallas kernel; per-window, vmapped by callers)."""
    jj = jnp.arange(L + 1, dtype=jnp.int32)
    parange = jnp.arange(P, dtype=jnp.int32)
    H = jnp.full((N + 1, L + 1), NEG, dtype=jnp.int32)
    H = H.at[0].set(jj * g)

    def row_step(H, r):
        code = node_code_r[r]
        prows = pred_rows[r]
        if P == 1:
            Hp = H[prows]
        else:
            pvalid = parange < pred_cnt_r[r]
            Hp = jnp.where(pvalid[:, None], H[prows], NEG)
        prof = jnp.where(arm == code, m, n)
        diag = Hp[:, :-1] + prof[None, :]
        vert = Hp[:, 1:] + g
        tmp = jnp.max(jnp.maximum(diag, vert), axis=0)
        col0 = jnp.where(mode == ROV, 0,
                         jnp.max(Hp[:, 0]) + g).astype(jnp.int32)
        val = jnp.concatenate([col0[None], tmp])
        run = jax.lax.cummax(val - jj * g)
        row = run + jj * g
        h = row[1:]
        bp_j = jnp.full(h.shape, 2 * P, dtype=jnp.int8)
        for p in range(P - 1, -1, -1):
            bp_j = jnp.where(vert[p] == h, jnp.int8(P + p), bp_j)
        for p in range(P - 1, -1, -1):
            bp_j = jnp.where(diag[p] == h, jnp.int8(p), bp_j)
        bp_0 = jnp.int8(P)
        if P > 1:
            vert0 = (Hp[:, 0] + g == col0)
            bp_0 = (P + jnp.argmax(vert0)).astype(jnp.int8)
        bp_row = jnp.concatenate([jnp.broadcast_to(bp_0, (1,)), bp_j])
        H = jax.lax.dynamic_update_slice(H, row[None, :], (r + 1, 0))
        return H, bp_row

    H, bp_rows = jax.lax.scan(row_step, H,
                              jnp.arange(N, dtype=jnp.int32))
    at_L = H[1:, arm_len]
    valid_row = jnp.arange(N) < n_nodes
    elig = jnp.where(mode == LOV, valid_row, valid_row & is_end_r)
    masked = jnp.where(elig, at_L, NEG)
    max_row = (jnp.argmax(masked) + 1).astype(jnp.int32)
    bp = jnp.concatenate([jnp.zeros((1, L + 1), jnp.int8), bp_rows], 0)
    return bp, max_row


def _traceback_matched_batch(bp, pred_rows, arm_len, mode, max_row, *,
                             active=None, N, L, P):
    """Walk backpointers for the whole batch in lockstep; returns
    matched [B, L]: the rank of the graph node arm base j aligned to,
    or -1 (insertion / unaligned head).

    The loop body does only O(B) work per step (two single-element
    gathers per window + one dynamic column write recording the
    (j, rank) emission); the [B, L] matched array is reconstructed
    afterwards with one vectorized one-hot max-reduction."""
    B = bp.shape[0]
    S = N + L + 1
    bpf = bp.reshape(B, -1)                             # [B, (N+1)(L+1)]
    prf = pred_rows.reshape(B, -1)                      # [B, N*P]

    def stop_of(i, j):
        stop_nw = (i == 0) & (j == 0)
        stop_rov = (i == 0) | (j == 0)
        return jnp.where(mode == ROV, stop_rov, stop_nw)

    def cond(s):
        _i, _j, t, stopped, _ej, _er = s
        return (~jnp.all(stopped)) & (t < S)

    def body(s):
        i, j, t, stopped, ej, er = s
        code = jnp.take_along_axis(bpf, (i * (L + 1) + j)[:, None],
                                   1)[:, 0].astype(jnp.int32)
        is_vert = (code >= P) & (code < 2 * P)
        is_horiz = code == 2 * P
        pidx = jnp.where(code < P, code, code - P)
        pred = jnp.take_along_axis(
            prf, (jnp.maximum(i - 1, 0) * P + pidx)[:, None], 1)[:, 0]
        prev_i = jnp.where(is_horiz, i, pred)
        prev_j = jnp.where(is_vert, j, j - 1)
        prev_i = jnp.where(i == 0, 0, prev_i)
        prev_j = jnp.where(i == 0, j - 1, prev_j)
        emit = (prev_j != j) & ~stopped                 # a base consumed
        diag = emit & (prev_i != i) & (i > 0)           # aligned to i-1
        rec_j = jnp.where(emit, j - 1, L)               # park at L
        rec_r = jnp.where(diag, i - 1, -1)
        ej = jax.lax.dynamic_update_slice(ej, rec_j[:, None], (0, t))
        er = jax.lax.dynamic_update_slice(er, rec_r[:, None], (0, t))
        ni = jnp.where(stopped, i, prev_i)
        nj = jnp.where(stopped, j, prev_j)
        return ni, nj, t + 1, stopped | stop_of(ni, nj), ej, er

    ej0 = jnp.full((B, S), L, jnp.int32)
    er0 = jnp.full((B, S), -1, jnp.int32)
    stopped0 = stop_of(max_row, arm_len)
    if active is not None:
        stopped0 = stopped0 | ~active
    _i, _j, _t, _s, ej, er = jax.lax.while_loop(
        cond, body, (max_row, arm_len, jnp.int32(0), stopped0,
                     ej0, er0))
    # matched[b, l] = er recorded at the step that emitted j = l (each l
    # is emitted at most once; -1 default matches the insertion value)
    hit = ej[:, :, None] == jnp.arange(L, dtype=jnp.int32)[None, None, :]
    matched = jnp.max(jnp.where(hit, er[:, :, None], -1), axis=1)
    return matched


def _merge(st: PoaState, order, node_col_r, matched, arm, arm_len, w,
           *, N, L, P):
    """Vectorized graph merge of one aligned arm (colpoa_ref.ColPoa.add;
    per window, vmapped).  ``order``/``node_col_r`` come from
    _rank_arrays_batch (computed once per arm step).  ``w`` is the
    arm's multiplicity weight: merging one arm with weight w is
    equivalent to merging w identical copies (the DP depends only on
    graph structure, never on weights, and an identical copy re-aligns
    onto its own path), which lets the runner deduplicate the many
    identical arms that high-accuracy short reads produce.  Returns
    (new state, overflowed bool)."""
    jj = jnp.arange(L, dtype=jnp.int32)
    valid_j = jj < arm_len
    is_match = (matched >= 0) & valid_j
    # resolve matched nodes through their column
    oh_m = _oh(matched, is_match, N)                    # [L, N(rank)]
    node0 = _selmax(oh_m, order[None, :], 0)
    c_match = _selmax(oh_m, node_col_r[None, :], 0)
    oh_cm = _oh(c_match, is_match, N)                   # [L, N(col)]
    m6 = _ohdot("lc,ck->lk", oh_cm, st.col_node)        # [L, NCODES]
    oh_code = _oh(arm, valid_j, NCODES)
    exist = jnp.where(
        is_match, jnp.sum(jnp.where(oh_code, m6, 0), axis=1), -1)
    creates_node = valid_j & ((~is_match) | (exist < 0))
    new_ord = jnp.cumsum(creates_node.astype(jnp.int32))
    node_j = jnp.where(creates_node, st.n_nodes - 1 + new_ord,
                       jnp.where(is_match, exist, -1))
    is_ins = valid_j & ~is_match
    newcol_ord = jnp.cumsum(is_ins.astype(jnp.int32))
    new_col_id = st.n_cols - 1 + newcol_ord
    col_j = jnp.where(is_match, c_match, new_col_id)
    n_new_nodes = new_ord[L - 1]
    n_new_cols = newcol_ord[L - 1]
    ovf = (st.n_nodes + n_new_nodes > N) | (st.n_cols + n_new_cols > N)

    # column renumbering, arithmetically (no sort): every inserted run
    # of columns is anchored after the last matched column position
    # ("lastpos", the column-key scheme in colpoa_ref); an existing
    # column at position p shifts by the number of insertions anchored
    # strictly before p, and inserted column t of the run anchored at q
    # lands at q + shift(q) + t.  Positions use the state BEFORE this
    # arm (matched column positions are unchanged during the merge).
    mpos = jnp.where(is_match, _selmax(oh_cm, st.col_pos[None, :], 0),
                     -BIG)
    lastpos = jnp.maximum(jax.lax.cummax(mpos), -1)
    lastj = jax.lax.cummax(jnp.where(is_match, jj, -1))
    hist = jnp.sum(_oh(lastpos + 1, is_ins, N + 1), axis=0,
                   dtype=jnp.int32)
    cs = jnp.cumsum(hist)            # cs[q+1] = #ins anchored at <= q
    cidx = jnp.arange(N, dtype=jnp.int32)
    oh_cp = _oh(jnp.minimum(st.col_pos, N), jnp.full((N,), True), N + 1)
    cs_at_pos = _selmax(oh_cp, cs[None, :], 0)
    col_pos_exist = jnp.where(cidx < st.n_cols,
                              st.col_pos + cs_at_pos, st.col_pos)
    oh_lp = _oh(jnp.maximum(lastpos, 0), jnp.full((L,), True), N + 1)
    anchor_shift = jnp.where(lastpos >= 0,
                             _selmax(oh_lp, cs[None, :], 0), 0)
    pos_new = lastpos + anchor_shift + (jj - lastj)
    col_pos = _set_oh(col_pos_exist, _oh(new_col_id, is_ins, N), pos_new)

    # node updates (all target indices unique; see colpoa_ref docstring)
    oh_node = _oh(node_j, creates_node, N)
    node_code = _set_oh(st.node_code, oh_node, arm)
    node_col = _set_oh(st.node_col, oh_node, col_j)
    wv = jnp.broadcast_to(w, (L,))
    node_sup = st.node_sup + _mv(_oh(node_j, valid_j, N), wv)
    # col_node[(col, code)] := node id — factored one-hots
    oh_cc = _oh(col_j, creates_node, N)                 # [L, N]
    oh_code_c = _oh(arm, creates_node, NCODES)          # [L, NCODES]
    cn_val = _ohdot("ln,lc->nc", oh_cc * node_j[:, None], oh_code_c)
    cn_cov = _ohdot("ln,lc->nc", oh_cc, oh_code_c) > 0
    col_node = jnp.where(cn_cov, cn_val, st.col_node)

    # edge upserts between consecutive emitted bases
    u = jnp.concatenate([jnp.full((1,), -1, jnp.int32), node_j[:-1]])
    v = node_j
    edge_valid = valid_j & (jj >= 1)
    oh_v = _oh(v, edge_valid, N)                        # [L, N]
    pv = _ohdot("ln,np->lp", oh_v, st.pred_nd)
    vcnt = _ohdot("ln,n->l", oh_v, st.pred_cnt)
    hit = (pv == u[:, None]) & edge_valid[:, None]
    has = jnp.any(hit, axis=1) & edge_valid
    slot = jnp.where(has, jnp.argmax(hit, axis=1), vcnt)
    ovf = ovf | jnp.any(edge_valid & ~has & (slot >= P))
    slot_c = jnp.minimum(slot, P - 1)
    oh_s_ev = _oh(slot_c, edge_valid, P)
    pred_w = st.pred_w + _ohdot("ln,lp->np", oh_v * wv[:, None], oh_s_ev)
    newslot = edge_valid & ~has
    oh_v_ns = _oh(v, newslot, N)
    oh_s_ns = _oh(slot_c, newslot, P)
    nd_val = _ohdot("ln,lp->np", oh_v_ns * u[:, None], oh_s_ns)
    nd_cov = _ohdot("ln,lp->np", oh_v_ns, oh_s_ns) > 0
    pred_nd = jnp.where(nd_cov, nd_val, st.pred_nd)
    pred_cnt = st.pred_cnt + jnp.sum(oh_v_ns, axis=0, dtype=jnp.int32)
    out_cnt = st.out_cnt + jnp.sum(_oh(u, newslot, N), axis=0,
                                   dtype=jnp.int32)

    new_st = PoaState(
        node_code=node_code, node_col=node_col, node_sup=node_sup,
        pred_nd=pred_nd, pred_w=pred_w, pred_cnt=pred_cnt,
        out_cnt=out_cnt, col_pos=col_pos, col_node=col_node,
        n_nodes=st.n_nodes + n_new_nodes, n_cols=st.n_cols + n_new_cols,
        ovf=st.ovf)
    return new_st, ovf


def _arm_step_batch(st: PoaState, arm, arm_len, mode, active, w=None, *,
                    N, L, P, m, n, g):
    """One arm round for the WHOLE window batch: rank/merge are one-hot
    vector passes, the traceback is a single batched lockstep loop, and
    the DP runs as one vmapped row scan over the batch (the reference's
    analog is its SIMD engine,
    external/spoa/src/simd_alignment_engine.cpp:46-142).

    st leaves carry a leading batch dim B; arm [B, L]; arm_len, mode,
    active [B]."""
    ra = _rank_arrays_batch(st, N)
    # windows that are done with their arms (or empty this round) are
    # masked out of the DP (n_nodes -> 0) and start the traceback
    # already stopped
    act = active & (arm_len > 0) & (st.n_nodes > 0)
    nn_eff = jnp.where(act, st.n_nodes, 0)
    bp, max_row = jax.vmap(functools.partial(
        _dp, N=N, L=L, P=P, m=m, n=n, g=g))(
            ra.node_code_r, ra.pred_rows, ra.pred_cnt_r,
            ra.is_end_r, nn_eff, arm, arm_len, mode)
    # empty graphs (the first arm round of a tile) need no traceback:
    # everything is an insertion.  The batched walk is a ~N+L-step
    # sequential loop, so skip it entirely when no window needs it
    B = st.n_nodes.shape[0]
    matched = jax.lax.cond(
        ~jnp.any(act),
        lambda: jnp.full((B, L), -1, jnp.int32),
        lambda: _traceback_matched_batch(
            bp, ra.pred_rows, arm_len, mode, max_row, active=act,
            N=N, L=L, P=P))
    # empty graph (first sequence): everything is an insertion
    matched = jnp.where((st.n_nodes == 0)[:, None], -1, matched)
    if w is None:
        w = jnp.ones_like(arm_len)
    new_st, ovf = jax.vmap(functools.partial(
        _merge, N=N, L=L, P=P))(st, ra.order, ra.node_col_r, matched,
                                arm, arm_len, w)
    apply = active & (arm_len > 0) & ~st.ovf & ~ovf

    def _sel(a, b):
        keep = apply.reshape(apply.shape + (1,) * (b.ndim - 1))
        return jnp.where(keep, b, a)

    out = jax.tree_util.tree_map(_sel, st, new_st)
    out = out._replace(
        ovf=st.ovf | (active & (arm_len > 0) & ovf))
    return out


def _consensus_wavefront(ra: RankArrays, nn, *, N, P,
                         max_branch_iters):
    """Heaviest-bundle consensus as a data-parallel WAVEFRONT
    relaxation — every node relaxes from its predecessors' current
    scores simultaneously,
    iterated to fixpoint (on a DAG the fixpoint is unique and equals
    the sequential result, reached within longest-path rounds).
    Returns (codes_bwd, sups_bwd, cons_len)."""
    B = ra.node_code_r.shape[0]
    parange = jnp.arange(P, dtype=jnp.int32)
    narange = jnp.arange(N, dtype=jnp.int32)
    rank0 = ra.rank_of[:, 0]
    valid_r = narange[None, :] < nn[:, None]
    slot_base = ((parange[None, None, :] < ra.pred_cnt_r[:, :, None])
                 & (ra.pred_ranks >= 0))
    prf = jnp.maximum(ra.pred_ranks, 0).reshape(B, N * P)
    pred_w_r, pred_ranks, is_end_r = (ra.pred_w_r, ra.pred_ranks,
                                      ra.is_end_r)

    def relax_all(scores, banned: bool):
        sc_p = jnp.take_along_axis(scores, prf, 1).reshape(B, N, P)
        slot_ok = slot_base
        if banned:
            slot_ok = slot_ok & (sc_p != -1)
        best_w = jnp.full((B, N), -1, jnp.int32)
        best_pr = jnp.full((B, N), -1, jnp.int32)
        best_sc = jnp.full((B, N), NEG, jnp.int32)
        for p in range(P):
            wp = pred_w_r[:, :, p]
            take = slot_ok[:, :, p] & (
                (best_w < wp)
                | ((best_w == wp) & (best_sc <= sc_p[:, :, p])))
            best_w = jnp.where(take, wp, best_w)
            best_pr = jnp.where(take, pred_ranks[:, :, p], best_pr)
            best_sc = jnp.where(take, sc_p[:, :, p], best_sc)
        score = jnp.where(best_pr >= 0, best_w + best_sc, -1)
        return score, best_pr

    def wavefront(scores, preds, banned: bool, upd_mask):
        def cond(s):
            _sc, _pr, changed, it = s
            return changed & (it < N + 2)

        def body(s):
            scores, preds, _c, it = s
            ns, npr = relax_all(scores, banned)
            ns = jnp.where(upd_mask, ns, scores)
            npr = jnp.where(upd_mask, npr, preds)
            changed = (jnp.any(ns != scores) | jnp.any(npr != preds))
            return ns, npr, changed, it + 1

        scores, preds, _c, _it = jax.lax.while_loop(
            cond, body, (scores, preds, jnp.bool_(True), jnp.int32(0)))
        return scores, preds

    scores = jnp.full((B, N), -1, jnp.int32)
    preds = jnp.full((B, N), -1, jnp.int32)
    scores, preds = wavefront(scores, preds, banned=False,
                              upd_mask=valid_r)
    masked = jnp.where(valid_r, scores, NEG)
    max_r = jnp.argmax(masked, axis=1).astype(jnp.int32)

    def bc_active(max_r):
        ie = jnp.take_along_axis(is_end_r,
                                 jnp.maximum(max_r, 0)[:, None], 1)[:, 0]
        return (nn > 0) & ~ie

    def bc_cond(s):
        _sc, _pr, max_r, it = s
        return jnp.any(bc_active(max_r)) & (it < max_branch_iters)

    def bc_body(s):
        scores, preds, max_r, it = s
        act = bc_active(max_r)
        succ = jnp.any((pred_ranks == max_r[:, None, None]) & slot_base,
                       axis=2)
        ban_mask = (succ[:, :, None] & slot_base
                    & (pred_ranks != max_r[:, None, None]))
        banned = jnp.zeros((B, N), bool)
        for p in range(P):
            tgt = jnp.where(ban_mask[:, :, p], pred_ranks[:, :, p], -1)
            banned = banned | jnp.any(
                tgt[:, :, None] == narange[None, None, :], axis=1)
        scores = jnp.where(banned & act[:, None], -1, scores)
        in_suffix = (narange[None, :] > max_r[:, None]) & valid_r
        upd = in_suffix & act[:, None]
        scores = jnp.where(upd, -1, scores)
        preds = jnp.where(upd, -1, preds)
        scores, preds = wavefront(scores, preds, banned=True,
                                  upd_mask=upd)
        masked = jnp.where(upd, scores, NEG)
        gm = jnp.max(masked, axis=1)
        cand = jnp.where(gm > 0,
                         jnp.argmax(masked, axis=1).astype(jnp.int32),
                         rank0)
        max_r = jnp.where(act, cand, max_r)
        return scores, preds, max_r, it + 1

    scores, preds, max_r, _it = jax.lax.while_loop(
        bc_cond, bc_body, (scores, preds, max_r, jnp.int32(0)))

    def bt_cond(s):
        r, t, _c, _u, _ln = s
        return jnp.any(r >= 0) & (t < N)

    def bt_body(s):
        r, t, codes, sups, ln = s
        rr = jnp.maximum(r, 0)[:, None]
        c_t = jnp.take_along_axis(ra.node_code_r, rr, 1)
        s_t = jnp.take_along_axis(ra.node_sup_r, rr, 1)
        codes = jax.lax.dynamic_update_slice(codes, c_t, (0, t))
        sups = jax.lax.dynamic_update_slice(sups, s_t, (0, t))
        ln = ln + (r >= 0)
        nr = jnp.take_along_axis(preds, rr, 1)[:, 0]
        return jnp.where(r >= 0, nr, r), t + 1, codes, sups, ln

    start_r = jnp.where(nn > 0, max_r, -1)
    _r, _t, codes_bwd, sups_bwd, cons_len = jax.lax.while_loop(
        bt_cond, bt_body,
        (start_r, jnp.int32(0), jnp.zeros((B, N), jnp.int32),
         jnp.zeros((B, N), jnp.int32), jnp.zeros((B,), jnp.int32)))
    return codes_bwd, sups_bwd, cons_len


def _consensus_batch(st: PoaState, *, N, P, max_branch_iters=None):
    """Heaviest-bundle consensus with spoa's tie rule and branch
    completion (graph.cpp:610-705), in rank space, for the whole
    batch."""
    if max_branch_iters is None:
        max_branch_iters = N
    ra = _rank_arrays_batch(st, N)
    nn = st.n_nodes
    codes_bwd, sups_bwd, cons_len = _consensus_wavefront(
        ra, nn, N=N, P=P, max_branch_iters=max_branch_iters)
    narange = jnp.arange(N, dtype=jnp.int32)
    ridx = jnp.maximum(cons_len[:, None] - 1 - narange[None, :], 0)
    cons_codes = jnp.take_along_axis(codes_bwd, ridx, 1)
    cons_sup = jnp.take_along_axis(sups_bwd, ridx, 1)
    return cons_codes, cons_sup, cons_len


@functools.partial(jax.jit,
                   static_argnames=("N", "L", "K", "P", "m", "n", "g"))
def _poa_full_batch_impl(arms, arm_len, arm_mode, n_arms, arm_w, *, N, L,
                         K, P, m, n, g):
    B = arms.shape[0]
    st = _bcast_state(N, P, B)

    def step(st, inp):
        arm, alen, mode, w, k = inp       # [B, L], [B], [B], [B], scalar
        st = _arm_step_batch(st, arm, alen, mode, k < n_arms, w,
                             N=N, L=L, P=P, m=m, n=n, g=g)
        return st, None

    st, _ = jax.lax.scan(
        step, st,
        (arms.transpose(1, 0, 2), arm_len.T, arm_mode.T, arm_w.T,
         jnp.arange(K, dtype=jnp.int32)))
    cons_codes, cons_sup, cons_len = _consensus_batch(st, N=N, P=P)
    return cons_codes, cons_sup, cons_len, st.ovf


def poa_full_batch(arms, arm_len, arm_mode, n_arms, *, N: int, L: int,
                   K: int, P: int, m: int, n: int, g: int, arm_w=None):
    """Full POA for a batch of windows in one device program.

    arms [B, K, L] i32 global codes; arm_len [B, K] i32;
    arm_mode [B, K] i32 (NW/LOV/ROV); n_arms [B] i32; arm_w [B, K] i32
    multiplicity weights (default 1, see _merge).
    Returns (cons_codes [B, N], cons_sup [B, N], cons_len [B],
    ovf [B] bool).
    """
    if arm_w is None:
        arm_w = np.ones(np.shape(arm_len), np.int32)
    return _poa_full_batch_impl(
        arms, arm_len, arm_mode, n_arms, arm_w, N=N, L=L, K=K, P=P,
        m=m, n=n, g=g)


# -- tile program (the production runner's path) ------------------------------
#
# ONE compiled program per window shape class computes the ENTIRE
# consensus of a B-window tile: the arm dimension is a while-loop on
# device bounded by the tile's real max arm count (tiles are sorted by
# arm count, so most iterate 2-3 times), consensus + curation + packing
# run in the same program, and the only transfers are one arm-pool
# upload and one packed-consensus readback per tile.  Arms live in a
# GLOBAL deduplicated pool (identical arms recur across windows, not
# just within one) addressed by a per-window index table.


def _bcast_state(N: int, P: int, B: int) -> PoaState:
    st0 = init_state(N, P)
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B,) + jnp.shape(x)), st0)


def _finish_packed(st: PoaState, th, *, N, P):
    """Consensus + on-device curation + nibble packing.  th [B] i32 is
    the per-window curate threshold (0 keeps every base, the
    short-window case); filtering on device means the support array
    never crosses to the host.  Output int8
    [B, N//2 + 4]: nibble-packed codes | len lo | len hi | ovf | 0."""
    cc, cs, cl = _consensus_batch(st, N=N, P=P)
    idx = jnp.arange(N, dtype=jnp.int32)[None, :]
    keep = (idx < cl[:, None]) & (cs >= th[:, None])
    dst = jnp.cumsum(keep.astype(jnp.int32), axis=1) - 1
    clen = dst[:, -1] + 1
    sel = jnp.where(keep, dst, N)  # parked slot N dropped below
    onehot = sel[:, :, None] == idx[0][None, None, :]
    curated = jnp.max(
        jnp.where(onehot, cc[:, :, None], 0), axis=1
    ).astype(jnp.int8)                                    # [B, N]
    lo = curated[:, 0::2]
    hi = curated[:, 1::2]
    packed = (lo | (hi << 4)).astype(jnp.int8)            # [B, N//2]
    meta = jnp.stack([
        (clen & 0xFF).astype(jnp.int8),
        ((clen >> 8) & 0xFF).astype(jnp.int8),
        st.ovf.astype(jnp.int8),
        jnp.zeros_like(clen, jnp.int8)], axis=1)
    return jnp.concatenate([packed, meta], axis=1)


@functools.lru_cache(maxsize=None)
def build_tile_program(*, N: int, L: int, K: int, P: int, m: int,
                       n: int, g: int, B: int, A: int, ndev: int):
    """Returns one jitted callable
    ``tile(pool i8 [A, L], plen i32 [A], idx i32 [B, K], amode i8
    [B, K], aw i32 [B, K], narms i32 [B], th i32 [B]) -> i8
    [B, N//2 + 4]`` (see _finish_packed for the output layout).

    The batch dim is sharded over the first `ndev` local devices with
    shard_map (every op inside is per-window, no collectives); the arm
    pool is replicated.  B must divide by ndev."""
    from jax.sharding import Mesh, PartitionSpec
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    def tile_local(pool, plen, idx, amode, aw, narms, th):
        Bl = idx.shape[0]
        st = _bcast_state(N, P, Bl)
        kmax = jnp.max(narms)

        def body(k, st):
            rows = jax.lax.dynamic_slice_in_dim(idx, k, 1, 1)[:, 0]
            active = (k < narms) & (rows >= 0)
            rr = jnp.maximum(rows, 0)
            arm = pool[rr].astype(jnp.int32)              # [Bl, L]
            al = jnp.where(active, plen[rr], 0)
            md = jax.lax.dynamic_slice_in_dim(amode, k, 1, 1)[:, 0]
            w = jax.lax.dynamic_slice_in_dim(aw, k, 1, 1)[:, 0]
            return _arm_step_batch(
                st, arm, al, md.astype(jnp.int32), active, w,
                N=N, L=L, P=P, m=m, n=n, g=g)

        st = jax.lax.fori_loop(0, kmax, body, st)
        return _finish_packed(st, th, N=N, P=P)

    if ndev <= 1:
        return jax.jit(tile_local)
    devs = jax.local_devices()[:ndev]
    mesh = Mesh(np.array(devs), ("b",))
    rep = PartitionSpec()
    pb = PartitionSpec("b")
    return jax.jit(shard_map(
        tile_local, mesh=mesh,
        in_specs=(rep, rep, pb, pb, pb, pb, pb),
        out_specs=pb, check_vma=False))


@jax.jit
def concat_tiles(*tiles):
    """Concatenate tile outputs on the device, so that many tiles come
    back to the host in one transfer."""
    return jnp.concatenate(tiles, axis=0)

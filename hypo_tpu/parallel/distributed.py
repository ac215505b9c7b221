"""Multi-process distribution for the polishing pipeline.

The reference is a single OpenMP process (SURVEY §2.3); its only scaling
knob beyond threads is contig batching.  The layout over several
processes (one per card on one machine, or one per host):

- **Contigs shard across hosts** (size-balanced greedy assignment, no
  in-program communication): each host streams its own slice of the
  BAM (the draft-contig-sorted order lets every host skip to its shard)
  and polishes its contigs end-to-end.
- **Solid k-mers are global state**: every host must see counts from
  ALL reads.  Read files are sharded across hosts; local histograms are
  merged with one ``psum`` over the global device mesh (the pipeline's
  single cross-host reduction, SURVEY §5).
- **Output gathers at rank 0**: hosts write per-shard FASTA; rank 0
  concatenates in draft order (host filesystem gather — polished
  contigs are not device state).

On a single process everything degrades to the local path, which keeps
this module testable on one machine.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> Tuple[int, int]:
    """jax.distributed glue.  Returns (process_id, num_processes).
    No-op single-process fallback when no coordinator is configured."""
    if coordinator_address:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    return jax.process_index(), jax.process_count()


def visible_card_count() -> int:
    """CUDA devices this process can see, counted through the CUDA
    driver rather than JAX, whose backend must not start before
    ``pin_process_to_card``.  0 where there is no driver or no card."""
    import ctypes
    try:
        cuda = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return 0
    n = ctypes.c_int(0)
    if cuda.cuInit(0) != 0 or cuda.cuDeviceGetCount(ctypes.byref(n)) != 0:
        return 0
    return n.value


def pin_process_to_card(process_id: int,
                        n_cards: Optional[int] = None) -> Optional[int]:
    """Restrict this process to card ``process_id % n_cards`` of the
    visible ones, so that ``--nproc`` processes on one machine take one
    card each (a JAX process reserves most of every card it opens).
    Must run before JAX initialises its backend.  Returns the card
    index, or None where no card is visible."""
    if n_cards is None:
        n_cards = visible_card_count()
    if n_cards == 0:
        return None
    card = process_id % n_cards
    jax.config.update("jax_cuda_visible_devices", str(card))
    return card


def shard_contigs_contiguous(lengths: Sequence[int], num_shards: int
                             ) -> List[Tuple[int, int]]:
    """Split contigs into ``num_shards`` contiguous [lo, hi) ranges with
    roughly balanced total length.  Contiguity lets every host stream
    exactly its slice of the draft-contig-sorted BAM (skip to lo, stop
    at hi) with no index.  Deterministic across hosts."""
    total = sum(int(x) for x in lengths)
    n = len(lengths)
    bounds = [0]
    acc = 0
    for s in range(1, num_shards):
        target = total * s / num_shards
        lo = bounds[-1]
        cut = lo
        while cut < n and (acc + lengths[cut] / 2.0) < target:
            acc += int(lengths[cut])
            cut += 1
        # never produce an empty middle shard while contigs remain
        cut = min(max(cut, lo), n)
        bounds.append(cut)
    bounds.append(n)
    return [(bounds[i], bounds[i + 1]) for i in range(num_shards)]


def shard_files(paths: Sequence[str], process_id: int,
                num_processes: int) -> List[str]:
    """Round-robin read-file assignment for distributed k-mer counting."""
    return [p for i, p in enumerate(paths)
            if i % num_processes == process_id]


def psum_across_hosts(arr: np.ndarray) -> np.ndarray:
    """Sum an identically-shaped per-host array across all hosts with
    one psum over the global device mesh.

    Each host contributes its array once (replicating it across local
    devices would overcount, so it rides on local device 0 with zeros
    elsewhere); the result is identical on every host."""
    n_local = jax.local_device_count()
    h = np.asarray(arr)
    stacked = np.zeros((n_local,) + h.shape, h.dtype)
    stacked[0] = h
    merged = jax.pmap(lambda x: jax.lax.psum(x, "d"), axis_name="d")(
        jnp.asarray(stacked))
    return np.asarray(merged[0])


# back-compat name: the histogram merge is the same reduction
merge_histograms_psum = psum_across_hosts


def merge_dense_counts_psum(table: np.ndarray) -> np.ndarray:
    """Global per-kmer count merge for DENSE tables (4^k fits memory):
    one psum of the full table over the device mesh — the distributed
    replacement for the reference's single KMC database over all read
    files (external/suk/src/SolidKmers.cpp:104-190)."""
    return psum_across_hosts(np.asarray(table, np.int32)).astype(
        np.uint32)


def merge_kmer_counts_files(codes: np.ndarray, counts: np.ndarray,
                            aux_dir: str, process_id: int,
                            num_processes: int,
                            timeout_s: float = 3600.0):
    """Filesystem-based global per-kmer count merge (sparse tables,
    any k): every rank writes its local shard's (codes, counts) to
    ``aux_dir/kmer_counts.shard{pid}.npz`` plus a ``.done`` marker,
    waits for all shards, and computes the identical merged table.
    This matches the CLI's coordinator-less multi-process mode (shared
    filesystem, like the output gather); pod slices with a jax
    coordinator can use merge_dense_counts_psum instead."""
    import time
    os.makedirs(aux_dir, exist_ok=True)
    shard = os.path.join(aux_dir, f"kmer_counts.shard{process_id}.npz")
    tmp = shard + f".tmp{process_id}.npz"
    np.savez(tmp, codes=codes, counts=counts.astype(np.uint64))
    os.replace(tmp, shard)
    open(shard + ".done", "w").close()
    parts_c, parts_n = [], []
    deadline = time.time() + timeout_s
    for p in range(num_processes):
        sp = os.path.join(aux_dir, f"kmer_counts.shard{p}.npz")
        while not os.path.exists(sp + ".done"):
            if time.time() > deadline:
                raise TimeoutError(f"kmer count shard never arrived: {sp}")
            time.sleep(0.2)
        with np.load(sp) as z:
            parts_c.append(z["codes"])
            parts_n.append(z["counts"])
    allc = np.concatenate(parts_c)
    alln = np.concatenate(parts_n)
    if len(allc) == 0:
        return allc, alln
    order = np.argsort(allc, kind="stable")
    allc = allc[order]
    alln = alln[order]
    uniq, start = np.unique(allc, return_index=True)
    sums = np.add.reduceat(alln, start)
    return uniq, sums


def gather_polished_fasta(out_path: str, num_processes: int,
                          process_id: int,
                          draft_order: Sequence[str],
                          timeout_s: float = 3600.0) -> None:
    """Rank-0 filesystem gather: every host writes
    ``{out_path}.shard{pid}`` followed by an empty ``.done`` marker;
    rank 0 waits for all shards and concatenates records back into
    draft order (``draft_order`` = contig names in draft-FASTA order,
    known identically on every host)."""
    import time

    from ..io.fasta import read_fastx, write_fasta
    if process_id != 0:
        return
    shard_paths = [f"{out_path}.shard{p}" for p in range(num_processes)]
    deadline = time.time() + timeout_s
    for p in shard_paths:
        while not os.path.exists(p + ".done"):
            if time.time() > deadline:
                raise TimeoutError(f"shard never arrived: {p}")
            time.sleep(1)
    by_name = {}
    for p in shard_paths:
        for name, seq in read_fastx(p):
            by_name[name.split()[0]] = seq
    missing = [n for n in draft_order if n.split()[0] not in by_name]
    if missing:
        raise RuntimeError(f"gather missing contigs: {missing[:5]}")
    write_fasta(out_path,
                ((n, by_name[n.split()[0]]) for n in draft_order))

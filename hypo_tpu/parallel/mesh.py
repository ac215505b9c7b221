"""Multi-device mesh helpers for the polishing pipeline.

The reference is single-node OpenMP (SURVEY §2.3); the multi-device
scaling design is:

- windows are embarrassingly parallel after arm fill -> the production
  tile program (hypo_tpu.poa.device_full.build_tile_program) shard_maps
  its window batch over the local mesh;
- global k-mer count tables are merged with one psum over the mesh
  (hypo_tpu.parallel.distributed.merge_dense_counts_psum — the one true
  cross-device reduction in the pipeline);
- contigs shard across hosts at the process level (each host streams
  its own BAM slice; distributed.shard_contigs_contiguous), which needs
  no in-program communication.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(n_devices: Optional[int] = None, axis: str = "win") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return jax.make_mesh((n,), (axis,), devices=devs[:n])


def make_example_inputs(B: int, N: int, L: int, Pcap: int, R: int,
                        rng_seed: int = 0):
    """Random-but-valid POA DP inputs (bench/tests): each window's graph
    is a simple chain of N nodes (a fresh backbone), arms are random."""
    rng = np.random.default_rng(rng_seed)
    node_code = rng.integers(0, 4, size=(B, N)).astype(np.int32)
    pred_rows = np.zeros((B, N, Pcap), dtype=np.int32)
    pred_rows[:, :, 0] = np.arange(N)[None, :]  # chain: row r preds row r
    pred_cnt = np.ones((B, N), dtype=np.int32)
    is_end = np.zeros((B, N), dtype=bool)
    is_end[:, -1] = True
    n_nodes = np.full(B, N, dtype=np.int32)
    arm = rng.integers(0, 4, size=(B, L)).astype(np.int32)
    arm_len = np.full(B, L, dtype=np.int32)
    mode = np.zeros(B, dtype=np.int32)
    reads = rng.integers(0, 4, size=(B, R)).astype(np.int32)
    return (node_code, pred_rows, pred_cnt, is_end, n_nodes, arm, arm_len,
            mode, reads)

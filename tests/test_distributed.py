"""Multi-host distribution glue (hypo_tpu/parallel/distributed.py).

The reference has no distributed layer (SURVEY §2.3); these validate
this one: deterministic contiguous contig sharding, the global
k-mer count merges (filesystem and psum on the virtual 8-device mesh),
and the rank-0 FASTA gather."""
import os

import numpy as np

from hypo_tpu.io.fasta import read_fastx, write_fasta
from hypo_tpu.parallel import distributed as dist


def test_shard_contigs_contiguous_covers_and_balances():
    lengths = [100, 5000, 40, 40, 3000, 900, 10]
    ranges = dist.shard_contigs_contiguous(lengths, 3)
    assert ranges[0][0] == 0 and ranges[-1][1] == len(lengths)
    for (a, b), (c, _d) in zip(ranges, ranges[1:]):
        assert b == c and a <= b
    assert ranges == dist.shard_contigs_contiguous(lengths, 3)


def test_shard_files_round_robin():
    paths = [f"r{i}.fq" for i in range(5)]
    got = [dist.shard_files(paths, p, 2) for p in range(2)]
    assert got[0] == ["r0.fq", "r2.fq", "r4.fq"]
    assert got[1] == ["r1.fq", "r3.fq"]
    assert sorted(got[0] + got[1]) == sorted(paths)


def test_psum_across_hosts_identity_single_process():
    h = np.arange(17, dtype=np.int32)
    merged = dist.psum_across_hosts(h)
    np.testing.assert_array_equal(merged, h)


def _merge_all_ranks(parts, aux, timeout_s=60):
    """Run merge_kmer_counts_files for every rank concurrently (each
    rank blocks until all shards exist, like real processes would)."""
    import threading
    results = [None] * len(parts)

    def run(pid):
        c, n = parts[pid]
        results[pid] = dist.merge_kmer_counts_files(
            c, n, aux, pid, len(parts), timeout_s=timeout_s)

    ts = [threading.Thread(target=run, args=(p,))
          for p in range(len(parts))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return results


def test_merge_kmer_counts_files_two_ranks(tmp_path):
    """Simulate two ranks sharing aux_dir; merged table = global sums."""
    c0 = np.array([3, 7, 9], np.int64)
    n0 = np.array([1, 4, 2], np.uint64)
    c1 = np.array([1, 7, 9, 12], np.int64)
    n1 = np.array([5, 1, 1, 9], np.uint64)
    results = _merge_all_ranks([(c0, n0), (c1, n1)], str(tmp_path))
    for codes, counts in results:
        np.testing.assert_array_equal(codes, [1, 3, 7, 9, 12])
        np.testing.assert_array_equal(counts, [5, 1, 5, 3, 9])


def test_distributed_solid_kmers_match_single_rank(tmp_path):
    """nproc=2 (reads strided across ranks, counts merged) must produce
    the same solid-kmer bitmask as nproc=1 — the reference's semantics
    are one global KMC database (suk/src/SolidKmers.cpp:104-190)."""
    from hypo_tpu.kmers.counting import count_files
    from hypo_tpu.kmers.solid import SolidKmers
    rng = np.random.default_rng(0)
    genome = "".join("ACGT"[b] for b in rng.integers(0, 4, 4000))
    reads = []
    for _ in range(600):
        s = int(rng.integers(0, len(genome) - 80))
        reads.append(genome[s:s + 80])
    fq = str(tmp_path / "reads.fa")
    write_fasta(fq, ((f"r{i}", s) for i, s in enumerate(reads)))
    k, cov = 7, 10
    cap = 4 * cov + 1
    # single rank
    sk1 = SolidKmers(k).initialise([fq], cov)
    # two ranks, strided reads, filesystem merge
    parts = []
    for pid in range(2):
        counter = count_files([fq], k, cap=cap, stride=2, offset=pid)
        parts.append(counter.items())
    results = _merge_all_ranks(parts, str(tmp_path / "auxA"))
    sks = [SolidKmers(k).initialise_from_counts(mc, mn, cov)
           for mc, mn in results]
    for sk2 in sks:
        np.testing.assert_array_equal(sk2.bitset.words, sk1.bitset.words)
        assert sk2.get_num_solid_kmers() == sk1.get_num_solid_kmers()
    # dense psum merge path gives the same table
    from hypo_tpu.kmers.counting import KmerCounter
    tables = []
    for pid in range(2):
        c = count_files([fq], k, cap=cap, stride=2, offset=pid)
        tables.append(c._table.copy())
    merged = dist.merge_dense_counts_psum(tables[0])  # 1-host identity
    np.testing.assert_array_equal(merged, tables[0])
    # two-rank dense merge == elementwise sum == single-rank table
    summed = np.minimum(tables[0] + tables[1], cap)
    single = count_files([fq], k, cap=cap)._table
    np.testing.assert_array_equal(np.minimum(summed, cap),
                                  np.minimum(single, cap))


_TWO_PROC_SCRIPT = r"""
import os, sys
import numpy as np
pid = int(sys.argv[1]); nproc = int(sys.argv[2])
port = sys.argv[3]; out = sys.argv[4]
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid)
assert jax.process_count() == nproc
assert jax.device_count() == nproc * jax.local_device_count()
sys.path.insert(0, os.path.dirname(out))
from hypo_tpu.parallel import distributed as dist
# each rank holds a different table; psum must produce the global sum
# identically on every rank
local = np.arange(64, dtype=np.int32) * (pid + 1)
merged = dist.psum_across_hosts(local)
expect = np.arange(64, dtype=np.int32) * sum(
    p + 1 for p in range(nproc))
np.testing.assert_array_equal(merged, expect)
np.save(f"{out}.rank{pid}.npy", merged)
"""


def test_psum_two_process_jax_distributed(tmp_path):
    """REAL multi-process jax.distributed: two CPU processes + a
    localhost coordinator; the dense-count psum merge must produce the
    identical global sum on both ranks (SURVEY §5's single cross-host
    reduction).  Uses process env isolated from the test's own jax."""
    import socket
    import subprocess
    import sys
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    script = tmp_path / "rank.py"
    script.write_text(_TWO_PROC_SCRIPT)
    out = str(tmp_path / "psum")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = repo
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(p), "2", str(port), out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for p in range(2)]
    outs = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, se.decode()[-800:]))
    for rc, err in outs:
        assert rc == 0, f"rank failed: {err}"
    r0 = np.load(out + ".rank0.npy")
    r1 = np.load(out + ".rank1.npy")
    np.testing.assert_array_equal(r0, r1)
    np.testing.assert_array_equal(
        r0, np.arange(64, dtype=np.int32) * 3)


def test_gather_polished_fasta(tmp_path):
    out = str(tmp_path / "polished.fa")
    draft_order = ["c0", "c1", "c2", "c3"]
    seqs = {n: "ACGT" * (i + 1) for i, n in enumerate(draft_order)}
    shards = [["c1", "c3"], ["c0", "c2"]]  # interleaved across 2 hosts
    for pid, names in enumerate(shards):
        sp = f"{out}.shard{pid}"
        write_fasta(sp, ((n, seqs[n]) for n in names))
        open(sp + ".done", "w").close()
    dist.gather_polished_fasta(out, 2, 1, draft_order)  # non-root no-op
    assert not os.path.exists(out)
    dist.gather_polished_fasta(out, 2, 0, draft_order)
    got = list(read_fastx(out))
    assert [n for n, _ in got] == draft_order
    assert all(s == seqs[n] for n, s in got)


def test_gather_missing_contig_raises(tmp_path):
    out = str(tmp_path / "p.fa")
    write_fasta(out + ".shard0", [("c0", "ACGT")])
    open(out + ".shard0.done", "w").close()
    import pytest
    with pytest.raises(RuntimeError):
        dist.gather_polished_fasta(out, 1, 0, ["c0", "cMISSING"])

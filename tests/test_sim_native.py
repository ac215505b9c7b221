"""Native simulator composer (hypo_sim_reads) == the python path,
byte-for-byte on decompressed BAM/FASTQ."""
import gzip
import hashlib
import os

import pytest

from hypo_tpu.native import host_api
from hypo_tpu.sim import SimConfig, simulate

@pytest.fixture(autouse=True)
def _native_built():
    """Builds (on first use) and loads the native libraries; decided
    here rather than at import, where xdist workers would all compile
    while collecting."""
    if not (host_api.available()):
        pytest.skip("native host lib unavailable")


def _md5(path: str, gz: bool) -> str:
    data = gzip.open(path, "rb").read() if gz else open(path, "rb").read()
    return hashlib.md5(data).hexdigest()


def test_sim_native_parity(tmp_path, monkeypatch):
    cfg = dict(genome_size=120_000, num_contigs=2, seed=5, short_cov=15,
               long_cov=6)
    monkeypatch.setenv("HYPO_SIM_PYTHON", "1")
    simulate(SimConfig(**cfg), str(tmp_path / "py"))
    monkeypatch.delenv("HYPO_SIM_PYTHON")
    simulate(SimConfig(**cfg), str(tmp_path / "nat"))
    for f, gz in (("sr.bam", True), ("lr.bam", True),
                  ("reads.fq.gz", True)):
        assert _md5(str(tmp_path / "py" / f), gz) == \
            _md5(str(tmp_path / "nat" / f), gz), f

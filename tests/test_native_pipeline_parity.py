"""End-to-end parity: full pipeline with the native C++ runtime vs the
pure-Python path must produce byte-identical FASTA (hybrid mode)."""
import os
import subprocess
import sys

import pytest

from hypo_tpu.native import bam_api, host_api

@pytest.fixture(autouse=True)
def _native_built():
    """Builds (on first use) and loads the native libraries; decided
    here rather than at import, where xdist workers would all compile
    while collecting."""
    if not (host_api.available() and bam_api.available()):
        pytest.skip("native libs unavailable")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, out, extra_env):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra_env)
    subprocess.run(
        [sys.executable, "-m", "hypo_tpu.cli", "-r", "reads.fq.gz",
         "-d", "draft.fa", "-b", "sr.bam", "-B", "lr.bam", "-c", "30",
         "-s", "40k", "-o", out, "-t", "4"],
        cwd=cwd, env=env, check=True, capture_output=True, timeout=300)


def test_native_vs_python_pipeline(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    subprocess.run(
        [sys.executable, "-m", "hypo_tpu.sim", "--out", str(tmp_path),
         "--genome-size", "40000", "--short-cov", "25",
         "--long-cov", "15", "--seed", "7"],
        env=env, check=True, capture_output=True, timeout=300)
    _run(tmp_path, "native.fa", {})
    _run(tmp_path, "python.fa", {"HYPO_TPU_NO_NATIVE": "1"})
    a = (tmp_path / "native.fa").read_bytes()
    b = (tmp_path / "python.fa").read_bytes()
    assert a == b

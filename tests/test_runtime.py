"""How the program meets its device: compile-cache placement, engine
choice, one card per --nproc process, tile sizes per backend, compile
failures, and the native libraries' first-use build."""
import ctypes
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import pytest

import jax

from hypo_tpu.config import InputFlags, ScoreParams
from hypo_tpu.native.build import build_library
from hypo_tpu.parallel import distributed as dist
from hypo_tpu.pipeline.polish import Polisher
from hypo_tpu.poa.full_runner import CLASSES, FullDeviceRunner
from hypo_tpu.utils import jax_cache


@pytest.fixture
def cache_dir_restored():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_follows_env(monkeypatch, tmp_path,
                                   cache_dir_restored):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert jax_cache.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch,
                                            cache_dir_restored):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = jax_cache.enable_compilation_cache()
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(checkout, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


@pytest.mark.parametrize("backend,device", [("gpu", True), ("cpu", False)])
def test_auto_engine_choice(monkeypatch, backend, device):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    p = Polisher(InputFlags())
    assert p.flags.use_device_poa is None
    p._resolve_device_poa()
    assert p.flags.use_device_poa is device


@pytest.mark.parametrize("procid,n_cards,card", [
    (0, 4, 0), (1, 4, 1), (3, 4, 3), (5, 4, 1), (2, 1, 0), (0, 0, None)])
def test_nproc_card_mapping(procid, n_cards, card):
    old = jax.config.values["jax_cuda_visible_devices"]
    try:
        assert dist.pin_process_to_card(procid, n_cards) == card
        want = "all" if card is None else str(card)
        assert jax.config.values["jax_cuda_visible_devices"] == want
    finally:
        jax.config.update("jax_cuda_visible_devices", old)


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_class_shape_shrinks_only_on_cpu(monkeypatch, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    runner = FullDeviceRunner(ScoreParams())
    for ci, (L, N, K, B, A) in enumerate(CLASSES):
        shape = runner._class_shape(ci)
        assert shape[:3] == (L, N, K)     # routing caps never change
        if backend == "gpu":
            assert shape == (L, N, K, B, A)
        else:
            b = max(8 * runner.ndev, 64)
            assert shape[3:] == (b, 2 * b * K)


def test_warm_reraises_compile_failure(monkeypatch):
    runner = FullDeviceRunner(ScoreParams())

    def broken(ci, scores):
        raise RuntimeError("compile failed")

    monkeypatch.setattr(runner, "_program", broken)
    with pytest.raises(RuntimeError, match="compile failed"):
        runner.warm(wait=True)
    runner.warm()
    with pytest.raises(RuntimeError, match="compile failed"):
        runner._await_warm()


def test_concurrent_native_builds_leave_one_library(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(2, mp_context=ctx) as ex:
        futs = [ex.submit(build_library, "bam_native.cpp", "libhypo_bam",
                          ("-lz",), str(tmp_path)) for _ in range(2)]
        paths = [f.result(timeout=300) for f in futs]
    assert paths[0] is not None and paths[0] == paths[1]
    libs = [n for n in os.listdir(tmp_path) if not n.startswith(".")]
    assert libs == [os.path.basename(paths[0])]
    ctypes.CDLL(paths[0]).hypo_bam_open

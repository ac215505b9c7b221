"""Builds the native libraries from the C++ sources beside them, on
first use.

A library's file name carries a hash of its source, its compile command
and the host CPU (``libhypo_poa.<hash>.so``): an edited source, or a
tree copied from a machine with another CPU (the build uses
-march=native), never loads a stale library.  Processes that start at
once (pytest-xdist workers, ``--nproc`` ranks) take an fcntl lock; each
build writes a file of its own and moves it into place with os.replace.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
from typing import Optional, Sequence

SRC_DIR = os.path.dirname(os.path.abspath(__file__))


def _cpu_signature() -> bytes:
    """The model name and feature flags of the first CPU."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            lines = fh.read().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines
            if ln.startswith((b"model name", b"flags"))]
    return b"\n".join(keep[:2])


def build_library(src_name: str, stem: str, libs: Sequence[str] = (),
                  out_dir: str = SRC_DIR) -> Optional[str]:
    """Path of ``stem`` built from ``SRC_DIR/src_name`` into out_dir,
    compiling it if needed.  None where the compiler is missing or the
    build fails (callers fall back to the Python implementations)."""
    src = os.path.join(SRC_DIR, src_name)
    flags = ["-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp",
             "-march=native"]
    h = hashlib.sha256()
    with open(src, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(flags + list(libs)).encode())
    h.update(_cpu_signature())
    lib = os.path.join(out_dir, f"{stem}.{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f".{stem}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(lib):      # built while we waited
            return lib
        tmp = f"{lib}.{os.getpid()}.tmp"
        try:
            subprocess.run(["g++", *flags, src, "-o", tmp, *libs],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, lib)
        except (OSError, subprocess.SubprocessError):
            return None
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        for name in os.listdir(out_dir):   # builds of older sources
            if (name.startswith(stem + ".") and name.endswith(".so")
                    and name != os.path.basename(lib)):
                os.remove(os.path.join(out_dir, name))
    return lib

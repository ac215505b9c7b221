"""hypo_tpu — a hybrid genome-assembly polisher whose window consensus
runs on a GPU through JAX.

A from-scratch reimplementation of the capabilities of kensung-lab/hypo:

- sequence data lives in flat uint8/uint32 numpy arrays on the host and
  fixed-shape batched tensors on the device;
- solid k-mer discovery (the reference's SUK + KMC subprocess,
  reference external/suk/src/SolidKmers.cpp) is a vectorized k-mer
  hashing + histogram pipeline (``hypo_tpu.kmers``);
- strong/weak-region segmentation (reference src/Contig.cpp) is a set of
  vectorized segment scans over position arrays (``hypo_tpu.segment``);
- window consensus (reference src/Window.cpp + adapted spoa) is a
  partial-order-alignment engine with an exact NumPy oracle
  (``hypo_tpu.poa``) and a batched JAX tile program for the device
  hot loop;
- the pipeline (reference src/Hypo.cpp) orchestrates batches of contigs
  and shards windows across a ``jax.sharding.Mesh`` (``hypo_tpu.parallel``).
"""

__version__ = "0.1.0"


def _tune_malloc() -> None:
    """Keep freed large buffers in the malloc arena instead of
    munmap-ing them.  The pipeline's stages repeatedly allocate/free
    comparable 0.1-3 GB numpy arrays; with glibc's default dynamic mmap
    threshold every round trip re-faults fresh pages, which on
    virtualized memory can run at only ~20-30 MB/s (measured: an 800 MB
    first-touch fill 25-46 s cold vs 0.15 s from the reused arena).
    M_MMAP_THRESHOLD / M_TRIM_THRESHOLD = 1 GB makes the fault cost a
    one-time high-water charge.  No-op where glibc is unavailable."""
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-3, 1 << 30)   # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)   # M_TRIM_THRESHOLD
    except Exception:
        pass


_tune_malloc()

from . import config  # noqa: F401,E402

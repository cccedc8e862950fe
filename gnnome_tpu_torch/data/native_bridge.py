"""ctypes bridge to the native C++ tools in ``native/``.

The port's own loader for ``libgnnome_native.so`` (the same library and
entries as ``gnnome_tpu/data/native_bridge.py``), the chromosome-scale
implementations of the pipeline's CPU-bound stages (the roles Raven,
seqrequester and METIS play for the reference, ``pipeline.py:140-143,177-181``,
``train.py:291-293``):

  * ``simulate_reads``      — read simulator
  * ``build_overlap_graph`` — minimizer overlap + layout → CSV/GFA
  * ``partition_graph``     — balanced edge-cut partitioner

Build it with ``make -C native`` (``native/build/``, git-ignored); the
environment variable ``GNNOME_NATIVE_LIB`` names another copy. Callers check
:func:`available` (false when ``GNNOME_FORCE_PYTHON`` is set) and fall back
to the Python implementations; :func:`partition_graph` returns ``None``
when the library is missing.
"""
from __future__ import annotations

import ctypes
import functools
import os
from pathlib import Path
from typing import Optional

import numpy as np

_LIB_NAME = "libgnnome_native.so"
_INT_P = ctypes.POINTER(ctypes.c_int)


def lib_path() -> str:
    """Where ``make -C native`` puts the library in this checkout."""
    return str(Path(__file__).resolve().parents[2] / "native" / "build" / _LIB_NAME)


@functools.cache
def _load() -> Optional[ctypes.CDLL]:
    path = os.environ.get("GNNOME_NATIVE_LIB", lib_path())
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.gn_simulate_reads.restype = ctypes.c_longlong
    lib.gn_simulate_reads.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_double, ctypes.c_char_p,
        ctypes.c_longlong, ctypes.c_double,
    ]
    lib.gn_build_overlap_graph.restype = ctypes.c_int
    lib.gn_build_overlap_graph.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.gn_partition_graph.restype = ctypes.c_int
    lib.gn_partition_graph.argtypes = [
        _INT_P, _INT_P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, _INT_P,
    ]
    return lib


def available() -> bool:
    return _load() is not None and not os.environ.get("GNNOME_FORCE_PYTHON")


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"{_LIB_NAME} not found: run `make -C native` or set "
                           "GNNOME_NATIVE_LIB")
    return lib


def simulate_reads(
    genome_path: str, out_path: str, coverage: float, distribution_path: str,
    seed: int, error_rate: float = 0.0,
) -> int:
    """Reads written to ``out_path`` (FASTA); the count is returned."""
    n = _require().gn_simulate_reads(
        genome_path.encode(), out_path.encode(), coverage,
        distribution_path.encode(), seed, error_rate,
    )
    if n < 0:
        raise RuntimeError(f"native simulate_reads failed (code {n})")
    return int(n)


def build_overlap_graph(
    reads_path: str, csv_path: str, threads: int, identity: float,
    k: int, w: int, min_overlap: int, trim_min_cov: int = 0,
) -> None:
    """identity <= 0 disables the k-mer identity gate; trim_min_cov <= 0
    disables pile trimming (both = error-free legacy behavior)."""
    rc = _require().gn_build_overlap_graph(
        reads_path.encode(), csv_path.encode(), threads, identity, k, w,
        min_overlap, trim_min_cov,
    )
    if rc != 0:
        raise RuntimeError(f"native build_overlap_graph failed (code {rc})")


def partition_graph(
    src: np.ndarray, dst: np.ndarray, n_nodes: int, n_parts: int
) -> Optional[np.ndarray]:
    """Balanced edge-cut node partition, int32[n_nodes]; None if the
    library is missing."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    if src.shape != dst.shape:
        raise ValueError(f"src {src.shape} and dst {dst.shape} differ")
    if len(src) and (min(src.min(), dst.min()) < 0
                     or max(src.max(), dst.max()) >= n_nodes):
        raise ValueError("edge endpoint out of range [0, n_nodes)")
    out = np.zeros(n_nodes, dtype=np.int32)
    rc = lib.gn_partition_graph(
        src.ctypes.data_as(_INT_P), dst.ctypes.data_as(_INT_P),
        len(src), n_nodes, n_parts, out.ctypes.data_as(_INT_P),
    )
    if rc != 0:
        raise RuntimeError(f"native partition_graph failed (code {rc})")
    return out

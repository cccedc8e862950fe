"""Build, load and launch the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together) and the objects are linked into one shared
library with a plain C interface, loaded with :mod:`ctypes`. The build runs
at first use, into ``gnnome_tpu_torch/_build/<hash>/`` where the hash
covers the sources and flags, so a changed source rebuilds and an unchanged
one loads the cached library. Nothing here runs at import time: the CPU
tests import every module on a machine with no ``nvcc`` and no card.

:class:`Kernel` is one C entry point: it launches on the current PyTorch
stream of the tensors' device, raises on the CUDA error code the entry
point returns, and counts its launches in the plain integer
``launches``. An entry takes one storage type for its data: ``_f32``
symbols float32, ``_bf16`` symbols bfloat16 (loaded as f32, stored rounded
to nearest; sums, moments and the affine stay float32); :func:`entry`
picks the one for a tensor's dtype.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR / "_build"
LIB_NAME = "libgnnome_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: Optional[ctypes.CDLL] = None


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels build at first use")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / _source_hash() / LIB_NAME


def build() -> Path:
    """Compile ``csrc/*.cu`` into the cached library if it is not built yet.
    Returns its path. The compiler's output (``-Xptxas -v``: registers,
    shared memory, spills per kernel) is kept in ``build.log`` beside it."""
    target = library_path()
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=target.parent))
    try:
        # nvcc's own temporaries go beside the objects, inside the checkout
        env = dict(os.environ, TMPDIR=str(work))
        procs = []
        for src in _sources():
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=env)))
        log = []
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(work / LIB_NAME),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (target.parent / "build.log").write_text("\n".join(log))
        os.replace(work / LIB_NAME, target)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.gnnome_error_string.argtypes = [ctypes.c_int]
        lib.gnnome_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


P = ctypes.c_void_p  # device pointer (tensor.data_ptr()) or stream handle
I64 = ctypes.c_int64
I32 = ctypes.c_int
F32 = ctypes.c_float


class Kernel:
    """One entry point of the kernel library.

    ``argtypes`` lists the entry point's own arguments; the device index and
    the stream are appended by :meth:`__call__`. ``source`` and ``replaces``
    name the CUDA file and the TPU kernel it stands in for; ``dtype`` is the
    storage type of its data."""

    def __init__(self, name: str, symbol: str, argtypes: Sequence,
                 source: str, replaces: str, dtype: torch.dtype = torch.float32):
        self.name = name
        self.symbol = symbol
        self.dtype = dtype
        self.argtypes = list(argtypes)
        self.source = source
        self.replaces = replaces
        self.launches = 0

    def __call__(self, device: torch.device, *args) -> None:
        fn = getattr(library(), self.symbol)
        fn.argtypes = [*self.argtypes, I32, P]
        fn.restype = I32
        index = device.index if device.index is not None else torch.cuda.current_device()
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*args, index, stream)
        if code != 0:
            msg = library().gnnome_error_string(code).decode()
            raise RuntimeError(f"{self.name}: launch failed, CUDA error {code} ({msg})")
        self.launches += 1


KERNELS: Dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
    KERNELS[kernel.name] = kernel
    return kernel


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version runs);
    False when every one lies on one CUDA device (the kernel launches).
    Anything else raises: there is no fallback between the two."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cpu":
        return True
    if device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {device}")


def entry(dtype: torch.dtype, *kernels: Kernel) -> Kernel:
    """The kernel among ``kernels`` whose data are ``dtype``; raises for a
    dtype none of them takes (no entry is reached by a cast)."""
    for kernel in kernels:
        if kernel.dtype == dtype:
            return kernel
    names = ", ".join(f"{k.name} ({k.dtype})" for k in kernels)
    raise ValueError(f"no kernel entry for {dtype}: {names}")


def check_cuda_args(name: str, floats: Sequence[torch.Tensor],
                    ints: Sequence[torch.Tensor], dtype: torch.dtype = torch.float32,
                    f32: Sequence[torch.Tensor] = ()) -> None:
    """What every kernel here takes: contiguous data of the entry's
    ``dtype`` (float32 or bfloat16), the float32 parts of a bf16 entry
    (``f32``: sums, moments, the affine) and int32 ids, all contiguous."""
    for want, group in ((dtype, floats), (torch.float32, f32)):
        for t in group:
            if t.dtype != want or not t.is_contiguous():
                raise ValueError(f"{name}: needs contiguous {want}, got {t.dtype} "
                                 f"contiguous={t.is_contiguous()}")
    for t in ints:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous int32 ids, got {t.dtype}")


def vec_ok(d: int, *tensors: torch.Tensor) -> bool:
    """16-byte accesses (4 float32 or 8 bfloat16) need rows of a multiple of
    16 bytes in every tensor and aligned bases."""
    return all((d * t.element_size()) % 16 == 0 and t.data_ptr() % 16 == 0
               for t in tensors)

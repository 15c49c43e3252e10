"""Build the CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C entry point and compiles alone
into ``build/kernels/<name>.so`` at the repository root (a directory git
ignores), for ``sm_90a``. A library is built at its first use, or anew
when its source is newer; :func:`build_all` starts one ``nvcc`` per
source, all at once, and waits for them. Nothing is compiled when this
module is imported. A :class:`Kernel` binds one entry point once; the
``check_*`` functions are the argument checks the wrappers share before
they pass pointers.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("bitmap_join_many", "gather_intersect_many", "bitmap_join")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

GRID_MAX = 65535            # a CUDA grid's y and z limit

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the kernels (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}.so"


def _stale(name: str) -> bool:
    lib, src = _lib_path(name), CSRC / f"{name}.cu"
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every stale source in parallel; returns each compiled
    source's ``nvcc`` output (ptxas register and shared-memory report).
    Raises ``RuntimeError`` with the compiler's output on a failure."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        # each process writes its own file and renames it into place, so
        # concurrent builds never load a half-written library
        tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs: Dict[str, str] = {}
    failed = []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return lib


class Kernel:
    """The C entry point ``name`` of ``csrc/<name>.cu``, typed as
    ``argtypes`` -> int (a CUDA error code), its last argument the stream
    to launch on. It is built and bound at its first call, and later
    calls go straight to ``ctypes``; a call raises ``RuntimeError`` when
    the launch returned an error."""

    def __init__(self, name: str, argtypes: Sequence):
        self.name = name
        self.argtypes = list(argtypes)
        self._fn = None
        self._err = None

    def _bind(self):
        lib = library(self.name)
        err = getattr(lib, f"{self.name}_error")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        fn = getattr(lib, self.name)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._err = err
        self._fn = fn
        return fn

    def __call__(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream with ``args`` (all but the
        stream). ``device`` is the calling thread's current device for the
        call: the entry point launches in the current device's context,
        which a thread that never chose one (a shard's dispatcher) leaves
        at device 0."""
        fn = self._fn or self._bind()
        with torch.cuda.device(device):
            code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if code != 0:
            msg = self._err(code).decode()
            raise RuntimeError(f"{self.name} launch failed: CUDA error "
                               f"{code} ({msg})")


def check_store(name: str, rows: torch.Tensor, n_words: int) -> None:
    """Raise unless ``rows`` is an int32 [rows, width] store with unit
    word stride whose rows hold at least ``n_words`` words."""
    if rows.dtype != torch.int32:
        raise TypeError(f"{name} must hold int32 words, got {rows.dtype}")
    if rows.dim() != 2 or rows.stride(1) != 1:
        raise ValueError(f"{name} must be a [rows, words] store with unit "
                         f"word stride, got {tuple(rows.shape)}")
    if not 0 <= n_words <= rows.shape[1]:
        raise ValueError(f"n_words={n_words} outside {name}'s row width "
                         f"{rows.shape[1]}")


def check_index(name: str, idx: torch.Tensor, dim: int) -> None:
    """Raise unless ``idx`` is a ``dim``-d int32 tensor."""
    if idx.dtype != torch.int32 or idx.dim() != dim:
        raise TypeError(f"{name} must be a {dim}-d int32 tensor, got "
                        f"{idx.dtype} {tuple(idx.shape)}")


def check_grid(b: int, e: int, rows_per_block: int) -> None:
    """Raise when a [b, e] batch needs more blocks than a grid's y (row
    tiles) or z (requests) axis holds."""
    if b > GRID_MAX or -(-e // rows_per_block) > GRID_MAX:
        raise ValueError(f"batch [{b}, {e}] exceeds the kernel's grid")

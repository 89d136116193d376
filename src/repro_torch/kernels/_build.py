"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own by
``nvcc`` for ``sm_90a`` into ``build/repro_torch_kernels/lib<name>.so`` at the
root of the checkout, the first time a kernel is asked for, then loaded with
``ctypes``. A library is rebuilt when its source, or a shared header
``csrc/*.cuh``, is newer. ``build_all``
starts one ``nvcc`` per source, all at once. A failed build raises with the
compiler's output.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("gemm", "decode_attention", "flash_attention", "convlayer",
           "maxpool", "leakyrelu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}       # name -> ptxas report of the last build
BUILD_S: dict[str, float] = {}       # name -> seconds its last nvcc took


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _paths(name: str) -> tuple[Path, Path]:
    return CSRC / f"{name}.cu", BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    newest = max(p.stat().st_mtime for p in (src, *CSRC.glob("*.cuh")))
    return not lib.exists() or lib.stat().st_mtime < newest


def _start(name: str) -> subprocess.Popen:
    src, lib = _paths(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    return subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(name: str, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    BUILD_LOG[name] = out
    _, lib = _paths(name)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{out}")
    os.replace(tmp, lib)


def build_all(names=SOURCES) -> float:
    """Compile every stale source in parallel; returns the seconds taken
    (each source's in ``BUILD_S``)."""
    t0 = time.perf_counter()
    procs = {n: _start(n) for n in names if _stale(n)}
    errors = []

    def finish(n, p):            # a thread each: every compiler's output drained
        try:
            _finish(n, p)
        except RuntimeError as e:
            errors.append(str(e))
        BUILD_S[n] = time.perf_counter() - t0

    threads = [threading.Thread(target=finish, args=item) for item in procs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            _finish(name, _start(name))
        lib = ctypes.CDLL(str(_paths(name)[1]))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


VP = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_int64
F32 = ctypes.c_float

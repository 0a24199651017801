"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
with ``nvcc`` for ``sm_90a`` into a shared library under
``distegnn_tpu_torch/_build/`` (named by a hash of the source and the shared
``csrc/*.cuh`` headers, so an edited source or header is rebuilt) and loaded
with ``ctypes``. Nothing is built or loaded at import time: the CPU tests
import every module of the port.

Several processes may reach a build at once (the ranks of a distributed
run): :func:`locked_build` lets one of them compile while the others wait on
a file lock, and the library appears under its final name by an atomic
rename only once it is complete.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from typing import Callable, Dict, List, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]


class KernelBuildError(RuntimeError):
    """nvcc failed, or no CUDA toolkit was found."""


class _Libraries:
    """Built-and-loaded kernel libraries of this process, by source name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._libs: Dict[str, ctypes.CDLL] = {}

    def get(self, name: str) -> ctypes.CDLL:
        with self._lock:
            lib = self._libs.get(name)
            if lib is None:
                lib = self._libs[name] = ctypes.CDLL(_build(name)[0])
            return lib


LIBRARIES = _Libraries()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise KernelBuildError("no CUDA toolkit found (CUDA_HOME unset and no "
                               "nvcc on PATH); cannot build the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


@contextlib.contextmanager
def _file_lock(path: str):
    """An exclusive ``flock`` on ``path`` (released when the holder exits,
    even by a crash)."""
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def locked_build(out: str, compile_to: Callable[[str], str]) -> Tuple[str, str]:
    """Make the file ``out`` once across processes: under a lock beside it,
    return ``(out, "(cached build)")`` when it exists, else call
    ``compile_to(tmp)`` (which writes ``tmp`` and returns its report) and
    rename ``tmp`` to ``out``."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with _file_lock(out + ".lock"):
        if os.path.exists(out):
            return out, "(cached build)"
        tmp = f"{out}.{os.getpid()}.tmp"
        try:
            report = compile_to(tmp)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return out, report


def _build(name: str):
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the source and every shared header under csrc/ it may include
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")

    def nvcc(tmp: str) -> str:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed for {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        return proc.stdout + proc.stderr

    return locked_build(out, nvcc)


def build_all(names: List[str]) -> Dict[str, str]:
    """Build several kernel sources at once, one ``nvcc`` per source started
    together; returns each build's compiler report (``-Xptxas -v``).
    Loading still happens on first use through :data:`LIBRARIES`."""
    reports: Dict[str, str] = {}
    errors: List[BaseException] = []

    def one(n):
        try:
            reports[n] = _build(n)[1]
        except BaseException as exc:   # re-raised below, in the caller
            errors.append(exc)

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return reports

"""ctypes bindings of the in-tree C++ host code (port of
``distegnn_tpu/native.py``): the graph partitioner (``native/partition.cpp``)
and the blocked edge layout (``native/blockify.cpp``).

The sources under ``native/`` are compiled as they stand with
``g++ -O3 -shared -fPIC -std=c++17`` into ``distegnn_tpu_torch/_build/``
(named by a hash of the flags and the sources, so an edited source is
rebuilt), at first use and never at import. The build is locked across
processes (``ops.build.locked_build``): the ranks of a distributed run may
reach it at once. Where no compiler is found each entry point returns None
and its caller uses the numpy version: the same blocked layout and pairing,
and for the partition a different (BFS bisection) labelling, which
``data/partition.metis_labels`` reports.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from distegnn_tpu_torch.ops.build import BUILD_DIR, locked_build

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
SOURCES = ("partition.cpp", "blockify.cpp")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


class _Native:
    """The library of this process: built and bound once, or None for good
    when it cannot be built."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._failed = False

    def get(self) -> Optional[ctypes.CDLL]:
        with self._lock:
            if self._lib is None and not self._failed:
                try:
                    self._lib = _bind(ctypes.CDLL(library_path()))
                except (OSError, subprocess.SubprocessError, AttributeError):
                    self._failed = True
            return self._lib


_NATIVE = _Native()


def library_path() -> str:
    """Build the library if needed; its path. Raises OSError (no compiler)
    or ``subprocess.CalledProcessError`` (the compiler failed)."""
    srcs = [os.path.join(NATIVE_DIR, s) for s in SOURCES]
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for path in srcs:
        with open(path, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR,
                       f"libdistegnn_native-{h.hexdigest()[:16]}.so")

    def gxx(tmp: str) -> str:
        proc = subprocess.run(["g++", *CXX_FLAGS, *srcs, "-o", tmp],
                              capture_output=True, text=True, timeout=300,
                              check=True)
        return proc.stdout + proc.stderr

    return locked_build(out, gxx)[0]


def load_native() -> Optional[ctypes.CDLL]:
    """The native library, building it if needed; None if unavailable."""
    return _NATIVE.get()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every exported symbol's signature, as the JAX package does."""
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.partition_graph.restype = ctypes.c_int
    lib.partition_graph.argtypes = [ctypes.c_int64, i64, i64, ctypes.c_int32,
                                    ctypes.c_uint64, i32]
    lib.edge_cut.restype = ctypes.c_int64
    lib.edge_cut.argtypes = [ctypes.c_int64, i64, i64, i32]
    lib.blockify_edges_native.restype = ctypes.c_int
    lib.blockify_edges_native.argtypes = [
        ctypes.c_int64, i64, i64,
        ctypes.c_void_p,  # attr (may be NULL)
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i32, f32, f32]
    lib.pairing_perm_native.restype = ctypes.c_int
    lib.pairing_perm_native.argtypes = [ctypes.c_int64, i32, i32, i64]
    return lib


def native_partition(indptr: np.ndarray, indices: np.ndarray, nparts: int,
                     seed: int = 0) -> Optional[np.ndarray]:
    """Balanced k-way partition labels [n] (int32) of the CSR graph, or None
    when the library cannot be built or refuses the input."""
    lib = load_native()
    if lib is None:
        return None
    n = indptr.shape[0] - 1
    labels = np.empty(n, np.int32)
    rc = lib.partition_graph(n, np.ascontiguousarray(indptr, np.int64),
                             np.ascontiguousarray(indices, np.int64),
                             np.int32(nparts), np.uint64(seed), labels)
    return labels if rc == 0 else None


def native_edge_cut(indptr: np.ndarray, indices: np.ndarray,
                    labels: np.ndarray) -> Optional[int]:
    """Directed CSR entries whose ends lie in different parts (each
    undirected edge counted twice), or None without the library."""
    lib = load_native()
    if lib is None:
        return None
    n = indptr.shape[0] - 1
    return int(lib.edge_cut(n, np.ascontiguousarray(indptr, np.int64),
                            np.ascontiguousarray(indices, np.int64),
                            np.ascontiguousarray(labels, np.int32)))


def native_blockify(edge_index: np.ndarray, edge_attr: Optional[np.ndarray],
                    n_nodes: int, epb: int, block: int):
    """``ops.blocked.blockify_edges`` of a row-sorted edge list in C++:
    (edge_index' [2, NB*epb] int32, edge_attr' [NB*epb, D], edge_mask'
    [NB*epb]), or None when the library cannot be built or the input is
    refused (unsorted rows, a row out of range, a block over ``epb``)."""
    lib = load_native()
    if lib is None:
        return None
    e = edge_index.shape[1]
    E = (n_nodes // block) * epb
    d = edge_attr.shape[1] if edge_attr is not None else 0
    out_index = np.empty((2, E), np.int32)
    # d == 0: the library never touches out_attr; one element satisfies ctypes
    out_attr = np.zeros((E, d) if d else (1, 1), np.float32)
    out_mask = np.empty((E,), np.float32)
    row = np.ascontiguousarray(edge_index[0], np.int64)
    col = np.ascontiguousarray(edge_index[1], np.int64)
    # a named reference keeps the contiguous copy alive across the call
    attr = np.ascontiguousarray(edge_attr, np.float32) if d else None
    rc = lib.blockify_edges_native(
        e, row, col, attr.ctypes.data if d else None, d, n_nodes, block, epb,
        out_index, out_attr, out_mask)
    if rc != 0:
        return None
    return out_index, out_attr if d else np.zeros((E, 0), np.float32), out_mask


def native_pairing(edge_index: np.ndarray):
    """The reverse-edge involution (``ops.blocked.pairing_perm``) in C++:
    an int64 permutation, False when the list is not symmetric, or None
    when the library cannot be built or the ids exceed its packing (the
    caller then uses numpy). ``ops.blocked.pairing_perm_fast`` folds the
    three cases."""
    lib = load_native()
    if lib is None:
        return None
    e = edge_index.shape[1]
    pair = np.empty((e,), np.int64)
    rc = lib.pairing_perm_native(
        e, np.ascontiguousarray(edge_index[0], np.int32),
        np.ascontiguousarray(edge_index[1], np.int32), pair)
    if rc == 0:
        return pair
    if rc == 1:
        return False
    return None

"""Out-of-core graph datasets (port of the shard half of
``distegnn_tpu/data/stream.py``; its ``PrefetchLoader`` is
``data/loader.py``'s).

:func:`write_shards` lays a processed dataset out as a directory of
fixed-schema ``.npz`` shards and a JSON manifest (per-shard graph counts, N
and E maxima, the dataset's maxima, a CRC32 per shard), in the JAX package's
format (``FORMAT``): a directory written by either package opens in the
other. :class:`StreamedGraphDataset` serves ``GraphDataset``'s
``__len__`` / ``__getitem__`` / ``size_maxima`` over such a directory while
holding only ``cache_shards`` decoded shards (an LRU), so the loaders run
unchanged and host memory stays bounded by the cache, not the dataset.
:func:`open_dataset` picks the one or the other from the source; the
distributed launcher opens every rank's shard through it.

npz is lossless and a shard's arrays are served as views, so a streamed
epoch is bitwise the in-memory one. Every file is read through
``data/loader.py``'s retried read and its open hook; a shard's checksum
mismatch is retried too.
"""

from __future__ import annotations

import collections
import io
import json
import os
import zlib
from typing import Sequence

import numpy as np

from distegnn_tpu_torch import obs
from distegnn_tpu_torch.data import loader
from distegnn_tpu_torch.data.loader import GraphDataset
from distegnn_tpu_torch.ops.order import morton_perm, reorder_graph

FORMAT = "distegnn-shards-v1"
MANIFEST = "manifest.json"

# graph-dict fields along the node axis / the edge axis, in shard order.
# An optional field is present in every graph of the dataset or in none
# (one batch structure a run).
_NODE_FIELDS = ("node_feat", "node_attr", "loc", "vel", "target")
_EDGE_FIELDS = ("edge_attr",)
_OPTIONAL = frozenset({"node_attr", "target", "edge_attr"})

class ShardChecksumError(RuntimeError):
    """A shard's bytes do not match the manifest's CRC32 (bit rot, a torn
    write, a partial copy). Retried a bounded number of times; persistent
    corruption propagates."""


def _crc32(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _present_fields(graphs: Sequence[dict]) -> dict:
    """Which fields the dataset has; an optional field present in some
    graphs and not others raises."""
    present = {}
    for name in _NODE_FIELDS + _EDGE_FIELDS:
        if name not in _OPTIONAL:
            present[name] = True
            continue
        have = [g.get(name) is not None for g in graphs]
        if any(have) and not all(have):
            raise ValueError(
                f"write_shards: field {name!r} present in some graphs but "
                "not others; the loaders need one schema for the dataset")
        present[name] = bool(have and have[0])
    return present


def _write_atomic(path: str, payload: bytes) -> None:
    with open(path + ".tmp", "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(path + ".tmp", path)


def _morton(g: dict) -> dict:
    return reorder_graph(g, morton_perm(g["loc"]))


def write_shards(graphs: Sequence[dict], out_dir: str, shard_size: int = 64,
                 node_order: str = "none") -> dict:
    """Write ``graphs`` as ``out_dir/shard_%05d.npz`` + ``manifest.json``.

    A shard holds ``node_ptr`` / ``edge_ptr`` (int64 offsets of its graphs),
    the node fields concatenated on axis 0, ``edge_attr`` on the edge axis,
    ``edge_index`` [2, E] with each graph's own node ids, and ``loc_mean``
    [g, 3]. ``node_order='morton'`` relabels every graph along the Z curve
    first. Every file is written to a temporary name, synced and renamed.
    Returns the manifest."""
    if shard_size < 1:
        raise ValueError(
            f"write_shards: shard_size must be >= 1, got {shard_size}")
    graphs = list(graphs)
    if not graphs:
        raise ValueError("write_shards: empty dataset")
    if node_order == "morton":
        graphs = [_morton(g) for g in graphs]
    elif node_order not in ("none", None):
        raise ValueError(f"write_shards: unknown node_order {node_order!r}")
    present = _present_fields(graphs)
    os.makedirs(out_dir, exist_ok=True)

    shards = []
    for s0 in range(0, len(graphs), shard_size):
        chunk = graphs[s0:s0 + shard_size]
        arrays = {
            "node_ptr": np.cumsum(
                [0] + [g["loc"].shape[0] for g in chunk], dtype=np.int64),
            "edge_ptr": np.cumsum(
                [0] + [g["edge_index"].shape[1] for g in chunk],
                dtype=np.int64),
            "edge_index": np.concatenate([g["edge_index"] for g in chunk],
                                         axis=1),
            "loc_mean": np.stack(
                [g["loc_mean"] if g.get("loc_mean") is not None
                 else g["loc"].mean(axis=0) for g in chunk], axis=0),
        }
        for name in _NODE_FIELDS + _EDGE_FIELDS:
            if present[name]:
                arrays[name] = np.concatenate([g[name] for g in chunk],
                                              axis=0)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        payload = buf.getvalue()
        fname = f"shard_{len(shards):05d}.npz"
        _write_atomic(os.path.join(out_dir, fname), payload)
        shards.append({
            "file": fname,
            "n_graphs": len(chunk),
            "max_nodes": max(g["loc"].shape[0] for g in chunk),
            "max_edges": max(g["edge_index"].shape[1] for g in chunk),
            "crc32": _crc32(payload),
            "bytes": len(payload),
        })

    manifest = {
        "format": FORMAT,
        "n_graphs": len(graphs),
        "shard_size": shard_size,
        "node_order": node_order or "none",
        "fields": present,
        "max_nodes": max(s["max_nodes"] for s in shards),
        "max_edges": max(s["max_edges"] for s in shards),
        "shards": shards,
    }
    _write_atomic(os.path.join(out_dir, MANIFEST),
                  json.dumps(manifest, indent=1).encode("utf-8"))
    obs.log(f"write_shards: {len(graphs)} graphs -> {len(shards)} shards in "
            f"{out_dir} ({sum(s['bytes'] for s in shards) / 2**20:.1f} MiB)")
    return manifest


def is_shard_dir(path) -> bool:
    return (isinstance(path, str) and os.path.isdir(path)
            and os.path.exists(os.path.join(path, MANIFEST)))


class StreamedGraphDataset:
    """``GraphDataset``'s protocol over a :func:`write_shards` directory,
    with at most ``cache_shards`` decoded shards resident (least recently
    used evicted). A shard enters the cache in one read, its CRC32 checked
    against the manifest (``verify``); graphs are views into its arrays.
    The gauge ``data/host_bytes`` holds the cache's bytes."""

    def __init__(self, shard_dir: str, node_order: str = "none",
                 cache_shards: int = 4, verify: bool = True):
        if cache_shards < 1:
            raise ValueError("StreamedGraphDataset: cache_shards must be >= "
                             f"1, got {cache_shards}")
        self.shard_dir = shard_dir
        self.cache_shards = cache_shards
        self.verify = verify
        self.manifest = loader._read_with_retry(
            os.path.join(shard_dir, MANIFEST),
            lambda f: json.loads(f.read().decode("utf-8")), what="manifest")
        if self.manifest.get("format") != FORMAT:
            raise ValueError(
                f"StreamedGraphDataset: {shard_dir} manifest format "
                f"{self.manifest.get('format')!r} != {FORMAT!r}")
        if node_order not in ("none", "morton", None):
            raise ValueError(
                f"StreamedGraphDataset: unknown node_order {node_order!r}")
        # shards written Morton-ordered need no reorder on access
        self._reorder = (_morton if node_order == "morton"
                         and self.manifest.get("node_order") != "morton"
                         else None)
        self._starts = np.cumsum(
            [0] + [s["n_graphs"] for s in self.manifest["shards"]])
        self._cache: collections.OrderedDict = collections.OrderedDict()
        self._cache_bytes = 0
        self._host_gauge = obs.get_registry().gauge("data/host_bytes")

    def __len__(self) -> int:
        return int(self.manifest["n_graphs"])

    @property
    def open_shards(self) -> int:
        """Decoded shards resident now."""
        return len(self._cache)

    def size_maxima(self):
        return int(self.manifest["max_nodes"]), int(self.manifest["max_edges"])

    def _load_shard(self, si: int) -> dict:
        meta = self.manifest["shards"][si]
        path = os.path.join(self.shard_dir, meta["file"])

        def reader(f):
            payload = f.read()
            if self.verify and _crc32(payload) != meta["crc32"]:
                raise ShardChecksumError(
                    f"{path}: crc32 {_crc32(payload):#010x} != manifest "
                    f"{meta['crc32']:#010x} ({len(payload)} bytes read, "
                    f"{meta['bytes']} expected)")
            with np.load(io.BytesIO(payload)) as z:
                return {k: z[k] for k in z.files}

        return loader._read_with_retry(path, reader, what="shard",
                                       retry_on=(ShardChecksumError,))

    def _shard(self, si: int) -> dict:
        hit = self._cache.get(si)
        if hit is not None:
            self._cache.move_to_end(si)
            return hit
        arrays = self._load_shard(si)
        self._cache[si] = arrays
        self._cache_bytes += sum(a.nbytes for a in arrays.values())
        while len(self._cache) > self.cache_shards:
            _, old = self._cache.popitem(last=False)
            self._cache_bytes -= sum(a.nbytes for a in old.values())
        self._host_gauge.set(self._cache_bytes)
        return arrays

    def __getitem__(self, i: int) -> dict:
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(f"graph index {i} out of range [0, {len(self)})")
        si = int(np.searchsorted(self._starts, i, side="right")) - 1
        j = i - int(self._starts[si])
        sh = self._shard(si)
        n0, n1 = int(sh["node_ptr"][j]), int(sh["node_ptr"][j + 1])
        e0, e1 = int(sh["edge_ptr"][j]), int(sh["edge_ptr"][j + 1])
        fields = self.manifest["fields"]
        g = {"edge_index": sh["edge_index"][:, e0:e1],
             "loc_mean": sh["loc_mean"][j]}
        for name in _NODE_FIELDS:
            g[name] = sh[name][n0:n1] if fields.get(name) else None
        for name in _EDGE_FIELDS:
            g[name] = sh[name][e0:e1] if fields.get(name) else None
        if self._reorder is not None:
            g = self._reorder(g)
        return g


def open_dataset(source, node_order: str = "none", cache_shards: int = 4):
    """A :func:`write_shards` directory streams
    (:class:`StreamedGraphDataset`); a pickle path or a list of graph dicts
    is held in memory (``GraphDataset``)."""
    if is_shard_dir(source):
        return StreamedGraphDataset(source, node_order=node_order,
                                    cache_shards=cache_shards)
    return GraphDataset(source, node_order=node_order)

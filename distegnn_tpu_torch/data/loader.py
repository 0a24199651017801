"""Static-shape graph loaders (port of ``distegnn_tpu/data/loader.py`` and
of ``PrefetchLoader`` of ``distegnn_tpu/data/stream.py``).

``GraphDataset`` holds graph dicts in memory (or reads them from a pickle);
``GraphLoader`` collates them into padded ``GraphBatch``es whose node count,
edges per block and remote pad are fixed once per dataset, so every batch of
a run has one shape. The permutation of an epoch is numpy's
``default_rng([seed, epoch])``, so the batches are bitwise those of the JAX
loader. Two layouts: the plain row-sorted one (``edge_block`` 0, the
``edge_impl='plain'`` path; optionally with the reverse-edge pairing and
``max_in_degree`` of the scatter-free lowerings) and the blocked one (the
one-hot kernels of the plain path, with the pairing when the dataset is
symmetric; with ``split_remote`` the fused edge kernel's).

A distributed run gives each rank the loader of its own graph-part shard
(:func:`shard_loader`): the same shuffle seed, so every rank draws the same
graphs in the same order, and one layout (node count, edges per block,
pairing, remote width) agreed over the ranks, so rank r's batch is exactly
slice r of the JAX package's ``ShardedGraphLoader`` stack. ``PrefetchLoader``
collates and copies batches to the card in a background thread.

Stall accounting (the trainer reads per-step deltas of the registry counter
``data/stall_s``, obs/metrics.py): a ``GraphLoader``'s collation is time the
trainer waits on data, unless the thread collating runs under
:func:`stall_attribution`: ``PrefetchLoader``'s producer charges its
overlapped work to ``data/produce_s``, and only the consumer's real wait
lands on ``data/stall_s`` (and on ``data/prefetch_stall_s``).
"""

from __future__ import annotations

import contextlib
import pickle
import queue
import threading
import time
import zipfile
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from distegnn_tpu_torch import obs
from distegnn_tpu_torch.obs.cudaprobe import TransferMeter
from distegnn_tpu_torch.ops.blocked import (prepare_blocked_graph,
                                            scan_dataset_for_blocking)
from distegnn_tpu_torch.ops.edge_pipeline import count_remote_edges
from distegnn_tpu_torch.ops.graph import _round_up, pad_graphs
from distegnn_tpu_torch.ops.order import morton_perm, reorder_graph

# module-level open hook: every dataset read (a pickled dataset here, a
# shard of data/stream.py) opens its file through it, so a fault harness can
# swap it for a flaky or truncating open without a real filesystem fault
_file_open = open

# a read that fails transiently (a short read off a network file system) is
# retried, the whole read and not only the open: open / read errors, a
# pickle cut mid-payload, a truncated npz and numpy's header parse of
# garbage; a file broken the same way on every attempt still fails after the
# last one
_READ_ATTEMPTS = 3
_READ_BACKOFF_S = 0.1
_READ_ERRORS = (OSError, EOFError, pickle.UnpicklingError,
                zipfile.BadZipFile, ValueError)


def _read_with_retry(path: str, reader: Callable, what: str = "dataset",
                     retry_on: tuple = ()):
    """``reader(file)`` of ``path`` opened through ``_file_open``, the whole
    read tried ``_READ_ATTEMPTS`` times (0.1 s, 0.2 s backoff, each retry
    logged). ``retry_on`` adds the caller's own errors (a shard's checksum
    mismatch) to ``_READ_ERRORS``; the last failure propagates."""
    errors = _READ_ERRORS + tuple(retry_on)
    for attempt in range(_READ_ATTEMPTS):
        try:
            with _file_open(path, "rb") as f:
                return reader(f)
        except errors as e:
            if attempt == _READ_ATTEMPTS - 1:
                raise
            delay = _READ_BACKOFF_S * (2 ** attempt)
            obs.log(f"loader: {what} read {path} failed ({e!r}); retry "
                    f"{attempt + 1}/{_READ_ATTEMPTS - 1} in {delay:.1f}s")
            time.sleep(delay)


def graphs_nbytes(graphs: Sequence[dict]) -> int:
    """Resident bytes of a list of graph dicts (numpy payload only)."""
    return sum(v.nbytes for g in graphs for v in g.values()
               if isinstance(v, np.ndarray))


# the counter this thread's collation time is charged to (None: the
# trainer's data/stall_s)
_STALL_TLS = threading.local()


def _stall_counter():
    name = getattr(_STALL_TLS, "name", None) or "data/stall_s"
    return obs.get_registry().counter(name)


@contextlib.contextmanager
def stall_attribution(name: str):
    """Charge this THREAD's loader stall accounting to counter ``name``."""
    prev = getattr(_STALL_TLS, "name", None)
    _STALL_TLS.name = name
    try:
        yield
    finally:
        _STALL_TLS.name = prev


class GraphDataset:
    """A list of graph dicts, from a pickle file or in memory.

    ``node_order='morton'`` relabels each graph's nodes along a Z curve of
    its positions (the caller's list is not modified). A pickle is read
    through :func:`_read_with_retry`; the dataset's bytes go on the
    ``data/host_bytes`` gauge."""

    def __init__(self, source: Union[str, Sequence[dict]],
                 node_order: Optional[str] = "none"):
        if isinstance(source, str):
            self.graphs: List[dict] = _read_with_retry(
                source, pickle.load, what="pickle")
        else:
            self.graphs = list(source)
        if node_order == "morton":
            self.graphs = [reorder_graph(g, morton_perm(g["loc"]))
                           for g in self.graphs]
        elif node_order not in ("none", None):
            raise ValueError(f"GraphDataset: unknown node_order {node_order!r}")
        nbytes = graphs_nbytes(self.graphs)
        obs.get_registry().gauge("data/host_bytes").add(nbytes)
        obs.log(f"loader: GraphDataset[{len(self.graphs)} graphs] resident "
                f"{nbytes / 2**20:.1f} MiB (data/host_bytes)")

    def __len__(self) -> int:
        return len(self.graphs)

    def __getitem__(self, i: int) -> dict:
        return self.graphs[i]

    def size_maxima(self):
        n = max(g["loc"].shape[0] for g in self.graphs)
        e = max(g["edge_index"].shape[1] for g in self.graphs)
        return n, e


class GraphLoader:
    """Deterministic batching over a GraphDataset: the order of an epoch
    derives from (seed, epoch) only; drop_last always.

    Batches are CPU ``GraphBatch``es with one shape for the whole dataset.
    ``edge_block`` 0: the plain layout, ``max_nodes``/``max_edges`` the
    dataset maxima rounded up to ``node_bucket``/``edge_bucket``;
    ``pairing=True`` attaches the reverse-edge pairing to every batch with a
    dataset-stable ``max_in_degree`` (the cumsum and ELL lowerings use
    them). ``edge_block`` > 0: the blocked layout of ``edge_block`` nodes per
    block, with one ``max_nodes`` and one ``edges_per_block``; ``pairing``
    ``None`` decides by a symmetry scan of the dataset (the blocked column
    gathers' backward uses the pairing). ``split_remote`` adds the compact
    remote list of the fused edge kernel, with one ``remote_pad``, and then
    at least 3 blocks. The blockified graphs are cached across epochs while
    they fit ``CACHE_BYTES``. ``rows=(a, b)`` keeps rows [a, b) of each
    padded batch (a data-parallel rank's share of the draw)."""

    EDGE_TILE = 512
    CACHE_BYTES = 2 << 30

    def __init__(self, dataset: GraphDataset, batch_size: int,
                 shuffle: bool = False, seed: int = 0, edge_block: int = 0,
                 pairing: Optional[bool] = None, node_bucket: int = 8,
                 edge_bucket: int = 128, split_remote: bool = False,
                 max_nodes: Optional[int] = None,
                 max_edges: Optional[int] = None,
                 edges_per_block: Optional[int] = None,
                 max_in_degree: Optional[int] = None,
                 remote_pad: Optional[int] = None,
                 rows: Optional[Tuple[int, int]] = None):
        if split_remote and not edge_block:
            raise ValueError("GraphLoader: split_remote requires edge_block "
                             "> 0 (the fused pipeline's window is defined on "
                             "the blocked layout)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.edge_block = edge_block
        self.split_remote = bool(split_remote)
        self.rows = rows
        self._prepared_cache = None
        if len(self) == 0:
            raise ValueError(f"batch_size {batch_size} > dataset size "
                             f"{len(dataset)}: drop_last leaves zero batches")
        n, e = dataset.size_maxima()
        if not edge_block:
            self.pairing = bool(pairing)
            self.max_nodes = max_nodes or _round_up(max(n, 1), node_bucket)
            self.max_edges = max_edges or _round_up(max(e, 1), edge_bucket)
            self.max_in_degree = max_in_degree
            if self.pairing and max_in_degree is None:
                # one ELL degree for the run, so every batch has one shape
                deg = max(int(np.bincount(dataset[i]["edge_index"][0],
                                          minlength=1).max())
                          for i in range(len(dataset)))
                self.max_in_degree = _round_up(max(deg, 1), 8)
            return
        self.max_nodes = _round_up(max(max_nodes or 0, n, 1), edge_block)
        if split_remote:
            # the fused kernel's 3-block window needs nb >= 3; small graphs
            # pay all-padding blocks rather than failing
            self.max_nodes = max(self.max_nodes, 3 * edge_block)
        if edges_per_block is None or pairing is None:
            deg, sym = scan_dataset_for_blocking(dataset, self.max_nodes,
                                                 edge_block)
            if edges_per_block is None:
                edges_per_block = _round_up(deg, self.EDGE_TILE)
            if pairing is None:
                pairing = sym
        self.pairing = bool(pairing)
        self.edges_per_block = edges_per_block
        self.max_edges = (self.max_nodes // edge_block) * self.edges_per_block
        self.remote_pad = remote_pad
        if split_remote and remote_pad is None:
            # blockify never adds out-of-window edges (its padding slots sit
            # in their own block): scan the raw lists, pad to 128 lanes
            er = max(count_remote_edges(dataset[i]["edge_index"],
                                        block=edge_block,
                                        n_nodes=self.max_nodes)
                     for i in range(len(dataset)))
            self.remote_pad = max(_round_up(er, 128), 128)
        d0 = dataset[0].get("edge_attr")
        per = self.max_edges * (8 + 4 + 8 + (d0.shape[1] * 4
                                             if d0 is not None else 0))
        self._prepared_cache = ({} if per * len(dataset) <= self.CACHE_BYTES
                                else None)

    def pad_kwargs(self) -> dict:
        """kwargs that make pad_graphs emit this loader's layout."""
        if not self.edge_block:
            return dict(max_nodes=self.max_nodes, max_edges=self.max_edges,
                        compute_pair=self.pairing,
                        max_in_degree=self.max_in_degree)
        return dict(edge_block=self.edge_block, edge_tile=self.EDGE_TILE,
                    edges_per_block=self.edges_per_block,
                    max_nodes=self.max_nodes, compute_pair=self.pairing,
                    split_remote=self.split_remote,
                    remote_pad=self.remote_pad)

    def _graph(self, i: int) -> dict:
        if not self.edge_block:
            return self.dataset[i]
        cache = self._prepared_cache
        if cache is not None and i in cache:
            return cache[i]
        g = prepare_blocked_graph(self.dataset[i], self.max_nodes,
                                  self.edges_per_block, self.edge_block,
                                  compute_pair=self.pairing)
        if cache is not None:
            cache[i] = g
        return g

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _order(self) -> np.ndarray:
        if not self.shuffle:
            return np.arange(len(self.dataset))
        return np.random.default_rng([self.seed, self.epoch]).permutation(
            len(self.dataset))

    def __iter__(self):
        order = self._order()
        # collation is data stall (the trainer blocks on this generator),
        # unless this thread runs under stall_attribution
        stall = _stall_counter()
        for b in range(len(self)):
            t0 = time.perf_counter()
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            batch = pad_graphs([self._graph(int(i)) for i in idx],
                               **self.pad_kwargs())
            if self.rows is not None:
                a, b = self.rows
                batch = batch._map(lambda v: v[a:b])
            stall.add(time.perf_counter() - t0)
            yield batch


def shard_loader(dataset: GraphDataset, batch_size: int, axis_name: str,
                 device, shuffle: bool = False, seed: int = 0,
                 node_bucket: int = 8, edge_bucket: int = 128,
                 edge_block: int = 0, pairing: Optional[bool] = None,
                 split_remote: bool = False, data_parallel: int = 1,
                 data_index: int = 0) -> GraphLoader:
    """This rank's loader over its own shard (part g of every graph), with
    the layout the JAX package's ``ShardedGraphLoader`` computes over all
    shards: each rank scans its shard, and one MAX all-reduce over the axis
    (:mod:`parallel.collectives`, kind 'layout') gives the common node and
    edge maxima, edges per block, ELL in-degree and remote width, and the
    AND of the pairing decisions (blocked: every shard symmetric; plain
    with ``pairing``: every graph of every shard sorted and symmetric, else
    no batch of the run carries a pairing, so all ranks lower alike).

    ``data_parallel`` D > 1 (the data axis): the rank of data index d
    draws D * ``batch_size`` graphs a step, pads them as one batch and
    keeps rows [d B, (d + 1) B): JAX's [P, D B] -> [D, P, B] reshape of the
    sharded stack."""
    import torch.distributed as dist

    from distegnn_tpu_torch.ops.blocked import pairing_perm_fast
    from distegnn_tpu_torch.parallel.collectives import all_reduce

    def agree(vals):
        t = torch.tensor([int(v) for v in vals], dtype=torch.int64,
                         device=device)
        all_reduce(t, axis_name, "layout", op=dist.ReduceOp.MAX)
        return [int(v) for v in t.tolist()]

    n, e = dataset.size_maxima()
    D = int(data_parallel)
    rows = (None if D == 1 else
            (data_index * batch_size, (data_index + 1) * batch_size))

    def graphs():
        # one graph at a time: a streamed dataset keeps its cache's bound
        return (dataset[i] for i in range(len(dataset)))

    if edge_block:
        N = _round_up(max(n, 1), edge_block)
        if split_remote:
            N = max(N, 3 * edge_block)
        (N,) = agree([N])
        deg, sym = scan_dataset_for_blocking(dataset, N, edge_block)
        er = (max(count_remote_edges(g["edge_index"], block=edge_block,
                                     n_nodes=N) for g in graphs())
              if split_remote else 0)
        epb, er, asym = agree([_round_up(deg, GraphLoader.EDGE_TILE), er,
                               not sym])
        return GraphLoader(
            dataset, D * batch_size, shuffle=shuffle, seed=seed, rows=rows,
            edge_block=edge_block, split_remote=split_remote, max_nodes=N,
            edges_per_block=epb,
            pairing=(not asym) if pairing is None else pairing,
            remote_pad=max(_round_up(er, 128), 128) if split_remote else None)
    if split_remote:
        raise ValueError("shard_loader: split_remote requires edge_block > 0")
    deg, unpaired = 1, False
    if pairing:
        for g in graphs():
            row = g["edge_index"][0]
            deg = max(deg, int(np.bincount(row, minlength=1).max()))
            unpaired = unpaired or bool(np.any(np.diff(row) < 0)) or (
                pairing_perm_fast(g["edge_index"].astype(np.int64)) is None)
    n, e, deg, unpaired = agree([n, e, deg, unpaired])
    return GraphLoader(
        dataset, D * batch_size, shuffle=shuffle, seed=seed, rows=rows,
        pairing=bool(pairing) and not unpaired,
        max_nodes=_round_up(max(n, 1), node_bucket),
        max_edges=_round_up(max(e, 1), edge_bucket),
        max_in_degree=_round_up(deg, 8) if pairing else None)


class PrefetchLoader:
    """Runs ``loader``'s collation and ``put`` (e.g. the copy to the card)
    up to ``depth`` batches ahead in a background thread; ``depth=0`` is
    synchronous. A failure in the thread is raised by the consumer's next
    ``__next__`` (chained as ``__cause__``), never a hang; leaving the loop
    early stops and joins the thread.

    Accounting: the producer runs under ``stall_attribution(
    "data/produce_s")``; the consumer's wait on the queue lands on
    ``data/stall_s`` and ``data/prefetch_stall_s``; with ``depth=0`` the
    ``put`` is stall. Every batch handed to ``put`` is counted in
    ``xfer/h2d_bytes``; the gauge ``data/prefetch_depth`` holds ``depth``."""

    def __init__(self, loader, put: Optional[Callable] = None,
                 depth: int = 2):
        if depth < 0:
            raise ValueError(f"PrefetchLoader: depth must be >= 0, got {depth}")
        self.loader, self.put, self.depth = loader, put, depth
        self._meter = TransferMeter()

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def _produce(self, batch):
        self._meter.h2d(batch)
        return self.put(batch) if self.put is not None else batch

    def __iter__(self):
        reg = obs.get_registry()
        reg.gauge("data/prefetch_depth").set(self.depth)
        stall = reg.counter("data/stall_s")
        if self.depth == 0:
            for batch in self.loader:
                t0 = time.perf_counter()
                out = self._produce(batch)
                stall.add(time.perf_counter() - t0)
                yield out
            return
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def offer(msg) -> bool:
            # a bounded put that gives up once the consumer has stopped
            while not stop.is_set():
                try:
                    q.put(msg, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with stall_attribution("data/produce_s"):
                    for batch in self.loader:
                        if not offer(("item", self._produce(batch))):
                            return
                offer(("done", None))
            except BaseException as exc:  # handed to the consumer below
                offer(("err", exc))

        t = threading.Thread(target=producer, daemon=True,
                             name="distegnn-prefetch")
        t.start()
        pf_stall = reg.counter("data/prefetch_stall_s")
        try:
            while True:
                t0 = time.perf_counter()
                while True:
                    try:
                        kind, val = q.get(timeout=1.0)
                        break
                    except queue.Empty:
                        if not t.is_alive() and q.empty():
                            raise RuntimeError("prefetch thread ended "
                                               "without reporting") from None
                waited = time.perf_counter() - t0
                stall.add(waited)
                pf_stall.add(waited)
                if kind == "done":
                    return
                if kind == "err":
                    raise RuntimeError(
                        f"prefetch thread failed: {val!r}") from val
                yield val
        finally:
            stop.set()
            while True:  # unblock a producer parked on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=10.0)


def device_put(device) -> Callable:
    """``put`` of a :class:`PrefetchLoader` that copies a batch to
    ``device``: through page-locked memory, without blocking, on a card;
    unchanged on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return lambda batch: batch.to(dev)
    return lambda batch: batch.pin_memory().to(dev, non_blocking=True)

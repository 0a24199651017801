"""Device probes of the port (the counterpart of
``distegnn_tpu/obs/jaxprobe.py``): CUDA memory and host<->device transfer
bytes.

- :func:`device_memory_stats`: ``bytes_in_use`` (``memory_allocated``),
  ``peak_bytes_in_use`` (``max_memory_allocated``), ``bytes_reserved``
  (``memory_reserved``) and ``bytes_limit`` (the card's memory) of the
  run's CUDA device; an empty dict on a CPU device, where there is nothing
  to read.
- :func:`emit_memory_event` writes them into the event stream as a
  ``jax/memory`` event (the JAX package's name, so one report reads both
  packages' streams); :func:`record_memory_gauges` sets them as registry
  gauges ``mem/<tag>/<key>``.
- :class:`TransferMeter` counts the bytes a loader hands to the device
  (``xfer/h2d_bytes``) and fetches back (``xfer/d2h_bytes``).

The JAX module's other half, the compile watcher, has its counterpart in
the scanned epoch (train/scan_epoch.py): each capture of its CUDA graphs
adds to the ``scan/captures`` counter and writes a ``scan/capture`` event,
one per runner, so a later one is a recapture to look into. The eager loop
compiles no device program per shape (the CUDA kernels are built once,
before the first launch). The ``obs.jax_probe`` key keeps its name and its
default and switches this probe on or off (:func:`configure`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from distegnn_tpu_torch.obs import metrics as _metrics
from distegnn_tpu_torch.obs import trace as _trace

_MEMORY_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_reserved",
                "bytes_limit")

_enabled = True
_device: Optional[torch.device] = None


def configure(enabled: bool = True, device=None) -> None:
    """Switch the probe on or off (``obs.jax_probe``) and bind it to the
    run's device (None: the current CUDA device)."""
    global _enabled, _device
    _enabled = bool(enabled)
    _device = None if device is None else torch.device(device)


def device_memory_stats(device=None) -> Dict[str, Any]:
    """The memory counters of ``device`` (default: the configured one, else
    the current CUDA device); {} on a CPU device, without a card, or with
    the probe off."""
    dev = torch.device(device) if device is not None else _device
    if not _enabled or (dev is not None and dev.type != "cuda"):
        return {}
    if not torch.cuda.is_available():
        return {}
    idx = torch.cuda.current_device() if dev is None or dev.index is None \
        else dev.index
    return {"bytes_in_use": int(torch.cuda.memory_allocated(idx)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(idx)),
            "bytes_reserved": int(torch.cuda.memory_reserved(idx)),
            "bytes_limit": int(torch.cuda.get_device_properties(idx)
                               .total_memory)}


def emit_memory_event(tracer: Optional[_trace.Tracer] = None,
                      name: str = "jax/memory", **attrs) -> Dict[str, Any]:
    """One memory event in the stream (it lands with no counters on a CPU
    device, so a report can say there were none). Returns the counters."""
    t = tracer or _trace.get_tracer()
    stats = device_memory_stats()
    if _enabled:
        t.event(name, **{**attrs, **{k: stats[k] for k in _MEMORY_KEYS
                                     if k in stats}})
    return stats


def record_memory_gauges(tag: str,
                         registry: Optional[_metrics.MetricsRegistry] = None
                         ) -> Dict[str, Any]:
    """The memory counters as gauges ``mem/<tag>/<key>`` (none on a CPU
    device). Returns the counters."""
    reg = registry or _metrics.get_registry()
    stats = device_memory_stats()
    for k in _MEMORY_KEYS:
        if k in stats:
            reg.gauge(f"mem/{tag}/{k}").set(float(stats[k]))
    return stats


def tree_nbytes(tree) -> int:
    """Total bytes of the tensors and arrays in ``tree``: a tensor, an
    array, a dict / list / tuple of them, or an object whose attributes
    hold them (a ``GraphBatch``)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if hasattr(tree, "nbytes") and not isinstance(tree, (dict, list, tuple)):
        return int(tree.nbytes)
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    if hasattr(tree, "__dict__"):
        return sum(tree_nbytes(v) for v in vars(tree).values())
    return 0


class TransferMeter:
    """Byte counters at the host<->device boundary, in the global registry
    (``xfer/h2d_bytes``, ``xfer/d2h_bytes``)."""

    def __init__(self, registry: Optional[_metrics.MetricsRegistry] = None):
        reg = registry or _metrics.get_registry()
        self._h2d = reg.counter("xfer/h2d_bytes")
        self._d2h = reg.counter("xfer/d2h_bytes")

    def h2d(self, tree) -> int:
        n = tree_nbytes(tree)
        self._h2d.add(n)
        return n

    def d2h(self, tree) -> int:
        n = tree_nbytes(tree)
        self._d2h.add(n)
        return n

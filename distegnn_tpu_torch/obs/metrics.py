"""Run-metrics primitives (port of ``distegnn_tpu/obs/metrics.py``; pure
Python, a copy of its own).

One ``Counter``/``Gauge``/``LatencyReservoir`` vocabulary: the loaders
record data-stall time into them, the trainer reads per-step deltas and
records step latencies, the CUDA probe sets memory gauges. Everything is
O(1) on the record path and guarded by a per-primitive lock.

Exports:
  - :func:`percentile`, the nearest-rank percentile;
  - :class:`MetricsRegistry`: name -> primitive, with a flat JSON-able
    ``snapshot()`` and a Prometheus-text ``render_prometheus()``;
  - ``REGISTRY`` / :func:`get_registry`: the process-global default
    registry (``data/loader.py`` and ``obs/cudaprobe.py`` record into it).
"""

from __future__ import annotations

import json
import re
import threading
from typing import Dict, List, Union


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile on an ASCENDING list (0 <= q <= 100).

    Empty input returns 0.0; q is clamped to [0, 100] by construction of the
    index.
    """
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class Counter:
    """Monotonic add-only counter (thread-safe)."""

    kind = "counter"

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def add(self, n: Union[int, float] = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-value-wins gauge (thread-safe)."""

    kind = "gauge"

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: Union[int, float]) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, n: Union[int, float] = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class LatencyReservoir:
    """Bounded reservoir of the most recent ``size`` samples (milliseconds by
    convention); percentiles are computed at snapshot time so the record path
    stays O(1) amortized."""

    kind = "reservoir"

    def __init__(self, name: str = "", size: int = 8192):
        self.name = name
        self.size = int(size)
        self._lock = threading.Lock()
        self._vals: List[float] = []
        self._count = 0          # total ever recorded (reservoir is bounded)
        self._sum = 0.0

    def record(self, v: float) -> None:
        with self._lock:
            self._vals.append(float(v))
            self._count += 1
            self._sum += float(v)
            del self._vals[:-self.size]

    def record_many(self, vs: List[float]) -> None:
        with self._lock:
            self._vals.extend(float(v) for v in vs)
            self._count += len(vs)
            self._sum += sum(vs)
            del self._vals[:-self.size]

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def total(self) -> float:
        with self._lock:
            return self._sum

    def values(self) -> List[float]:
        """Sorted copy of the current reservoir contents."""
        with self._lock:
            return sorted(self._vals)

    def percentile(self, q: float) -> float:
        return percentile(self.values(), q)


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Metric name -> Prometheus-legal name (slashes/dots/dashes -> '_')."""
    out = _PROM_BAD.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


class MetricsRegistry:
    """Name -> primitive map with get-or-create accessors.

    ``snapshot()`` flattens everything into one {str: number} dict (reservoirs
    contribute ``<name>_p50``/``<name>_p99``/``<name>_count``/``<name>_sum``),
    which is directly a JSON line; ``render_prometheus()`` emits the same data
    in Prometheus text exposition format.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, name: str, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def reservoir(self, name: str, size: int = 8192) -> LatencyReservoir:
        return self._get_or_create(name, LatencyReservoir, size=size)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, float] = {}
        for name, m in items:
            if isinstance(m, LatencyReservoir):
                vals = m.values()
                out[f"{name}_count"] = m.count
                out[f"{name}_sum"] = round(m.total, 6)
                out[f"{name}_p50"] = round(percentile(vals, 50), 6)
                out[f"{name}_p99"] = round(percentile(vals, 99), 6)
            else:
                out[name] = m.value
        return out

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)

    def render_prometheus(self, prefix: str = "distegnn") -> str:
        """Prometheus text exposition (v0.0.4): ``# TYPE`` line + one sample
        per metric. Reservoirs render as a summary (quantile labels + _count
        and _sum samples)."""
        with self._lock:
            items = sorted(self._metrics.items())
        lines: List[str] = []
        for name, m in items:
            pname = _prom_name(f"{prefix}_{name}") if prefix else _prom_name(name)
            if isinstance(m, LatencyReservoir):
                vals = m.values()
                lines.append(f"# TYPE {pname} summary")
                for q in (50, 99):
                    lines.append(f'{pname}{{quantile="0.{q}"}} '
                                 f"{percentile(vals, q):g}")
                lines.append(f"{pname}_sum {m.total:g}")
                lines.append(f"{pname}_count {m.count}")
            else:
                lines.append(f"# TYPE {pname} {m.kind}")
                lines.append(f"{pname} {m.value:g}")
        return "\n".join(lines) + ("\n" if lines else "")


# process-global default registry: cross-cutting recorders (loader stall,
# device memory gauges) land here so the trainer and the report can read
# them without threading a registry through every constructor
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY

"""Prediction-drift gauge: the promotion conveyor's second gate (port of
``distegnn_tpu/promote/drift.py``, numpy only: its verdicts equal JAX's).

Every shadow replay produces a (live output, canary output) pair for one
warmed rung — the padded node-count bucket the request landed in. The gauge
accumulates the **relative L2 divergence** per rung::

    d = ||canary - live||_2 / (||live||_2 + eps)

and the promoter's verdict keys on the per-rung MEAN exceeding a configured
ceiling (mean, not max: one hard graph is noise, a shifted mean is a model
that disagrees with production). A candidate whose outputs are NaN/Inf on
any shadow pair drifts unconditionally — the engine's canary catches
non-finite on the warmed rungs, this catches it on real traffic shapes.

The gauge is cheap enough to sit in the shadow completion callback (two
norms on [n, 3] arrays) and thread-safe: shadow futures complete on
dispatcher threads while the promoter reads verdicts from its control loop.
"""

from __future__ import annotations

import threading
from typing import Dict

import numpy as np


class _RungStats:
    __slots__ = ("count", "total", "worst", "nonfinite")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.worst = 0.0
        self.nonfinite = 0


class DriftGauge:
    """Per-rung canary-vs-live output divergence with a configurable ceiling.

    Args:
      ceiling: per-rung mean relative divergence above which
        :meth:`drifted` reports True.
      min_samples: comparisons required before :meth:`decided` is True
        (summed across rungs — low-traffic canaries still reach a verdict).
    """

    def __init__(self, ceiling: float = 0.05, min_samples: int = 8):
        self.ceiling = float(ceiling)
        self.min_samples = max(int(min_samples), 1)
        self._lock = threading.Lock()
        self._rungs: Dict[str, _RungStats] = {}

    def observe(self, rung: str, live, canary) -> float:
        """Record one shadow comparison; returns the divergence recorded."""
        live = np.asarray(live, dtype=np.float64)
        canary = np.asarray(canary, dtype=np.float64)
        if (live.shape != canary.shape or not np.isfinite(canary).all()
                or not np.isfinite(live).all()):
            with self._lock:
                st = self._rungs.setdefault(str(rung), _RungStats())
                st.count += 1
                st.nonfinite += 1
            return float("inf")
        denom = float(np.linalg.norm(live)) + 1e-12
        d = float(np.linalg.norm(canary - live)) / denom
        with self._lock:
            st = self._rungs.setdefault(str(rung), _RungStats())
            st.count += 1
            st.total += d
            st.worst = max(st.worst, d)
        return d

    @property
    def samples(self) -> int:
        with self._lock:
            return sum(st.count for st in self._rungs.values())

    def decided(self) -> bool:
        """Enough evidence for a verdict: the sample floor is met, or any
        rung already drifted (no point waiting to reject)."""
        return self.samples >= self.min_samples or self.drifted()

    def drifted(self) -> bool:
        with self._lock:
            for st in self._rungs.values():
                if st.nonfinite:
                    return True
                if st.count and st.total / st.count > self.ceiling:
                    return True
        return False

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Per-rung {count, mean, max, nonfinite} for events and /readyz."""
        with self._lock:
            return {
                rung: {
                    "count": st.count,
                    "mean": round(st.total / st.count, 6) if st.count else 0.0,
                    "max": round(st.worst, 6),
                    "nonfinite": st.nonfinite,
                }
                for rung, st in self._rungs.items()
            }

    def export(self, registry, prefix: str = "promote/drift") -> None:
        """Push per-rung mean/max gauges into an obs MetricsRegistry so the
        drift verdict is reconstructible from a /metrics scrape alone."""
        if registry is None:
            return
        for rung, row in self.snapshot().items():
            registry.gauge(f"{prefix}_{rung}_mean").set(row["mean"])
            registry.gauge(f"{prefix}_{rung}_max").set(row["max"])

    def reset(self) -> None:
        with self._lock:
            self._rungs.clear()


__all__ = ["DriftGauge"]

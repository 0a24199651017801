"""distegnn_tpu_torch.obs — the event stream and run metrics of the port
(port of ``distegnn_tpu/obs``):

  - ``obs.span("name")`` / ``obs.event`` / ``obs.log``: structured records
    into ``<exp_dir>/obs/events.jsonl`` (``obs/trace.py``), no-ops until
    :func:`configure` binds a sink and always under ``obs.enable: false``;
  - ``Counter`` / ``Gauge`` / ``LatencyReservoir`` / ``MetricsRegistry``
    with a JSON snapshot and Prometheus text (``obs/metrics.py``);
  - the CUDA memory and transfer probes (``obs/cudaprobe.py``);
  - declarative SLOs (``obs/slo.py``): :class:`SLOSpec` thresholds scored
    against the event stream or a live ``GET /metrics`` scrape, and the
    :class:`SLOMonitor` rolling-window gauges the gateway exports.

Render a run: ``python -m distegnn_tpu_torch.obs.report
<exp_dir>/obs/events.jsonl`` (``--request <id>`` for one request's
waterfall, ``--slo <spec.yaml>`` for the SLO verdict).
"""

from distegnn_tpu_torch.obs.metrics import (REGISTRY, Counter, Gauge,
                                            LatencyReservoir, MetricsRegistry,
                                            get_registry, percentile)
from distegnn_tpu_torch.obs.slo import SLOMonitor, SLOSpec
from distegnn_tpu_torch.obs.trace import (EventWriter, Tracer, configure,
                                          configure_from_config, event, flush,
                                          get_tracer, log, span)

__all__ = [
    "Counter", "Gauge", "LatencyReservoir", "MetricsRegistry", "REGISTRY",
    "get_registry", "percentile",
    "EventWriter", "Tracer", "configure", "configure_from_config",
    "event", "flush", "get_tracer", "log", "span",
    "SLOMonitor", "SLOSpec",
]

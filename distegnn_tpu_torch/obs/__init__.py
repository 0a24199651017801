"""distegnn_tpu_torch.obs — the event stream and run metrics of the port
(port of ``distegnn_tpu/obs``):

  - ``obs.span("name")`` / ``obs.event`` / ``obs.log``: structured records
    into ``<exp_dir>/obs/events.jsonl`` (``obs/trace.py``), no-ops until
    :func:`configure` binds a sink and always under ``obs.enable: false``;
  - ``Counter`` / ``Gauge`` / ``LatencyReservoir`` / ``MetricsRegistry``
    with a JSON snapshot and Prometheus text (``obs/metrics.py``);
  - the CUDA memory and transfer probes (``obs/cudaprobe.py``).

Render a run: ``python -m distegnn_tpu_torch.obs.report
<exp_dir>/obs/events.jsonl``. The SLO checks (``obs/slo.py``) wait for the
serving fleet (ROADMAP.md queue 1 item 6).
"""

from distegnn_tpu_torch.obs.metrics import (REGISTRY, Counter, Gauge,
                                            LatencyReservoir, MetricsRegistry,
                                            get_registry, percentile)
from distegnn_tpu_torch.obs.trace import (EventWriter, Tracer, configure,
                                          configure_from_config, event, flush,
                                          get_tracer, log, span)

__all__ = [
    "Counter", "Gauge", "LatencyReservoir", "MetricsRegistry", "REGISTRY",
    "get_registry", "percentile",
    "EventWriter", "Tracer", "configure", "configure_from_config",
    "event", "flush", "get_tracer", "log", "span",
]

"""repro_torch.obs — observability for the serving stack.

* :class:`Tracer` — span/event recording of a batch's lifecycle (submit →
  formation → advances → finish/shed), exported as Chrome trace-event
  JSON (:meth:`Tracer.save`) loadable in Perfetto.  Disabled is the
  shared :data:`NULL_TRACER` — empty methods, zero storage.
* :class:`MetricsRegistry` — named counters / gauges / histograms /
  ring-buffer time series behind ``ServerMetrics``, with a JSON
  :meth:`~MetricsRegistry.snapshot` and a Prometheus-style
  :meth:`~MetricsRegistry.exposition`.
* :class:`CacheReport` — the per-request cache-decision explainer built
  from the fused step's on-device decision and proxy traces at finish
  boundaries: no extra host sync, exact per row.

Ports of the JAX package's ``obs.registry``, ``obs.tracer`` and
``obs.report``.  Layering: this package imports nothing from
``repro_torch.serve`` / ``repro_torch.slo`` — they import it.
"""
from repro_torch.obs.registry import MetricsRegistry, TimeSeries  # noqa: F401
from repro_torch.obs.report import (  # noqa: F401
    CacheReport, fused_cache_reports, run_cache_reports,
    schedule_cache_report)
from repro_torch.obs.tracer import (  # noqa: F401
    NULL_TRACER, NullTracer, Tracer, validate_chrome_trace)

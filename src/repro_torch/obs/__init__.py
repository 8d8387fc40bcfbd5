"""Observability: tracing, metrics, export, health, drift, refit.

Port of :mod:`repro.obs`: :mod:`~repro_torch.obs.tracer` records spans
into a bounded ring (the compiler's ``compile.*`` spans and the serving
engine's per-request timelines), :mod:`~repro_torch.obs.export` renders
the ring as a Perfetto-loadable Chrome trace, :mod:`~repro_torch.obs.metrics` is the
counter/gauge/histogram registry the engine's telemetry publishes into,
:mod:`~repro_torch.obs.exporter` renders that registry as an
OpenMetrics/Prometheus exposition (with an optional stdlib scrape
endpoint), :mod:`~repro_torch.obs.health` evaluates rolling-window SLOs
with hysteresis, :mod:`~repro_torch.obs.drift` persists the
(modeled, measured) pairs that calibrate the cost model, and
:mod:`~repro_torch.obs.sentinel` watches those pairs and refits the
cost model when its fitted constants go stale.

This package imports only the standard library and numpy at module
load, so every layer of the port can depend on it without cycles (the
sentinel pulls in :mod:`repro_torch.tune` lazily, at use).
"""
from repro_torch.obs.drift import (DRIFT_ENV, DriftLog, DriftRow,
                                   default_drift_path, drift_report,
                                   predict_features, resolve_drift, spearman)
from repro_torch.obs.export import (export_chrome_trace, load_chrome_trace,
                                    to_chrome_events, validate_chrome_trace)
from repro_torch.obs.exporter import (MetricFamily, MetricsHTTPServer, Sample,
                                      export_metrics_at_exit, flatten_report,
                                      parse_openmetrics, registry_families,
                                      render_openmetrics,
                                      validate_openmetrics, write_openmetrics)
from repro_torch.obs.health import SLO, STATES, HealthMonitor
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.sentinel import DriftSentinel, SentinelPolicy
from repro_torch.obs.tracer import (TRACE_ENV, Event, Tracer, get_tracer,
                                    install, maybe_span, resolve_tracer,
                                    uninstall)

__all__ = [
    "Event", "Tracer", "install", "uninstall", "get_tracer",
    "resolve_tracer", "maybe_span", "TRACE_ENV",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "to_chrome_events", "export_chrome_trace", "load_chrome_trace",
    "validate_chrome_trace",
    "DriftLog", "DriftRow", "default_drift_path", "drift_report",
    "predict_features", "resolve_drift", "spearman", "DRIFT_ENV",
    "Sample", "MetricFamily", "registry_families", "render_openmetrics",
    "parse_openmetrics", "validate_openmetrics", "MetricsHTTPServer",
    "write_openmetrics", "export_metrics_at_exit", "flatten_report",
    "SLO", "STATES", "HealthMonitor",
    "DriftSentinel", "SentinelPolicy",
]

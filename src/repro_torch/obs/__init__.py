"""``repro_torch.obs``: the serving telemetry of the port.

Port of ``repro.obs`` (pure Python, the port's own copy). Four layers,
one bundle:

  * :mod:`repro_torch.obs.metrics`: counters / gauges / fixed-bucket
    histograms with streaming percentiles; Prometheus text and the JSON
    artifact envelope;
  * :mod:`repro_torch.obs.tracing`: step-level spans and per-request
    lifecycle events, exported as Chrome ``trace_event`` JSON
    (Perfetto-loadable), yielding *measured* TTFT / inter-token latencies;
  * :mod:`repro_torch.obs.drift`: the model-vs-measured table of the
    decode tick against ``core.perf_model``;
  * :class:`Telemetry`: the bundle ``LLMEngine`` threads. The default is
    :data:`NULL_TELEMETRY`: shared no-op instruments, a shared no-op span
    and a no-op drift collector, so an engine with telemetry off allocates
    no telemetry objects per step.

Usage::

    from repro_torch.obs import Telemetry
    tel = Telemetry.create()
    engine = LLMEngine(cfg, params, telemetry=tel)
    ...
    print(tel.metrics.render_prometheus())
    tel.tracer.write_chrome_trace("artifacts/torch/serve_trace.json")
    print(tel.drift.report(engine.drift_model_fn()).render())
"""

from __future__ import annotations

import dataclasses

from repro_torch.obs.drift import DriftCollector, DriftReport, NullDriftCollector
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullRegistry,
    write_json_artifact,
)
from repro_torch.obs.tracing import NullTracer, SpanRecord, Tracer

__all__ = [
    "Counter", "DriftCollector", "DriftReport", "Gauge", "Histogram",
    "MetricsRegistry", "NULL_TELEMETRY", "NullDriftCollector",
    "NullRegistry", "NullTracer", "SpanRecord", "Telemetry", "Tracer",
    "write_json_artifact",
]


@dataclasses.dataclass(frozen=True)
class Telemetry:
    """The bundle the serving path threads: metrics + tracer + drift."""

    metrics: MetricsRegistry
    tracer: Tracer
    drift: DriftCollector

    @property
    def enabled(self) -> bool:
        return self.metrics.enabled

    @classmethod
    def create(cls) -> "Telemetry":
        """A live (recording) telemetry bundle."""
        return cls(MetricsRegistry(), Tracer(), DriftCollector())

    @classmethod
    def disabled(cls) -> "Telemetry":
        """The shared no-op bundle (:data:`NULL_TELEMETRY`)."""
        return NULL_TELEMETRY

    def reset(self) -> None:
        """Zero metrics, drop spans/events/drift samples in place —
        instrument identity survives, so pre-bound references stay live
        (a load harness resets after warmup without rebuilding)."""
        self.metrics.reset()
        self.tracer.reset()
        self.drift.reset()


#: The module-wide disabled bundle every un-instrumented engine shares.
NULL_TELEMETRY = Telemetry(NullRegistry(), NullTracer(), NullDriftCollector())

"""Dependency-free metrics registry: counters, gauges, histograms.

Port of ``repro.obs.metrics``, pure Python, so the port keeps its own copy:
a small instrument registry the serving path updates at decode rates
without labels, dicts or allocation on the hot path.

Design contract:

  * **Pre-bound instruments.** ``registry.counter(name)`` /
    ``gauge(name)`` / ``histogram(name)`` are *registration* calls, run
    once at construction time, returning the instrument object. Hot-loop
    code holds the instrument and calls ``.inc()`` / ``.set()`` /
    ``.observe()``; it never looks an instrument up per step
    (``tests/test_torch_obs.py`` applies the JAX linter's
    ``obs-no-hot-loop-allocs`` rule to ``repro_torch/serving``).
  * **Zero-cost when disabled.** :class:`NullRegistry` returns the same
    shared no-op singletons from every registration call, so a disabled
    engine threads real-looking instruments whose methods do nothing and
    allocates no metric objects per step.
  * **Mergeable histograms.** Fixed boundaries mean two histograms (two
    engines, two runs) merge by adding bucket counts: associative and
    order-independent.

Export surfaces: ``snapshot()`` (plain dicts, JSON-safe),
``render_prometheus()`` (text exposition), and
:func:`write_json_artifact`, the one artifact envelope (schema
``"repro.obs/v1"``, the JAX package's, so one reader takes both packages'
artifacts). The port's default artifact directory is ``artifacts/torch/``
(git-ignored), never the JAX package's ``artifacts/benchmarks/``.
"""

from __future__ import annotations

import bisect
import json
import math
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "ARTIFACT_SCHEMA",
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_BOUNDARIES",
    "MetricsRegistry",
    "NULL_COUNTER",
    "NULL_GAUGE",
    "NULL_HISTOGRAM",
    "NullRegistry",
    "write_json_artifact",
]

#: Default histogram boundaries for second-scale serving latencies:
#: ~exponential from 10us to 100s, dense around the ms-to-s band where
#: decode steps and TTFT live.
LATENCY_BOUNDARIES: Tuple[float, ...] = tuple(
    b * s
    for s in (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)
    for b in (1.0, 2.0, 5.0)
) + (100.0,)


class Counter:
    """Monotone counter. ``inc`` is the only mutator."""

    __slots__ = ("name", "help", "value")
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        self.value += n

    def snapshot(self) -> Dict:
        return {"type": "counter", "value": self.value}

    def reset(self) -> None:
        self.value = 0.0


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "help", "value")
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def snapshot(self) -> Dict:
        return {"type": "gauge", "value": self.value}

    def reset(self) -> None:
        self.value = 0.0


class Histogram:
    """Fixed-boundary histogram with streaming percentile estimates.

    ``boundaries`` are cumulative upper edges (Prometheus ``le``
    semantics: bucket ``i`` counts observations ``v <= boundaries[i]``,
    with an implicit ``+Inf`` overflow bucket). Tracking ``min``/``max``
    alongside the counts tightens :meth:`quantile`'s interpolation at the
    distribution's edges — the first bucket interpolates from the
    observed min, the overflow bucket up to the observed max — so exact
    quantiles on in-range data are recovered to within one bucket width.

    Histograms with identical boundaries :meth:`merge` by adding counts:
    associative, commutative, and equal to observing the union stream.
    """

    __slots__ = ("name", "help", "boundaries", "counts", "sum", "count",
                 "min", "max")
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 boundaries: Optional[Sequence[float]] = None):
        bs = tuple(float(b) for b in (boundaries or LATENCY_BOUNDARIES))
        if list(bs) != sorted(set(bs)):
            raise ValueError(
                f"histogram {name}: boundaries must be strictly increasing"
            )
        self.name = name
        self.help = help
        self.boundaries = bs
        self.counts = [0] * (len(bs) + 1)  # last slot = +Inf overflow
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.boundaries, v)] += 1
        self.sum += v
        self.count += 1
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Streaming estimate of the ``q``-quantile by linear
        interpolation inside the holding bucket (clamped to the observed
        min/max, which makes single-bucket and edge cases exact)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = self.boundaries[i - 1] if i > 0 else self.min
                hi = self.boundaries[i] if i < len(self.boundaries) else self.max
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                if hi <= lo:
                    return lo
                frac = (rank - seen) / c
                return lo + frac * (hi - lo)
            seen += c
        return self.max  # pragma: no cover - rank <= count always lands

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into ``self`` (same boundaries required)."""
        if self.boundaries != other.boundaries:
            raise ValueError(
                f"cannot merge histograms {self.name} / {other.name}: "
                "boundary mismatch"
            )
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def snapshot(self) -> Dict:
        cum, buckets = 0, {}
        for i, b in enumerate(self.boundaries):
            cum += self.counts[i]
            buckets[repr(b)] = cum
        buckets["+Inf"] = cum + self.counts[-1]
        return {
            "type": "histogram",
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
            "buckets": buckets,
        }

    def reset(self) -> None:
        self.counts = [0] * (len(self.boundaries) + 1)
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf


class MetricsRegistry:
    """Name -> instrument map with idempotent registration.

    Registering the same name twice returns the existing instrument (so
    layers can share counters without plumbing); registering it as a
    different kind is a programming error and raises.
    """

    enabled = True

    def __init__(self):
        self._instruments: "Dict[str, object]" = {}

    def _register(self, cls, name: str, help: str, **kw):
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name, help, **kw)
            self._instruments[name] = inst
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as {inst.kind}, "
                f"requested {cls.kind}"
            )
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  boundaries: Optional[Sequence[float]] = None) -> Histogram:
        return self._register(Histogram, name, help, boundaries=boundaries)

    def snapshot(self) -> Dict[str, Dict]:
        """Plain-dict view of every instrument (JSON-safe)."""
        return {n: i.snapshot() for n, i in sorted(self._instruments.items())}

    def reset(self) -> None:
        """Zero every instrument in place (instrument identity survives —
        pre-bound references stay valid, which is the point: a load
        harness resets after warmup without rebuilding the engine)."""
        for inst in self._instruments.values():
            inst.reset()

    def render_prometheus(self) -> str:
        """Prometheus text exposition (``# HELP`` / ``# TYPE`` + samples)."""
        lines: List[str] = []
        for name, inst in sorted(self._instruments.items()):
            pname = _prom_name(name)
            if inst.help:
                lines.append(f"# HELP {pname} {inst.help}")
            lines.append(f"# TYPE {pname} {inst.kind}")
            if isinstance(inst, Histogram):
                cum = 0
                for i, b in enumerate(inst.boundaries):
                    cum += inst.counts[i]
                    lines.append(f'{pname}_bucket{{le="{b:g}"}} {cum}')
                lines.append(
                    f'{pname}_bucket{{le="+Inf"}} {cum + inst.counts[-1]}'
                )
                lines.append(f"{pname}_sum {inst.sum:g}")
                lines.append(f"{pname}_count {inst.count}")
            else:
                lines.append(f"{pname} {inst.value:g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write_json(self, path: str, extra: Optional[Dict] = None) -> str:
        """Write this registry's snapshot as a schema'd JSON artifact."""
        return write_json_artifact(
            os.path.splitext(os.path.basename(path))[0],
            payload=extra, metrics=self,
            dirpath=os.path.dirname(os.path.abspath(path)),
        )


def _prom_name(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


# -----------------------------------------------------------------------------
# No-op instruments: the disabled path allocates nothing per step
# -----------------------------------------------------------------------------


class _NullCounter(Counter):
    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass


class _NullGauge(Gauge):
    __slots__ = ()

    def set(self, v: float) -> None:
        pass

    def inc(self, n: float = 1.0) -> None:
        pass


class _NullHistogram(Histogram):
    __slots__ = ()

    def observe(self, v: float) -> None:
        pass


#: Shared no-op singletons: every registration on a :class:`NullRegistry`
#: returns one of these, so disabled telemetry binds real-looking
#: instruments without ever allocating per engine, let alone per step.
NULL_COUNTER = _NullCounter("null")
NULL_GAUGE = _NullGauge("null")
NULL_HISTOGRAM = _NullHistogram("null", boundaries=(1.0,))


class NullRegistry(MetricsRegistry):
    """Disabled registry: hands out the shared no-op singletons."""

    enabled = False

    def counter(self, name: str, help: str = "") -> Counter:
        return NULL_COUNTER

    def gauge(self, name: str, help: str = "") -> Gauge:
        return NULL_GAUGE

    def histogram(self, name: str, help: str = "",
                  boundaries: Optional[Sequence[float]] = None) -> Histogram:
        return NULL_HISTOGRAM

    def snapshot(self) -> Dict[str, Dict]:
        return {}

    def render_prometheus(self) -> str:
        return ""


# -----------------------------------------------------------------------------
# The one artifact schema
# -----------------------------------------------------------------------------

ARTIFACT_SCHEMA = "repro.obs/v1"

#: Default artifact root: ``artifacts/torch/`` of the checkout, apart from
#: the JAX package's committed ``artifacts/benchmarks/``.
_DEFAULT_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "artifacts", "torch"
)


def write_json_artifact(
    name: str,
    payload=None,
    *,
    metrics: Optional[MetricsRegistry] = None,
    dirpath: Optional[str] = None,
    kind: str = "benchmark",
) -> str:
    """Write ``<dirpath>/<name>.json`` (default ``artifacts/torch/``) in
    the uniform envelope.

    The load harness emits through this one function,
    so downstream tooling can read any artifact without per-file schema
    knowledge: ``{"schema", "name", "kind", "created_unix", "payload",
    "metrics"}`` where ``metrics`` is a registry snapshot (empty when no
    registry is passed). Returns the absolute path written.
    """
    dirpath = os.path.abspath(dirpath or _DEFAULT_DIR)
    os.makedirs(dirpath, exist_ok=True)
    path = os.path.join(dirpath, f"{name}.json")
    doc = {
        "schema": ARTIFACT_SCHEMA,
        "name": name,
        "kind": kind,
        "created_unix": time.time(),
        "payload": payload,
        "metrics": metrics.snapshot() if metrics is not None else {},
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, default=str)
    return path

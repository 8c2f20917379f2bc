"""Step-level tracing: engine spans + per-request lifecycle events.

Port of ``repro.obs.tracing``. Two record streams, one tracer:

  * **Spans** — nested wall-clock intervals around the serving phases
    (``step`` > ``schedule`` / ``flush`` / ``decode``), recorded by the
    ``LLMEngine.step`` instrumentation. Nesting is positional: a span
    opened while another is live gets ``depth = parent.depth + 1``.
  * **Request lifecycle events** — instants on a request's timeline
    (``arrival -> admitted -> first_token -> ... -> finish``, with
    ``preempt`` / ``resume`` in between and one ``tokens`` event per
    streamed emission). These give *measured* TTFT and inter-token
    latencies (the numbers ``SchedulerStats.modeled_tok_s`` only
    predicts) via :meth:`Tracer.request_latencies`. Times are host-clock
    readings: on the card the engine closes each span after a host read of
    the device work it times.

Export is Chrome ``trace_event`` JSON (:meth:`Tracer.to_chrome_trace`),
loadable in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``:
engine spans on one track, each request as an async (``b``/``e``) slice
with its lifecycle instants riding on it.

:class:`NullTracer` is the disabled path: ``span()`` returns one shared
no-op context manager and the event methods do nothing, so a disabled
engine records no span objects per step.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["NULL_SPAN", "NullTracer", "SpanRecord", "Tracer"]

#: Request lifecycle event names, in their only legal order of first
#: occurrence (``preempt``/``resume``/``tokens`` may repeat).
ARRIVAL = "arrival"
ADMITTED = "admitted"
RESUME = "resume"
PREEMPT = "preempt"
FIRST_TOKEN = "first_token"
TOKENS = "tokens"
FINISH = "finish"


@dataclasses.dataclass
class SpanRecord:
    """One closed span: ``[t0, t1)`` seconds on the tracer's clock."""

    name: str
    t0: float
    t1: float
    depth: int
    args: Dict

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class _Span:
    """Context manager recording one span; created per ``span()`` call
    (only when tracing is enabled — the null path shares one no-op)."""

    __slots__ = ("_tracer", "name", "args", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, args: Dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        self._depth = len(self._tracer._stack)
        self._tracer._stack.append(self)
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, *exc):
        t1 = self._tracer._clock()
        self._tracer._stack.pop()
        self._tracer.spans.append(
            SpanRecord(self.name, self._t0, t1, self._depth, self.args)
        )
        return False


class Tracer:
    """Span + lifecycle recorder with a Chrome ``trace_event`` exporter."""

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self._stack: List[_Span] = []
        self.spans: List[SpanRecord] = []
        #: uid -> [(event, t, args)] in record order.
        self.requests: Dict[int, List[Tuple[str, float, Dict]]] = {}
        #: free-form instants outside any request ((name, t, args)).
        self.instants: List[Tuple[str, float, Dict]] = []
        self.t_start = clock()

    # -- recording ---------------------------------------------------------

    def span(self, name: str, **args) -> _Span:
        """Context manager timing one phase; nests positionally."""
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        self.instants.append((name, self._clock(), args))

    def request_event(self, uid: int, event: str, **args) -> None:
        """Record one lifecycle instant for request ``uid``."""
        self.requests.setdefault(int(uid), []).append(
            (event, self._clock(), args)
        )

    def reset(self) -> None:
        """Drop recorded spans/events (a load harness resets after
        warmup); open spans and the clock origin survive."""
        self.spans.clear()
        self.requests.clear()
        self.instants.clear()
        self.t_start = self._clock()

    # -- derived latencies -------------------------------------------------

    def request_lifecycle(self, uid: int) -> List[Tuple[str, float, Dict]]:
        return list(self.requests.get(int(uid), ()))

    def request_latencies(self) -> Dict[int, Dict[str, object]]:
        """Measured per-request latencies from the lifecycle stream.

        Per uid: ``ttft`` (arrival -> first streamed token), ``e2e``
        (arrival -> finish), ``queue`` (arrival -> first admission), and
        ``itl`` — one interval per generated token after the first. A
        ``tokens`` emission carrying ``n`` tokens ``dt`` after the
        previous emission contributes ``n`` intervals of ``dt / n`` (the
        tick amortizes over the tokens it produced), so percentiles are
        per *token*, not per step. Requests missing an event (still
        running, never admitted) report ``None`` for the latencies that
        need it.
        """
        out: Dict[int, Dict[str, object]] = {}
        for uid, events in self.requests.items():
            first = {}
            for name, t, args in events:
                first.setdefault(name, t)
            arrival = first.get(ARRIVAL)
            ft = first.get(FIRST_TOKEN)
            fin = first.get(FINISH)
            adm = first.get(ADMITTED, first.get(RESUME))
            itl: List[float] = []
            prev = None
            for name, t, args in events:
                if name != TOKENS:
                    continue
                n = max(int(args.get("n", 1)), 1)
                if prev is not None:
                    itl.extend([(t - prev) / n] * n)
                elif n > 1:
                    # The first emission's extra tokens (beyond the very
                    # first token) still cost inter-token time ~0 within
                    # the tick; count them so token totals reconcile.
                    itl.extend([0.0] * (n - 1))
                prev = t
            def delta(a, b):
                # `is not None`, not truthiness: t == 0.0 is a real time.
                return (a - b) if (a is not None and b is not None) else None

            out[uid] = {
                "ttft": delta(ft, arrival),
                "e2e": delta(fin, arrival),
                "queue": delta(adm, arrival),
                "itl": itl,
                "preemptions": sum(1 for n, _, _ in events if n == PREEMPT),
            }
        return out

    # -- Chrome trace_event export ----------------------------------------

    def to_chrome_trace(self) -> Dict:
        """Chrome ``trace_event`` JSON (the dict; ``json.dump`` it or use
        :meth:`write_chrome_trace`). Engine spans are complete (``X``)
        events on tid 0; each request is an async ``b``/``e`` pair with
        its lifecycle instants, on its own tid so Perfetto lays requests
        out as parallel tracks."""
        base = self.t_start
        us = lambda t: round((t - base) * 1e6, 3)  # noqa: E731
        events: List[Dict] = [{
            "name": "process_name", "ph": "M", "pid": 1,
            "args": {"name": "repro_torch.serving.LLMEngine"},
        }, {
            "name": "thread_name", "ph": "M", "pid": 1, "tid": 0,
            "args": {"name": "engine loop"},
        }]
        for s in self.spans:
            events.append({
                "name": s.name, "cat": "engine", "ph": "X",
                "ts": us(s.t0), "dur": round(s.duration * 1e6, 3),
                "pid": 1, "tid": 0, "args": s.args,
            })
        for name, t, args in self.instants:
            events.append({
                "name": name, "cat": "engine", "ph": "i", "s": "p",
                "ts": us(t), "pid": 1, "tid": 0, "args": args,
            })
        for uid, evs in sorted(self.requests.items()):
            tid = uid + 1
            events.append({
                "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                "args": {"name": f"request {uid}"},
            })
            for name, t, args in evs:
                if name == ARRIVAL:
                    events.append({
                        "name": f"request {uid}", "cat": "request",
                        "ph": "b", "id": uid, "ts": us(t),
                        "pid": 1, "tid": tid, "args": args,
                    })
                elif name == FINISH:
                    events.append({
                        "name": f"request {uid}", "cat": "request",
                        "ph": "e", "id": uid, "ts": us(t),
                        "pid": 1, "tid": tid, "args": args,
                    })
                events.append({
                    "name": name, "cat": "lifecycle", "ph": "i", "s": "t",
                    "ts": us(t), "pid": 1, "tid": tid, "args": args,
                })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> str:
        """Write the Chrome trace JSON; returns the absolute path."""
        path = os.path.abspath(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


class _NullSpan:
    """The shared do-nothing context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


#: One instance serves every disabled ``span()`` call — the "no span
#: objects allocated per step" half of the telemetry-off contract.
NULL_SPAN = _NullSpan()


class NullTracer(Tracer):
    """Disabled tracer: shared no-op span, event methods do nothing."""

    enabled = False

    def span(self, name: str, **args):
        return NULL_SPAN

    def instant(self, name: str, **args) -> None:
        pass

    def request_event(self, uid: int, event: str, **args) -> None:
        pass

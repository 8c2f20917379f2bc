"""The port's ``repro_torch.obs`` and the engine's telemetry against the JAX
package's ``repro.obs`` and ``repro.serving.LLMEngine(telemetry=)``.

The same observation streams (numpy, seeded) go through both packages'
histograms, tracers (with one injected fake clock) and drift collectors,
and must give equal snapshots, quantiles, merges, Prometheus text, Chrome
traces, latencies and drift tables. Then both engines serve the same
requests on ``llama3_8b.SMOKE`` with the same weights, telemetry on, in
both KV layouts and under preemption: their counters, span sequences
(name, depth, args), lifecycle events (names and non-time args per uid)
and drift cells (keys, mean context, sample counts) must be equal, and the
greedy ids equal with telemetry on and off. The serving hot loop is held to
the JAX linter's ``obs-no-hot-loop-allocs`` rule.
"""

import asyncio
import pathlib

import jax
import numpy as np
import pytest

from repro import obs as jobs
from repro.analysis.lint import lint_source
from repro.configs import llama3_8b as jax_llama
from repro.models import transformer as jax_tf
from repro.obs import drift as jdrift
from repro.obs import metrics as jmetrics
from repro.obs import tracing as jtracing
from repro.serving import LLMEngine as JaxEngine
from repro.serving import Request as JaxRequest

from repro_torch import obs
from repro_torch.configs import llama3_8b
from repro_torch.models import transformer
from repro_torch.obs import drift, metrics, tracing
from repro_torch.serving import LLMEngine, Request

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _stream(seed=0, n=500):
    """Second-scale latencies spread over many buckets, plus values past
    the last boundary and on boundaries exactly."""
    rng = np.random.default_rng(seed)
    vals = np.exp(rng.uniform(np.log(1e-6), np.log(300.0), size=n))
    return [float(v) for v in vals] + [0.001, 0.5, 100.0, 250.0]


# -- metrics ---------------------------------------------------------------


def test_histogram_snapshot_quantiles_and_merge_equal_jax():
    vals = _stream()
    th, jh = metrics.Histogram("h", "help"), jmetrics.Histogram("h", "help")
    for v in vals:
        th.observe(v)
        jh.observe(v)
    assert th.snapshot() == jh.snapshot()
    for q in (0.5, 0.9, 0.99):
        assert th.quantile(q) == jh.quantile(q)
    # Merging two halves equals the whole stream, in both packages alike.
    parts = {}
    for name, mod in (("t", metrics), ("j", jmetrics)):
        a, b = mod.Histogram("a"), mod.Histogram("b")
        for i, v in enumerate(vals):
            (a if i % 3 else b).observe(v)
        parts[name] = a.merge(b)
    assert parts["t"].snapshot() == parts["j"].snapshot()
    # ... and holds the whole stream's counts (the sum only up to the order
    # of its additions).
    merged = parts["t"].snapshot()
    for key in ("count", "min", "max", "buckets"):
        assert merged[key] == th.snapshot()[key]
    assert merged["sum"] == pytest.approx(th.sum, rel=1e-12)
    with pytest.raises(ValueError):
        metrics.Histogram("x").merge(metrics.Histogram("y", boundaries=(1.0, 2.0)))


def test_registry_prometheus_text_equals_jax():
    vals = _stream(seed=1, n=64)
    texts, snaps = [], []
    for mod in (metrics, jmetrics):
        reg = mod.MetricsRegistry()
        c = reg.counter("serving_tokens_total", "tokens streamed")
        g = reg.gauge("serving_running", "active rows")
        h = reg.histogram("serving_step_seconds", "one step")
        for i, v in enumerate(vals):
            c.inc(i % 5)
            g.set(i)
            h.observe(v)
        assert reg.counter("serving_tokens_total") is c      # idempotent
        with pytest.raises(TypeError):
            reg.gauge("serving_tokens_total")
        texts.append(reg.render_prometheus())
        snaps.append(reg.snapshot())
    assert texts[0] == texts[1]
    assert snaps[0] == snaps[1]


def test_artifact_envelope_schema_and_default_dir(tmp_path):
    reg = metrics.MetricsRegistry()
    reg.counter("n").inc(3)
    path = metrics.write_json_artifact("x", {"a": 1}, metrics=reg, dirpath=str(tmp_path),
                                       kind="loadgen")
    import json

    env = json.load(open(path))
    assert env["schema"] == jmetrics.ARTIFACT_SCHEMA == "repro.obs/v1"
    assert env["kind"] == "loadgen" and env["payload"] == {"a": 1}
    assert env["metrics"]["n"]["value"] == 3.0
    # The port never writes into the JAX package's committed artifacts.
    default = pathlib.Path(metrics._DEFAULT_DIR).resolve()
    assert default == ROOT / "artifacts" / "torch"


# -- tracing ---------------------------------------------------------------


class _FakeClock:
    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.t = 100.0

    def __call__(self):
        self.t += float(self.rng.uniform(1e-4, 1e-2))
        return self.t


def _drive_tracer(tracer):
    """One seeded script of spans, instants and lifecycle events."""
    rng = np.random.default_rng(5)
    for step in range(6):
        with tracer.span("step"):
            with tracer.span("schedule"):
                pass
            uid = step % 3
            if step < 3:
                tracer.request_event(uid, "arrival", prompt_len=8 + step, priority=0)
                tracer.request_event(uid, "admitted", row=uid)
                with tracer.span("flush", rows=1):
                    pass
            with tracer.span("decode", batch=3, steps=int(rng.integers(1, 4))):
                pass
            for u in range(3):
                n = int(rng.integers(1, 4))
                if step == u:
                    tracer.request_event(u, "first_token")
                tracer.request_event(u, "tokens", n=n)
            if step == 4:
                tracer.request_event(1, "preempt", row=1, generated=5)
                tracer.request_event(1, "resume", row=2)
        tracer.instant("sync", step=step)
    for u in range(3):
        tracer.request_event(u, "finish", reason="length", tokens=9)


def test_tracer_chrome_trace_and_latencies_equal_jax():
    tt, jt = tracing.Tracer(clock=_FakeClock(3)), jtracing.Tracer(clock=_FakeClock(3))
    _drive_tracer(tt)
    _drive_tracer(jt)
    assert [(s.name, s.t0, s.t1, s.depth, s.args) for s in tt.spans] == \
        [(s.name, s.t0, s.t1, s.depth, s.args) for s in jt.spans]
    assert tt.request_latencies() == jt.request_latencies()
    tc, jc = tt.to_chrome_trace(), jt.to_chrome_trace()
    # The process is named after the package that wrote the trace.
    assert tc["traceEvents"][0]["args"] == {"name": "repro_torch.serving.LLMEngine"}
    tc["traceEvents"][0]["args"] = jc["traceEvents"][0]["args"]
    assert tc == jc
    assert {"X", "M", "i", "b", "e"} <= {e["ph"] for e in tc["traceEvents"]}
    tt.reset()
    assert tt.spans == [] and tt.requests == {} and tt.instants == []


# -- drift -----------------------------------------------------------------


def test_drift_report_and_render_equal_jax():
    rng = np.random.default_rng(9)
    samples = [(int(rng.integers(1, 9)), float(rng.uniform(1, 3000)),
                float(rng.uniform(1e-3, 5e-2)), int(rng.integers(0, 9)))
               for _ in range(200)]
    tcol, jcol = drift.DriftCollector(), jdrift.DriftCollector()
    for b, m, s, t in samples:
        tcol.record(b, m, s, ticks=t)
        jcol.record(b, m, s, ticks=t)
    assert tcol.num_samples == jcol.num_samples
    for model in (lambda b, m: 1e-6 * b + 1e-8 * m, lambda b, m: 0.0):
        tr, jr = tcol.report(model), jcol.report(model)
        assert tr.to_dict() == jr.to_dict()
        assert tr.render() == jr.render()
        assert tr.worst_ratio() == jr.worst_ratio()
    for n in (1, 2, 3, 100, 1000, 1025):
        assert drift.context_bucket(n) == jdrift.context_bucket(n)
    assert drift.DriftReport(rows=[]).render() == jdrift.DriftReport(rows=[]).render()


def test_null_singletons_are_shared():
    null = obs.NULL_TELEMETRY
    assert obs.Telemetry.disabled() is null and not null.enabled
    assert null.metrics.counter("a") is null.metrics.counter("b") is metrics.NULL_COUNTER
    assert null.metrics.gauge("a") is metrics.NULL_GAUGE
    assert null.metrics.histogram("a") is metrics.NULL_HISTOGRAM
    assert null.tracer.span("step") is null.tracer.span("decode", batch=1) is tracing.NULL_SPAN
    null.drift.record(1, 10.0, 1.0)
    null.tracer.request_event(0, "arrival")
    assert null.drift.num_samples == 0 and null.tracer.requests == {}
    assert null.metrics.snapshot() == {} and null.metrics.render_prometheus() == ""
    live = obs.Telemetry.create()
    assert live.enabled and live.metrics is not null.metrics


# -- the engines -----------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jparams = jax_tf.init_model(jax.random.PRNGKey(0), jax_llama.SMOKE)
    params = transformer.from_jax_params(jax.tree.map(np.asarray, jparams),
                                         llama3_8b.SMOKE, device="cpu")
    return jparams, params


#: ``tests/test_serving.py``'s telemetry workload, in each layout; its
#: page-pressure trace (a 17-page pool, which holds both rows: no preemption
#: fires); and ``tests/test_torch_engine.py``'s preemption trace (9 usable
#: pages, three rows that each grow to 4 pages).
ENGINES = {
    "dense": dict(kv_layout="dense", max_batch=2, cache_len=128, prompt_buckets=(16,)),
    "paged": dict(kv_layout="paged", max_batch=2, cache_len=128, prompt_buckets=(16,)),
    "pressure": dict(kv_layout="paged", num_pages=17, page_size=16, max_batch=2,
                     max_pages_per_seq=16, prompt_buckets=(16, 32), prefix_sharing=False),
    "preempt": dict(kv_layout="paged", num_pages=10, page_size=16, max_batch=3,
                    max_pages_per_seq=4, prompt_buckets=(16, 32)),
}


def _requests(case, req_cls):
    if case == "pressure":
        rng = np.random.default_rng(3)
        return [req_cls(uid=0, prompt=rng.integers(1, 400, size=(16,)), max_new_tokens=40,
                        priority=1),
                req_cls(uid=1, prompt=rng.integers(1, 400, size=(16,)), max_new_tokens=8)]
    if case == "preempt":
        rng = np.random.default_rng(4)
        return [req_cls(uid=i, prompt=rng.integers(1, 400, size=(20,)), max_new_tokens=30,
                        priority=i) for i in range(3)]
    rng = np.random.default_rng(2)
    return [req_cls(uid=i, prompt=rng.integers(1, 400, size=(8,)), max_new_tokens=4)
            for i in range(2)]


def _ids(outs):
    return {o.uid: [int(t) for t in o.tokens] for o in outs}


def _record(tel, eng, outs):
    snap = tel.metrics.snapshot()
    values = {k: v["value"] for k, v in snap.items() if v["type"] != "histogram"}
    counts = {k: v["count"] for k, v in snap.items() if v["type"] == "histogram"}
    spans = [(s.name, s.depth, s.args) for s in tel.tracer.spans]
    life = {uid: [(e, a) for e, _, a in evs] for uid, evs in tel.tracer.requests.items()}
    cells = [(r["batch"], r["ctx_bucket"], r["mean_len"], r["samples"])
             for r in tel.drift.report(lambda b, m: 1.0).rows]
    return dict(ids=_ids(outs), values=values, counts=counts, spans=spans, life=life,
                cells=cells)


@pytest.fixture(scope="module")
def served(models):
    """Each case served by both engines with telemetry on, and by the port's
    engine with telemetry off."""
    jparams, params = models
    out = {}
    for case, kw in ENGINES.items():
        jtel, ttel = jobs.Telemetry.create(), obs.Telemetry.create()
        jeng = JaxEngine(jax_llama.SMOKE, jparams, telemetry=jtel, **kw)
        teng = LLMEngine(llama3_8b.SMOKE, params, device="cpu", telemetry=ttel, **kw)
        off = LLMEngine(llama3_8b.SMOKE, params, device="cpu", **kw)
        rec = {"jax": _record(jtel, jeng, jeng.generate(_requests(case, JaxRequest))),
               "torch": _record(ttel, teng, teng.generate(_requests(case, Request))),
               "off": _ids(off.generate(_requests(case, Request)))}
        rec["stats"] = (teng.stats(), jeng.stats())
        rec["drift"] = (ttel.drift.report(teng.drift_model_fn()), teng.stats())
        rec["off_engine"] = off
        out[case] = rec
        for e in (teng, off):
            e.close()
    return out


@pytest.mark.parametrize("case", list(ENGINES))
def test_engine_telemetry_equals_jax(served, case):
    rec = served[case]
    j, t = rec["jax"], rec["torch"]
    assert t["ids"] == j["ids"]
    assert t["values"] == j["values"]
    assert t["counts"] == j["counts"]
    assert t["spans"] == j["spans"]
    assert t["life"] == j["life"]
    assert t["cells"] == j["cells"]
    # Telemetry changes no output.
    assert rec["off"] == t["ids"]
    total = sum(len(x) for x in t["ids"].values())
    assert t["values"]["serving_tokens_total"] == float(total)
    for uid, events in t["life"].items():
        names = [e for e, _ in events]
        assert names[0] == "arrival" and names[-1] == "finish"
    stats, jstats = rec["stats"]
    assert stats.preemptions == jstats.preemptions
    assert (stats.preemptions >= 1) == (case == "preempt")
    assert t["values"]["serving_preemptions_total"] == float(stats.preemptions)
    if case == "preempt":
        assert any(e == "preempt" for evs in t["life"].values() for e, _ in evs)
        assert any(e == "resume" for evs in t["life"].values() for e, _ in evs)


def test_engine_stats_and_drift_model(served):
    stats, jstats = served["dense"]["stats"]
    assert stats.tokens_generated == jstats.tokens_generated > 0
    assert stats.measured_tok_s > 0 and stats.modeled_tok_s > 0
    report, _ = served["paged"]["drift"]
    assert report.rows and report.worst_ratio() is not None
    for row in report.rows:
        assert row["samples"] > 0 and row["modeled_s"] > 0


def test_paged_decode_model_prices_the_pool(models):
    """``PagedBackend.decode_time_model`` prices the attention at the pool's
    byte width (codes: 1 byte), half-full sequences by default and the live
    mean context when given; fewer bytes never cost more."""
    _, params = models
    kw = dict(kv_layout="paged", max_batch=4, cache_len=256, num_pages=64,
              prompt_buckets=(16, 32), device="cpu")
    full = LLMEngine(llama3_8b.SMOKE, params, **kw)
    q8 = LLMEngine(llama3_8b.SMOKE, params, kv_dtype="int8", **kw)
    f, q = full.backend.decode_time_model, q8.backend.decode_time_model
    assert f(4) == f(4, mean_len=128) > 0
    assert f(4, mean_len=1) == f(4, mean_len=16)
    assert q(4) <= f(4) and q(4, mean_len=200) <= f(4, mean_len=200)
    assert full.drift_model_fn()(4, 200.0) == f(4, mean_len=200.0)
    for e in (full, q8):
        e.close()


def test_disabled_telemetry_binds_null_instruments(served):
    eng = served["dense"]["off_engine"]
    assert eng.telemetry is obs.NULL_TELEMETRY
    assert eng._m_steps is metrics.NULL_COUNTER
    assert eng._h_decode is metrics.NULL_HISTOGRAM
    assert eng._g_running is metrics.NULL_GAUGE
    assert eng._tr.span("step") is eng._tr.span("decode") is tracing.NULL_SPAN
    assert metrics.NULL_COUNTER.value == 0.0 and metrics.NULL_HISTOGRAM.count == 0
    assert eng.telemetry.tracer.spans == [] and eng.telemetry.drift.num_samples == 0


def test_reset_metrics_zeroes_telemetry_and_totals(models):
    _, params = models
    tel = obs.Telemetry.create()
    eng = LLMEngine(llama3_8b.SMOKE, params, device="cpu", telemetry=tel,
                    **ENGINES["paged"])
    steps = tel.metrics.counter("serving_steps_total")
    eng.generate(_requests("paged", Request))
    assert steps.value > 0 and eng.stats().tokens_generated > 0
    eng.reset_metrics()
    st = eng.stats()
    assert steps.value == 0.0 and tel.tracer.spans == [] and tel.drift.num_samples == 0
    assert st.tokens_generated == 0 and st.elapsed_s == 0.0 and st.decode_elapsed_s == 0.0
    assert tel.metrics.counter("serving_steps_total") is steps
    eng.close()


def test_two_concurrent_streams_reassemble_the_jax_ids(models, served):
    """Two ``stream()`` consumers on one engine, interleaved by asyncio,
    each see only their own increments, which join to the JAX engine's
    greedy ids."""
    _, params = models
    want = served["paged"]["jax"]["ids"]
    eng = LLMEngine(llama3_8b.SMOKE, params, device="cpu", detokenizer=lambda t: f"<{len(t)}>",
                    **ENGINES["paged"])
    reqs = _requests("paged", Request)

    async def consume(req):
        toks, texts, finished = [], [], 0
        async for out in eng.stream(req):
            assert out.uid == req.uid
            toks.extend(int(t) for t in out.new_tokens)
            texts.append(out.text)
            finished += out.finished
        return req.uid, toks, texts, finished

    async def both():
        return await asyncio.gather(*(consume(r) for r in reqs))

    got = asyncio.run(both())
    for uid, toks, texts, finished in got:
        assert toks == want[uid]
        assert finished == 1
        assert all(t.startswith("<") for t in texts)
    assert eng._stream_q == {}
    eng.close()


# -- the hot loop ------------------------------------------------------------


def test_serving_hot_loop_binds_instruments_once():
    """The JAX linter's ``obs-no-hot-loop-allocs`` rule matches only
    ``src/repro/serving``; here it runs on each of the port's serving files
    (as if it lived there), and fires on a planted lookup."""
    serving = ROOT / "src" / "repro_torch" / "serving"
    files = sorted(serving.glob("*.py"))
    assert {p.name for p in files} >= {"engine.py", "backends.py", "scheduler.py"}
    for path in files:
        got = lint_source(path.read_text(), f"src/repro/serving/{path.name}",
                          rules=["obs-no-hot-loop-allocs"])
        assert got == [], (path.name, got)
    src = (serving / "engine.py").read_text()
    bad = src.replace("        self._m_steps.inc()\n",
                      "        self.telemetry.metrics.counter(\"serving_steps_total\").inc()\n", 1)
    assert bad != src
    got = lint_source(bad, "src/repro/serving/engine.py", rules=["obs-no-hot-loop-allocs"])
    assert [v.rule for v in got] == ["obs-no-hot-loop-allocs"]

"""The port's load harness (``repro_torch.launch.loadgen``) against the JAX
package's ``repro.launch.loadgen``: the same seed gives the same Poisson
trace (arrivals, prompts, output budgets) and the same percentiles; one run
per KV layout on ``llama3_8b.SMOKE`` (``device="cpu"``) passes the harness's
smoke check; warm-up leaves no measured number behind; ``--smoke`` and
``--smoke-tiered`` keep their JAX meaning, and the unported mesh raises."""

import argparse
import json

import numpy as np
import pytest

from repro.configs import llama3_8b as jax_llama
from repro.launch import loadgen as jloadgen

from repro_torch.configs import llama3_8b
from repro_torch.launch import loadgen
from repro_torch.models import transformer
from repro_torch.obs import Telemetry
from repro_torch.serving import LLMEngine, Request, SamplingParams

#: The chip smoke's full-width mixes, beside the JAX harness's smoke mixes.
FULL_WIDTH = dict(prompt_mix=((128, 0.5), (384, 0.3), (768, 0.2)),
                  output_mix=((32, 0.6), (64, 0.3), (128, 0.1)), shared_prefix_len=256)


@pytest.mark.parametrize("kw", [dict(), dict(shared_fraction=0.0), FULL_WIDTH],
                         ids=["smoke", "unshared", "full_width"])
def test_build_workload_equals_jax(kw):
    for seed, n, rate in ((7, 32, 10.0), (0, 40, 4.0)):
        tw = loadgen.build_workload(llama3_8b.SMOKE, np.random.default_rng(seed), n,
                                    rate=rate, **kw)
        jw = jloadgen.build_workload(jax_llama.SMOKE, np.random.default_rng(seed), n,
                                     rate=rate, **kw)
        assert [t for t, _ in tw] == [t for t, _ in jw]
        for (_, a), (_, b) in zip(tw, jw):
            assert a.uid == b.uid
            assert np.array_equal(np.asarray(a.prompt), np.asarray(b.prompt))
            assert a.sampling.max_tokens == b.sampling.max_tokens
            assert a.sampling.temperature == b.sampling.temperature
    assert loadgen.PROMPT_MIX == jloadgen.PROMPT_MIX
    assert loadgen.OUTPUT_MIX == jloadgen.OUTPUT_MIX


def test_percentiles_equal_jax():
    rng = np.random.default_rng(1)
    for vals in ([float(i) for i in range(1, 101)], list(rng.exponential(0.02, size=333)),
                 [0.5], []):
        assert loadgen.percentiles(vals) == jloadgen.percentiles(vals)
    assert loadgen.percentiles([float(i) for i in range(1, 101)])["p90"] == pytest.approx(90.1)
    assert loadgen.safe_div(1.0, 0.0) == jloadgen.safe_div(1.0, 0.0) == 0.0


def _args(tmp_path, **kw):
    base = dict(arch="llama3-8b", smoke=True, kv_layout="dense", requests=4, rate=200.0,
                max_batch=2, cache_len=128, num_pages=96, page_size=16, shared_prefix=16,
                shared_fraction=0.5, temperature=0.0, seed=0, out_dir=str(tmp_path),
                device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_run_one_end_to_end(tmp_path, layout):
    """One small measured load per layout: every request finishes, the SLO
    percentiles and drift rows exist, and both artifacts land in
    ``out_dir`` with the JAX harness's schemas and names."""
    payload = loadgen.run_one(_args(tmp_path, kv_layout=layout), layout)
    loadgen._smoke_check(payload)
    assert payload["kv_layout"] == layout and payload["device"] == "cpu"
    assert payload["finished"] == 4
    assert payload["ttft_s"]["p99"] >= payload["ttft_s"]["p50"] > 0
    assert payload["ttft_sampled_s"]["p50"] > 0
    assert payload["decode_retraces_after_warmup"] == 0
    assert isinstance(payload["occupancy_cap"], int)
    assert 1 <= payload["occupancy_cap"] <= _args(tmp_path).max_batch
    assert payload["per_device"] is None
    if layout == "dense":
        assert payload["prefix"]["prefix_hit_rate"] is None
    for row in payload["drift"]["rows"]:
        assert row["samples"] > 0 and row["measured_p50_s"] > 0 and row["modeled_s"] > 0
    env = json.load(open(tmp_path / f"loadgen_{layout}.json"))
    assert env["schema"] == "repro.obs/v1" and env["kind"] == "loadgen"
    assert env["metrics"]["serving_finished_total"]["value"] == 4.0
    assert env["metrics"]["serving_tokens_total"]["value"] == payload["tokens_generated"]
    trace = json.load(open(tmp_path / f"loadgen_{layout}_trace.json"))
    tids = {e["tid"] for e in trace["traceEvents"] if e["ph"] == "b"}
    assert len(tids) == 4


def test_warmup_resets_measurement():
    """Warm-up pilots run, every decode program the run can reach is built,
    and then counters, spans and drift restart from zero while the
    instruments stay bound."""
    cfg = llama3_8b.SMOKE
    params = transformer.init_model(cfg, seed=0, device="cpu")
    tel = Telemetry.create()
    eng = LLMEngine(cfg, params, kv_layout="dense", max_batch=2, cache_len=128,
                    prompt_buckets=(16, 32, 64), telemetry=tel, steps_per_sync=8,
                    device="cpu")
    rng = np.random.default_rng(0)
    workload = loadgen.build_workload(cfg, rng, 3, rate=1000.0)
    loadgen._warmup(eng, cfg, rng, workload)
    assert tel.metrics.snapshot()["serving_steps_total"]["value"] == 0.0
    assert tel.tracer.spans == []
    assert tel.drift.num_samples == 0
    assert eng.stats().tokens_generated == 0
    assert set(eng.backend._programs) == {(1, 0), (2, 0), (4, 0), (8, 0)}
    traces = eng.backend.stats["decode_traces"]
    eng.generate([Request(uid=0, prompt=rng.integers(1, 400, size=(8,)),
                          sampling=SamplingParams(max_tokens=12))])
    assert tel.metrics.snapshot()["serving_steps_total"]["value"] > 0
    assert eng.backend.stats["decode_traces"] == traces
    eng.close()


def test_cli_smoke_and_tiered_smoke(tmp_path):
    """``--smoke`` (both layouts at steps_per_sync 1 and 8, three runs each:
    no program built after warm-up at 8, less host time per token than at
    1, the least of each side's runs) and ``--smoke-tiered`` with the JAX
    CI's arguments (demotions, no preemption, a leak-free close; arrivals on
    the engine's step clock, so the host's speed does not decide which
    requests meet) on the CPU."""
    loadgen.main(["--smoke", "--device", "cpu", "--out-dir", str(tmp_path)])
    overhead = json.load(open(tmp_path / "loadgen_host_overhead.json"))["payload"]
    for layout in ("dense", "paged"):
        assert overhead[layout]["n8"]["decode_retraces_after_warmup"] == 0
        assert (tmp_path / f"loadgen_{layout}_n8_trace.json").exists()
    loadgen.main(["--smoke", "--smoke-tiered", "--requests", "12", "--rate", "100",
                  "--num-pages", "24", "--page-size", "8", "--max-batch", "4",
                  "--shared-prefix", "16", "--shared-fraction", "1.0", "--device", "cpu",
                  "--out-dir", str(tmp_path)])
    env = json.load(open(tmp_path / "loadgen_tiered.json"))
    assert env["payload"]["prefix"]["demoted_pages"] > 0
    assert env["payload"]["preemptions"] == 0


def test_mesh_raises_naming_the_roadmap_item(tmp_path):
    for argv in (["--smoke", "--device", "cpu", "--mesh", "2"],
                 ["--smoke", "--device", "cpu", "--mesh-sweep", "1,2"]):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 6"):
            loadgen.main(argv + ["--out-dir", str(tmp_path)])

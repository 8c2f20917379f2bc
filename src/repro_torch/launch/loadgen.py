"""Trace-driven SLO load harness over the port's ``LLMEngine``.

Port of ``repro.launch.loadgen``, on one device. Open-loop load generation
with the telemetry of ``repro_torch.obs`` attached:

  * **Arrivals** are Poisson: exponential inter-arrival gaps at ``--rate``
    requests/s, summed into a wall-clock schedule. The harness releases each
    request when its arrival time passes, steps the engine while it has
    work, and sleeps toward the next arrival when idle, so queueing delay is
    measured, not simulated. ``--smoke-tiered`` releases them on the
    engine's step clock instead (each step advances it by ``TIERED_STEP_S``
    seconds, an idle engine jumps to the next arrival), so which requests
    meet in a batch does not depend on the host's speed: on the wall clock
    its preemption count depends on how fast the host steps the engine
    against 100 arrivals a second.
  * **Workload mix**: prompt tails and output budgets are drawn from
    weighted mixes, and a fraction of requests shares a system prefix
    (page-aligned, so the paged backend's prefix cache hits).
    :func:`build_workload` draws from the numpy ``Generator`` in the JAX
    package's order, so one seed gives the same trace in both packages.
  * **Warm-up**: a pilot batch runs to completion first, every fused-decode
    program the run can reach is built (on the card: its CUDA graph
    captured), ``torch.cuda.synchronize`` drains the card, and
    ``engine.reset_metrics()`` zeroes telemetry, so no measured number
    holds a capture. ``decode_retraces_after_warmup`` counts the programs
    built after it.
  * **SLO metrics**: TTFT / ITL / queue p50/p90/p99 from the tracer's
    lifecycle events (TTFT runs from arrival to the first *streamed* token,
    after the request's first decode sync, as in the JAX package;
    ``ttft_sampled_s`` is the engine's own TTFT, to the first token sampled
    at the prefill flush), measured decode tok/s beside the model's
    prediction (which prices the decode attention kernel only), preemption
    and prefix-hit counters, and the model-vs-measured drift table.
  * **Artifacts**: ``loadgen_<layout>[_nN].json`` (``loadgen_tiered`` for a
    host-tier run) in the ``repro.obs/v1`` envelope with the metrics
    snapshot, and ``<stem>_trace.json``, a Chrome ``trace_event`` file
    (https://ui.perfetto.dev), in ``--out-dir`` (default ``artifacts/torch``).

Not ported: the serving mesh (``--mesh N`` > 1 and ``--mesh-sweep`` raise
``NotImplementedError``, ROADMAP Queue A item 6).

Run:
  python -m repro_torch.launch.loadgen --smoke --device cpu
      # both KV layouts at steps_per_sync 1 and 8 on the smoke model
  python -m repro_torch.launch.loadgen --smoke-tiered --device cpu
  python -m repro_torch.launch.loadgen --arch llama3-8b --kv-layout paged \\
      --requests 64 --rate 4
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import perf_model
from repro_torch.models import transformer
from repro_torch.obs import Telemetry
from repro_torch.obs.metrics import write_json_artifact
from repro_torch.serving import LLMEngine, Request, SamplingParams

#: (value, weight) mixes the smoke/default workload draws from.
PROMPT_MIX: Tuple[Tuple[int, float], ...] = ((8, 0.5), (24, 0.3), (44, 0.2))
OUTPUT_MIX: Tuple[Tuple[int, float], ...] = ((4, 0.6), (8, 0.3), (12, 0.1))
#: The JAX harness's prompt buckets (``run_one``'s default).
PROMPT_BUCKETS: Tuple[int, ...] = (16, 32, 64)
#: Warm-up requests take uids from here up; measured uids stay below.
PILOT_UID = 10_000_000
#: ``--smoke-tiered``'s step clock: one engine step advances the arrival
#: clock by this many seconds (about one mean gap at the JAX CI's 100
#: requests/s), whatever the step's wall time.
TIERED_STEP_S = 0.01
#: ``--smoke`` runs each (layout, steps_per_sync) this many times and
#: compares the least host overhead per token of each: one run's residual
#: takes every stall the host scheduler adds to it.
SMOKE_RUNS = 3


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP Queue A item 6: distributed)")


def _draw(rng, mix) -> int:
    vals, weights = zip(*mix)
    w = np.asarray(weights, np.float64)
    return int(rng.choice(np.asarray(vals), p=w / w.sum()))


def build_workload(cfg, rng, n_requests: int, *, rate: float, prompt_mix=PROMPT_MIX,
                   output_mix=OUTPUT_MIX, shared_prefix_len: int = 16,
                   shared_fraction: float = 0.5,
                   temperature: float = 0.0) -> List[Tuple[float, Request]]:
    """Poisson-arrival request trace ``[(arrival_s, Request), ...]`` sorted
    by arrival. ``shared_fraction`` of requests start with one common system
    prefix of ``shared_prefix_len`` tokens (page-align it to the backend's
    page size so prefix sharing can hit)."""
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    arrivals = np.cumsum(gaps)
    system = rng.integers(1, cfg.vocab, size=(shared_prefix_len,))
    out: List[Tuple[float, Request]] = []
    for i in range(n_requests):
        tail_len = _draw(rng, prompt_mix)
        tail = rng.integers(1, cfg.vocab, size=(tail_len,))
        if shared_prefix_len and rng.random() < shared_fraction:
            prompt = np.concatenate([system, tail])
        else:
            prompt = tail
        out.append((float(arrivals[i]), Request(
            uid=i, prompt=prompt,
            sampling=SamplingParams(temperature=temperature,
                                    max_tokens=_draw(rng, output_mix)),
        )))
    return out


def safe_div(num: float, den: float) -> float:
    return num / den if den else 0.0


def percentiles(values, qs=(50, 90, 99)) -> Dict[str, Optional[float]]:
    if not values:
        return {f"p{q}": None for q in qs}
    arr = np.asarray(values, np.float64)
    return {f"p{q}": float(np.percentile(arr, q)) for q in qs}


def _per_device_accounting(engine, cfg, done, peak_pages: int):
    """Per-device bandwidth and page accounting of a mesh run: None on one
    device, the only serving the port has (ROADMAP Queue A item 6)."""
    return None


def _decode_keys(engine: LLMEngine, workload) -> List[Tuple[int, int]]:
    """Every (ticks, stop width) program a run can reach: a sync runs a
    power of two of ticks up to ``steps_per_sync`` (fewer when its rows
    need fewer), at the stop width of its rows' widest stop list, rounded
    up to a power of two."""
    n = engine.steps_per_sync
    ticks = [1 << i for i in range(n.bit_length()) if 1 << i <= n]
    widths = {0}
    for _, req in workload:
        w = len(req.sampling.stop_token_ids)
        if w:
            widths.add(1 << (w - 1).bit_length())
    return [(t, w) for t in ticks for w in sorted(widths)]


def _warmup(engine: LLMEngine, cfg, rng, workload) -> None:
    """Run one pilot per distinct prompt length (shared-prefix and bare
    variants), build every decode program the run can reach, drain the
    card, zero telemetry."""
    pilots = []
    seen = set()
    for i, (_, req) in enumerate(workload):
        key = len(req.prompt)
        if key in seen:
            continue
        seen.add(key)
        pilots.append(Request(uid=PILOT_UID + i, prompt=np.array(req.prompt),
                              sampling=SamplingParams(max_tokens=2)))
    engine.generate(pilots)
    for key in _decode_keys(engine, workload):
        engine.backend.prepare_decode(*key)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    # Pilots stay in the completion history (uids >= PILOT_UID), but every
    # measured counter, span and drift sample restarts here.
    engine.reset_metrics()


def drive(engine: LLMEngine, workload, *, idle_sleep_cap: float = 0.01, on_step=None,
          step_s: Optional[float] = None):
    """Open-loop drive: release requests at their arrival times, step while
    the engine has work, sleep toward the next arrival when idle. Returns
    the finished ``RequestOutput`` list. ``on_step(engine)`` runs after
    every step. With ``step_s`` the arrival clock is the engine's steps,
    ``step_s`` seconds each (an idle engine jumps to the next arrival), not
    the wall clock."""
    pending = sorted(workload, key=lambda a: a[0])
    done = []
    i = 0
    t0 = time.perf_counter()
    clock = 0.0
    while i < len(pending) or engine.backend.active.any() or engine.scheduler.has_work():
        now = clock if step_s is not None else time.perf_counter() - t0
        while i < len(pending) and pending[i][0] <= now:
            engine.add_request(pending[i][1])
            i += 1
        if not engine.backend.active.any() and not engine.scheduler.has_work():
            if step_s is not None:
                clock = pending[i][0]
            else:
                time.sleep(min(max(pending[i][0] - now, 0.0), idle_sleep_cap))
            continue
        done.extend(o for o in engine.step() if o.finished)
        if step_s is not None:
            clock += step_s
        if on_step is not None:
            on_step(engine)
    return done


def run_one(args, kv_layout: str, *, cfg=None, params=None, prompt_mix=PROMPT_MIX,
            output_mix=OUTPUT_MIX, prompt_buckets=PROMPT_BUCKETS) -> Dict:
    """One load run on one KV layout; returns the summary payload (also
    written to ``<out_dir>/loadgen_<kv_layout>.json``). ``cfg`` overrides the
    registry lookup and ``params`` the seeded ``init_model`` (the weights
    must lie on ``args.device``); the mixes and buckets default to the JAX
    harness's smoke values."""
    if int(getattr(args, "mesh", 0) or 0) > 1:
        raise _not_ported("--mesh")
    if cfg is None:
        cfg = (registry.get_smoke_config if args.smoke else registry.get_config)(args.arch)
    device = getattr(args, "device", "cuda") or "cuda"
    steps = getattr(args, "steps_per_sync", 1)
    if steps != "auto":
        steps = int(steps)
    kv_dtype = getattr(args, "kv_dtype", "fp32") or "fp32"
    host_pool = int(getattr(args, "host_pool_bytes", 0) or 0)
    step_s = getattr(args, "arrival_step_s", None)
    if params is None:
        params = transformer.init_model(cfg, seed=args.seed, device=device)
    telemetry = Telemetry.create()
    engine = LLMEngine(
        cfg, params,
        kv_layout=kv_layout,
        max_batch=args.max_batch,
        cache_len=args.cache_len,
        num_pages=args.num_pages,
        page_size=args.page_size,
        prompt_buckets=tuple(prompt_buckets),
        telemetry=telemetry,
        steps_per_sync=steps,
        kv_dtype=kv_dtype,
        host_pool_bytes=host_pool or None,
        device=device,
    )
    rng = np.random.default_rng(args.seed)
    workload = build_workload(
        cfg, rng, args.requests, rate=args.rate, prompt_mix=prompt_mix,
        output_mix=output_mix, shared_prefix_len=args.shared_prefix,
        shared_fraction=args.shared_fraction, temperature=args.temperature,
    )
    _warmup(engine, cfg, rng, workload)
    traces_warm = engine.backend.stats["decode_traces"]

    peak = {"pages": 0}

    def _sample(eng):
        pool = getattr(eng.backend, "pool", None)
        if pool is not None:
            peak["pages"] = max(peak["pages"], int(pool.used_pages))

    t0 = time.perf_counter()
    done = drive(engine, workload, on_step=_sample, step_s=step_s)
    wall = time.perf_counter() - t0
    retraces = engine.backend.stats["decode_traces"] - traces_warm

    lat = telemetry.tracer.request_latencies()
    measured = {uid: d for uid, d in lat.items() if uid < PILOT_UID}
    ttft = [d["ttft"] for d in measured.values() if d["ttft"] is not None]
    queue = [d["queue"] for d in measured.values() if d["queue"] is not None]
    itl = [x for d in measured.values() for x in d["itl"]]
    sampled = [engine.ttft[o.uid] for o in done if o.uid in engine.ttft]
    stats = engine.stats()
    prefix = engine.backend.prefix_stats()
    drift = telemetry.drift.report(engine.drift_model_fn())

    # Per-token host overhead: the step residual (step wall minus its
    # schedule / flush / decode phases) over the tokens produced; the
    # once-per-sync cost the fused N-tick decode amortizes.
    snap = telemetry.metrics.snapshot()
    host_overhead = safe_div(
        stats.elapsed_s - stats.decode_elapsed_s
        - snap["serving_flush_seconds"]["sum"]
        - snap["serving_schedule_seconds"]["sum"],
        stats.tokens_generated,
    )
    payload = {
        "arch": args.arch,
        "smoke": bool(args.smoke),
        "device": str(engine.device),
        "kv_layout": engine.kv_layout,
        "requests": args.requests,
        "finished": len(done),
        "rate_req_s": args.rate,
        "arrival_clock": "wall" if step_s is None else f"engine steps of {step_s} s",
        "wall_s": wall,
        "steps_per_sync": engine.steps_per_sync,
        "tokens_generated": stats.tokens_generated,
        "measured_tok_s": stats.measured_tok_s,
        "modeled_tok_s": stats.modeled_tok_s,
        "decode_elapsed_s": stats.decode_elapsed_s,
        "host_overhead_per_token_s": host_overhead,
        "modeled_host_overhead_s": perf_model.amortized_host_overhead(engine.steps_per_sync),
        "decode_retraces_after_warmup": retraces,
        "ttft_s": percentiles(ttft),
        "ttft_sampled_s": percentiles(sampled),
        "itl_s": percentiles(itl),
        "queue_s": percentiles(queue),
        "preemptions": stats.preemptions,
        "resumed_tokens": stats.resumed_tokens,
        "prefix": prefix,
        "occupancy_cap": stats.occupancy_cap,
        "drift": drift.to_dict(),
        "drift_worst_ratio": drift.worst_ratio(),
        "mesh_devices": 1,
        "per_device": _per_device_accounting(engine, cfg, done, peak["pages"]),
    }
    out_dir = args.out_dir or None
    n = engine.steps_per_sync
    stem = f"loadgen_{engine.kv_layout}" + (f"_n{n}" if n > 1 else "")
    if host_pool:
        stem = "loadgen_tiered"
    json_path = write_json_artifact(stem, payload, metrics=telemetry.metrics, dirpath=out_dir,
                                    kind="loadgen")
    trace_dir = out_dir or os.path.dirname(json_path)
    trace_path = telemetry.tracer.write_chrome_trace(
        os.path.join(trace_dir, f"{stem}_trace.json"))
    payload["_artifacts"] = {"json": json_path, "trace": trace_path}

    def ms(d):
        return " / ".join("n/a" if d[f"p{q}"] is None else f"{d[f'p{q}'] * 1e3:.1f}ms"
                          for q in (50, 90, 99))

    print(f"[loadgen:{engine.kv_layout}] {len(done)}/{args.requests} finished in "
          f"{wall:.2f}s at rate {args.rate}/s (steps_per_sync={engine.steps_per_sync}, "
          f"{engine.device})")
    print(f"  host overhead {host_overhead * 1e6:.1f}us/token (modeled "
          f"{payload['modeled_host_overhead_s'] * 1e6:.1f}us), {retraces} decode retraces "
          "after warmup")
    print(f"  TTFT p50/p90/p99: {ms(payload['ttft_s'])} (to the first streamed token; "
          f"to the first sampled token {ms(payload['ttft_sampled_s'])})")
    print(f"  ITL  p50/p90/p99: {ms(payload['itl_s'])}")
    print(f"  queue p50/p90/p99: {ms(payload['queue_s'])}")
    print(f"  measured {stats.measured_tok_s:.1f} tok/s (decode wall "
          f"{stats.decode_elapsed_s:.2f}s), modeled {stats.modeled_tok_s:.0f} tok/s "
          "(attention only)")
    hit = prefix.get("prefix_hit_rate")
    print(f"  preemptions {stats.preemptions} ({stats.resumed_tokens} tokens resumed), "
          f"prefix hit {'n/a' if hit is None else f'{hit:.2f}'}")
    print("  " + drift.render().replace("\n", "\n  "))
    print(f"  wrote {json_path}")
    print(f"  wrote {trace_path} (open in https://ui.perfetto.dev)")
    engine.close()
    return payload


def _smoke_check(payload: Dict) -> None:
    """Acceptance of one layout's run."""
    assert payload["finished"] == payload["requests"], payload
    assert payload["ttft_s"]["p50"] is not None, "no TTFT measured"
    assert payload["itl_s"]["p99"] is not None, "no ITL measured"
    assert payload["measured_tok_s"] > 0, "no measured throughput"
    assert payload["drift"]["rows"], "no drift cells recorded"
    with open(payload["_artifacts"]["trace"]) as f:
        trace = json.load(f)
    assert trace["traceEvents"], "empty Chrome trace"
    phases = {e["ph"] for e in trace["traceEvents"]}
    assert {"X", "M", "i", "b", "e"} <= phases, phases
    with open(payload["_artifacts"]["json"]) as f:
        env = json.load(f)
    assert env["schema"] == "repro.obs/v1", env["schema"]
    assert env["metrics"]["serving_steps_total"]["value"] > 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="smoke model, both KV layouts at steps_per_sync 1 and 8; "
                         "asserts artifacts + latency coverage")
    ap.add_argument("--kv-layout", choices=("auto", "dense", "paged"), default="auto")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=50.0, help="Poisson arrival rate, requests/s")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--num-pages", type=int, default=96)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--shared-prefix", type=int, default=16,
                    help="system-prompt tokens (page-aligned) shared by "
                         "--shared-fraction of requests")
    ap.add_argument("--shared-fraction", type=float, default=0.5)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--steps-per-sync", default="1",
                    help="decode ticks per host sync (an int, or 'auto')")
    ap.add_argument("--mesh", type=int, default=0,
                    help="serving mesh width; not ported (N > 1 raises)")
    ap.add_argument("--mesh-sweep", default="", help="device-count sweep; not ported (raises)")
    ap.add_argument("--kv-dtype", choices=("fp32", "int8", "fp8"), default="fp32",
                    help="paged pool storage (int8 / fp8 codes + per-page scales)")
    ap.add_argument("--host-pool-bytes", type=int, default=0,
                    help="host KV tier budget in bytes (0 = off); a tiered run writes "
                         "loadgen_tiered.json")
    ap.add_argument("--smoke-tiered", action="store_true",
                    help="one paged run with a device pool too small for the workload "
                         "plus a host tier; asserts demotions > 0 with zero preemptions "
                         "and a leak-free close")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=None, help="artifact directory (default artifacts/torch)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh_sweep:
        raise _not_ported("--mesh-sweep")

    if args.smoke_tiered:
        if not args.host_pool_bytes:
            args.host_pool_bytes = 1 << 20
        args.arrival_step_s = TIERED_STEP_S
        payload = run_one(args, "paged")
        _smoke_check(payload)
        pf = payload["prefix"]
        assert pf["demoted_pages"] > 0, pf
        assert payload["preemptions"] == 0, (
            "capacity pressure should resolve by demotion, not preemption",
            payload["preemptions"])
        print(f"[loadgen] tiered smoke OK: {int(pf['demoted_pages'])} demoted / "
              f"{int(pf['promoted_pages'])} promoted, 0 preemptions, leak-free close")
        return

    if args.smoke:
        # Both layouts x N in {1, 8}, each SMOKE_RUNS times: every run passes
        # the smoke checks; every N 8 run builds no program after warm-up;
        # the N 8 runs' least host time per token is below the N 1 runs'.
        sweep: Dict[str, Dict[int, Dict]] = {}
        runs: Dict[str, Dict[int, List[float]]] = {}
        for layout in ("dense", "paged"):
            sweep[layout], runs[layout] = {}, {}
            for n in (1, 8):
                args.steps_per_sync = n
                runs[layout][n] = []
                for _ in range(SMOKE_RUNS):
                    payload = run_one(args, layout)
                    _smoke_check(payload)
                    if n > 1:
                        assert payload["decode_retraces_after_warmup"] == 0, (
                            layout, n, payload["decode_retraces_after_warmup"])
                    runs[layout][n].append(payload["host_overhead_per_token_s"])
                    best = sweep[layout].get(n)
                    if best is None or (payload["host_overhead_per_token_s"]
                                        < best["host_overhead_per_token_s"]):
                        sweep[layout][n] = payload
            base, fused = sweep[layout][1], sweep[layout][8]
            assert fused["host_overhead_per_token_s"] < base["host_overhead_per_token_s"], (
                layout, runs[layout])
        overhead = {
            layout: {
                f"n{n}": {
                    "host_overhead_per_token_s": p["host_overhead_per_token_s"],
                    "host_overhead_per_token_s_runs": runs[layout][n],
                    "modeled_host_overhead_s": p["modeled_host_overhead_s"],
                    "measured_tok_s": p["measured_tok_s"],
                    "tokens_generated": p["tokens_generated"],
                    "decode_retraces_after_warmup": p["decode_retraces_after_warmup"],
                }
                for n, p in by_n.items()
            }
            for layout, by_n in sweep.items()
        }
        path = write_json_artifact("loadgen_host_overhead", overhead,
                                   dirpath=args.out_dir or None, kind="loadgen")
        print(f"[loadgen] wrote {path}")
        print("[loadgen] smoke OK (dense + paged, N in {1, 8})")
    else:
        run_one(args, args.kv_layout)


if __name__ == "__main__":
    main()

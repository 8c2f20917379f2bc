"""``LLMEngine``: the serving entry point of the port.

Port of ``repro.serving.engine.LLMEngine``: ``add_request`` /
``step() -> list[RequestOutput]`` continuous batching with streamed
increments, ``generate`` as the blocking loop, per-request sampling,
admission and preemption by ``serving.scheduler``, execution by
``serving.backends.DenseBackend`` or ``PagedBackend``. One ``step`` admits
and prefills, then runs one fused decode sync over the active rows:
``steps_per_sync`` ticks (an int >= 1, or ``"auto"``, which re-picks it
from the last sync's measured tick before each admission) with the host
reading results once, as one CUDA graph replay on the card; greedy outputs
equal the JAX engine's token for token (for SSM and hybrid models, where
the JAX engine's padded prefill leaks pad tokens into the recurrent
state, they equal the JAX package's unpadded prefill and decode; ROADMAP
Queue C).

``kv_layout="auto"`` (the default, as in the JAX package) serves models the
paged pool cannot hold (SSM and hybrid stacks) from dense stripes, and
ranks dense against paged for the rest with ``plan.resolve_kv_layout``.
``kv_dtype`` "int8" / "fp8" (quantized pages; "fp32" is the unquantized
pool in the compute dtype) and ``host_pool_bytes`` (a host KV tier) are
paged features: with ``kv_layout="auto"`` they resolve to paged, with
"dense" they raise ``ValueError``, as in the JAX package.

Observability is injected as in the JAX package
(``telemetry=repro_torch.obs.Telemetry.create()``): ``step()`` runs under
spans (``step`` holding ``schedule`` / ``flush`` / ``decode``), requests get
lifecycle events (arrival -> admitted -> first_token -> tokens ... ->
finish, with preempt / resume), each decode sync's wall time feeds the
model-vs-measured drift collector, and every instrument is bound once, at
construction. Spans close after a host read of the device work they time
(the first tokens' ``.cpu()`` in ``_flush``, the fused decode's results in
``backend.fused_decode``); nothing is recorded inside a CUDA graph. The
default ``NULL_TELEMETRY`` shares no-op singletons, so telemetry off
allocates nothing per step. Two TTFTs: the tracer's ``first_token``
(``request_latencies()["ttft"]``) is recorded when a request's first token
is streamed, after its first decode sync, as in the JAX engine; the
engine's own ``ttft`` dict stops when the first token is sampled, at the
prefill flush. ``stream()`` is the async push iterator over one request.

The JAX engine's ``mesh`` raises ``NotImplementedError`` naming the ROADMAP
item, never accepted and ignored.
"""

from __future__ import annotations

import asyncio
import time
import weakref
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.cache import quant
from repro_torch.cache.pool import OutOfPages
from repro_torch.configs.base import ModelConfig
from repro_torch.core import device as device_lib
from repro_torch.kernels import plan as plan_lib
from repro_torch.obs import NULL_TELEMETRY, Telemetry
from repro_torch.serving import sampling as sampling_lib
from repro_torch.serving.backends import DenseBackend, PagedBackend
from repro_torch.serving.request import (
    FINISH_LENGTH,
    FINISH_STOP,
    Request,
    RequestOutput,
    SamplingParams,
)
from repro_torch.serving.scheduler import Scheduler, SchedulerStats, safe_rate

__all__ = ["LLMEngine", "Request", "RequestOutput", "SamplingParams"]

KV_LAYOUTS = ("auto", "dense", "paged")


def _not_ported(option: str, item: str):
    return NotImplementedError(
        f"{option} is not ported to repro_torch yet (ROADMAP Queue A: {item})")


def _paged_supported(cfg: ModelConfig) -> bool:
    """Whether the paged pool can hold this model: pure self-attention
    stacks, single-codebook streams (mirrors ``init_paged_caches``)."""
    if cfg.num_codebooks != 1:
        return False
    return all(spec.kind == "attn" and not spec.cross_attn for spec in cfg.layer_specs())


class LLMEngine:
    """Serving engine over ``params`` (from ``transformer.init_model`` or
    ``transformer.from_jax_params``) on ``device`` (default ``cuda``).

    ``kv_layout="auto"`` resolves dense or paged (see the module
    docstring); ``"dense"`` / ``"paged"`` pin it. Capacity knobs:
    ``max_batch`` decode rows and a ``cache_len`` dense stripe, or
    ``num_pages`` x ``page_size`` pool with ``max_pages_per_seq`` (default
    ``cache_len // page_size``, clamped to the pool) for paged.
    ``prompt_buckets=None`` picks per-layout defaults. ``steps_per_sync``:
    decode ticks per host sync, an int >= 1 or ``"auto"``. ``kv_dtype``
    ("fp32", "int8", "fp8") and ``host_pool_bytes`` (0 / None: no host
    tier) configure the paged pool. ``telemetry``: a
    :class:`repro_torch.obs.Telemetry` (default ``NULL_TELEMETRY``, off)."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        kv_layout: str = "auto",
        max_batch: int = 8,
        cache_len: int = 2048,
        prompt_buckets=None,
        num_pages: int = 128,
        page_size: int = 16,
        max_pages_per_seq: Optional[int] = None,
        prefix_sharing: bool = True,
        reserve_pages: int = 1,
        batch_prefills: bool = True,
        mapping: Optional[str] = None,
        scheduler: Optional[Scheduler] = None,
        telemetry: Optional[Telemetry] = None,
        steps_per_sync=1,
        mesh=None,
        kv_dtype: str = "fp32",
        host_pool_bytes=None,
        detokenizer: Optional[Callable[[Sequence], str]] = None,
        device=None,
    ):
        if kv_layout not in KV_LAYOUTS:
            raise ValueError(f"kv_layout must be one of {KV_LAYOUTS}, got {kv_layout!r}")
        quant.validate_kv_dtype(kv_dtype)
        # Quantized pools and the host tier are paged features: force the
        # layout rather than drop the options where "auto" would pick dense.
        if kv_dtype != "fp32" or host_pool_bytes:
            if kv_layout == "dense":
                raise ValueError("kv_dtype / host_pool_bytes require the paged KV layout")
            kv_layout = "paged"
        if mesh is not None:
            raise _not_ported("mesh", "distributed")
        # "auto": the scheduler re-picks N before every admission round from
        # the last sync's measured tick (perf_model.choose_steps_per_sync),
        # powers of two only, so the graphs per engine stay O(log N).
        self._auto_steps = steps_per_sync == "auto"
        if self._auto_steps:
            steps_per_sync = 1
        elif not isinstance(steps_per_sync, int) or steps_per_sync < 1:
            raise ValueError(
                f"steps_per_sync must be a positive int or 'auto', got {steps_per_sync!r}")
        self.steps_per_sync = steps_per_sync
        self.device = device_lib.resolve(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params on {params['embed'].device}, engine on {self.device}")
        cfg = plan_lib.with_mapping(cfg, mapping)
        self.cfg = cfg
        if kv_layout == "auto":
            if not _paged_supported(cfg):
                kv_layout = "dense"
            else:
                pick = plan_lib.resolve_kv_layout(
                    (max_batch, cfg.n_heads, cfg.n_kv_heads, max(cache_len // 2, 1),
                     cfg.head_dim),
                    capacity=cache_len, page_size=page_size,
                    dtype_bytes=device_lib.dtype_of(cfg.compute_dtype).itemsize)
                kv_layout = "paged" if pick.startswith("paged") else "dense"
        if kv_layout == "dense":
            self.backend = DenseBackend(
                cfg, params, device=self.device, rows=max_batch, cache_len=cache_len,
                prompt_buckets=prompt_buckets or (128, 512, 2048))
        else:
            self.backend = PagedBackend(
                cfg, params, device=self.device, num_pages=num_pages,
                page_size=page_size, rows=max_batch,
                max_pages_per_seq=(max_pages_per_seq
                                   or max(1, min(cache_len // page_size, num_pages - 1))),
                prompt_buckets=prompt_buckets or (32, 64, 128),
                prefix_sharing=prefix_sharing, reserve_pages=reserve_pages,
                batch_prefills=batch_prefills, kv_dtype=kv_dtype,
                host_pool_bytes=host_pool_bytes,
            )
        self.backend.steps_per_sync = steps_per_sync
        self.scheduler = scheduler or Scheduler()
        self.backend.choose_victim = self.scheduler.choose_victim
        # Through a weak reference: the backend holds no cycle back to the
        # engine, so a dropped engine frees its caches and graphs at once.
        engine = weakref.ref(self)
        self.backend.on_preempt = lambda *a: engine()._on_preempt(*a)
        self._detokenizer = detokenizer
        self._pending: Dict[int, int] = {}      # row -> next token to feed
        self._streamed: Dict[int, int] = {}     # uid -> tokens emitted
        #: uid -> buffered outputs of an open stream() consumer; only uids
        #: with an open stream have an entry.
        self._stream_q: Dict[int, List[RequestOutput]] = {}
        self._first_emitted: set = set()        # uids past their first token
        self._last_ticks = 0                    # live ticks of the last sync
        self._completed: List[RequestOutput] = []
        self._next_uid = 0
        self._tokens_generated = 0
        self._elapsed = 0.0
        self._decode_elapsed = 0.0
        self._decode_tokens = 0
        #: uid -> seconds from add_request to its first sampled token (at
        #: the prefill flush; the tracer's TTFT runs to the first streamed
        #: token).
        self.ttft: Dict[int, float] = {}
        self._arrival: Dict[int, float] = {}

        # Telemetry: every instrument is bound here, once; the per-tick
        # functions only call .inc() / .observe() / .set() on them.
        self.telemetry = telemetry or NULL_TELEMETRY
        self._tr = self.telemetry.tracer
        self._drift = self.telemetry.drift
        m = self.telemetry.metrics
        self._m_requests = m.counter(
            "serving_requests_total", "requests accepted by add_request")
        self._m_steps = m.counter("serving_steps_total", "engine ticks (step() calls)")
        self._m_tokens = m.counter("serving_tokens_total", "tokens streamed to callers")
        self._m_admitted = m.counter(
            "serving_admissions_total", "admission records flushed")
        self._m_preempt = m.counter(
            "serving_preemptions_total", "rows evicted under page pressure")
        self._m_finished = m.counter(
            "serving_finished_total", "requests that reached finish")
        self._h_step = m.histogram(
            "serving_step_seconds", "one full step(): schedule+flush+decode")
        self._h_schedule = m.histogram(
            "serving_schedule_seconds", "admission-policy time per step")
        self._h_flush = m.histogram("serving_flush_seconds", "prefill flush time per step")
        self._h_decode = m.histogram(
            "serving_decode_step_seconds", "fused decode + sample + bookkeeping per tick")
        self._g_running = m.gauge("serving_running", "active decode rows")
        self._g_waiting = m.gauge("serving_waiting", "queued + requeued requests")
        self._m_demotions = m.counter(
            "serving_kv_demotions_total", "KV pages demoted device -> host tier")
        self._m_promotions = m.counter(
            "serving_kv_promotions_total", "KV pages promoted host tier -> device")
        self._g_device_kv = m.gauge(
            "serving_kv_device_bytes_resident", "device KV pool bytes held by live pages")
        self._g_host_kv = m.gauge(
            "serving_kv_host_bytes_resident", "host-tier KV bytes held by demoted pages")
        # The backend's tier counters are running totals; the engine exports
        # deltas, so a telemetry reset does not count them twice.
        self._tier_seen = {"demoted_pages": 0, "promoted_pages": 0}

    @property
    def kv_layout(self) -> str:
        return self.backend.kv_layout

    def add_request(self, request=None, *, prompt=None,
                    sampling: Optional[SamplingParams] = None,
                    uid: Optional[int] = None, priority: Optional[int] = None) -> int:
        """Queue one request (a :class:`Request`, or a raw ``prompt`` plus
        keywords); returns its uid. Requests that can never be served are
        rejected here."""
        if request is None:
            if prompt is None:
                raise ValueError("pass a Request or a prompt")
            if uid is None:
                uid = self._next_uid
            request = Request(uid, prompt, sampling, 0 if priority is None else priority)
        elif prompt is not None or sampling is not None or uid is not None \
                or priority is not None:
            raise ValueError("pass either a Request or prompt/... keywords")
        self._next_uid = max(self._next_uid, request.uid + 1)
        self.backend.validate(request)
        self.scheduler.add(request)
        # A uid reused after its request finished gets a TTFT of its own.
        self.ttft.pop(request.uid, None)
        self._arrival[request.uid] = time.perf_counter()
        self._m_requests.inc()
        self._tr.request_event(request.uid, "arrival", prompt_len=len(request.prompt),
                               priority=request.priority)
        return request.uid

    def step(self, max_steps: Optional[int] = None) -> List[RequestOutput]:
        """One serving sync: admit and prefill what fits, then up to
        ``max_steps`` (default ``steps_per_sync``) fused decode ticks over
        every active row, the host reading their results once. Returns the
        streamed increments: one :class:`RequestOutput` per request that
        gained tokens or finished this sync."""
        if self._auto_steps:
            # Before admission: the page budget prices decode headroom off
            # the N this sync runs (sync_reserve_pages).
            self.steps_per_sync = self.scheduler.choose_steps_per_sync(self.backend)
            self.backend.steps_per_sync = self.steps_per_sync
        n_steps = self.steps_per_sync if max_steps is None else int(max_steps)
        if n_steps < 1:
            raise ValueError(f"max_steps must be >= 1, got {max_steps}")
        t0 = time.perf_counter()
        records: List = []
        with self._tr.span("step"):
            try:
                with self._tr.span("schedule"):
                    self.scheduler.schedule(self.backend, records)
            finally:
                self._h_schedule.observe(time.perf_counter() - t0)
                # Flush even when a late admission raises: admitted rows must
                # never reach a decode tick unprefilled.
                for rec in records:
                    self._m_admitted.inc()
                    # A row admitted with replay tokens is a preemption resume.
                    resumed = bool(self.backend.out[rec["row"]])
                    self._tr.request_event(rec["req"].uid, "resume" if resumed else "admitted",
                                           row=rec["row"])
                if records:
                    tf = time.perf_counter()
                    with self._tr.span("flush", rows=len(records)):
                        self._flush(records)
                    self._h_flush.observe(time.perf_counter() - tf)
            outputs: List[RequestOutput] = []
            if self.backend.active.any():
                nb = self.backend.num_active
                live = self.backend.lengths[self.backend.active]
                mean_len = float(live.mean()) if live.size else 0.0
                td = time.perf_counter()
                with self._tr.span("decode", batch=nb, steps=n_steps):
                    outputs = self._decode_tick(n_steps)
                dt = time.perf_counter() - td
                self._h_decode.observe(dt)
                self._decode_elapsed += dt
                self._drift.record(nb, mean_len, dt, ticks=self._last_ticks)
            self._emit_lifecycle(outputs)
        self._m_steps.inc()
        self._g_running.set(self.backend.num_active)
        self._g_waiting.set(self.scheduler.num_waiting)
        self._observe_tier()
        dt_all = time.perf_counter() - t0
        self._h_step.observe(dt_all)
        self._elapsed += dt_all
        return outputs

    def _emit_lifecycle(self, outputs: List[RequestOutput]) -> None:
        """Per-request events of this sync's streamed increments:
        ``first_token`` on a request's first emission, one ``tokens`` event
        per emission, ``finish`` at termination; then a copy of each output
        to its open stream() consumer, if any."""
        detok = self._detokenizer
        for o in outputs:
            if detok is not None:
                o.text = detok(o.new_tokens)
            n = len(o.new_tokens)
            if n:
                self._m_tokens.inc(n)
                if o.uid not in self._first_emitted:
                    self._first_emitted.add(o.uid)
                    self._tr.request_event(o.uid, "first_token")
                self._tr.request_event(o.uid, "tokens", n=n)
            if o.finished:
                self._m_finished.inc()
                self._first_emitted.discard(o.uid)
                self._tr.request_event(o.uid, "finish", reason=o.finish_reason,
                                       tokens=len(o.tokens))
            buf = self._stream_q.get(o.uid)
            if buf is not None:
                buf.append(o)

    def _observe_tier(self) -> None:
        """Export the KV tier's residency once per step: demotion and
        promotion deltas since the last step, and the bytes resident on
        each side."""
        b = self.backend
        if "demoted_pages" not in b.stats:
            return
        for key, ctr in (("demoted_pages", self._m_demotions),
                         ("promoted_pages", self._m_promotions)):
            delta = b.stats[key] - self._tier_seen[key]
            if delta:
                ctr.inc(delta)
                self._tier_seen[key] = b.stats[key]
        page_bytes = b.kv_pool_bytes() // max(b.pool.num_pages, 1)
        self._g_device_kv.set(b.pool.used_pages * page_bytes)
        self._g_host_kv.set(b.host.bytes_resident if b.host is not None else 0)

    def generate(self, requests: Iterable = ()) -> List[RequestOutput]:
        """Queue ``requests`` and step until every queued request finishes;
        returns the final outputs in completion order."""
        for r in requests:
            self.add_request(r)
        done: List[RequestOutput] = []
        while self.backend.active.any() or self.scheduler.has_work():
            idle_before = not self.backend.active.any()
            outs = self.step()
            done.extend(o for o in outs if o.finished)
            if idle_before and not outs and not self.backend.active.any():
                err = OutOfPages("pool too small for any queued request; grow "
                                 "num_pages or shrink prompts")
                err.completed = done
                raise err
        return done

    async def stream(self, request=None, *, prompt=None,
                     sampling: Optional[SamplingParams] = None,
                     priority: Optional[int] = None):
        """Push-style consumption of one request::

            async for out in engine.stream(prompt=toks, sampling=sp):
                print(out.text or out.new_tokens, end="")

        Queues the request and yields its :class:`RequestOutput` increments
        as they are produced, ending after the finished one. The iterator
        drives ``step()`` whenever it has nothing buffered; concurrent
        consumers (several streams, or a stream beside ``generate()``)
        cooperate, since every ``step()`` routes increments into each open
        stream's buffer. Yields to the event loop between syncs. Raises
        ``OutOfPages`` when the request can never be admitted."""
        uid = self.add_request(request, prompt=prompt, sampling=sampling, priority=priority)
        q = self._stream_q.setdefault(uid, [])
        try:
            while True:
                while q:
                    out = q.pop(0)
                    yield out
                    if out.finished:
                        return
                idle_before = not self.backend.active.any()
                outs = self.step()
                if idle_before and not outs and not self.backend.active.any() and not q:
                    raise OutOfPages("pool too small for any queued request; grow "
                                     "num_pages or shrink prompts")
                await asyncio.sleep(0)
        finally:
            self._stream_q.pop(uid, None)

    def close(self) -> None:
        """Release every live row (and, paged, prove the pool is fully free)
        and free the decode graphs."""
        self.backend.shutdown()

    def stats(self) -> SchedulerStats:
        b = self.backend
        pool = b.prefix_stats()
        nb = max(b.num_active, 1)
        return SchedulerStats(
            kv_layout=b.kv_layout, running=b.num_active,
            waiting=self.scheduler.num_waiting, completed=len(self._completed),
            tokens_generated=self._tokens_generated, elapsed_s=self._elapsed,
            tokens_per_s=self._tokens_generated / self._elapsed if self._elapsed else 0.0,
            decode_elapsed_s=self._decode_elapsed,
            decode_tok_s=(self._decode_tokens / self._decode_elapsed
                          if self._decode_elapsed else 0.0),
            measured_tok_s=safe_rate(self._tokens_generated, self._decode_elapsed),
            modeled_tok_s=safe_rate(nb, b.decode_time_model(nb)),
            prefix_hit_rate=b.prefix_hit_rate(), page_occupancy=b.page_occupancy,
            preemptions=b.stats["preemptions"], resumed_tokens=b.stats["resumed_tokens"],
            prefill_launches=b.stats["prefill_launches"],
            batched_prefills=b.stats["batched_prefills"],
            steps_per_sync=self.steps_per_sync, kv_dtype=str(pool["kv_dtype"]),
            demoted_pages=int(pool.get("demoted_pages", 0)),
            promoted_pages=int(pool.get("promoted_pages", 0)),
            host_bytes_resident=int(pool.get("host_bytes_resident", 0)),
        )

    def drift_model_fn(self):
        """``(batch, mean_len) -> modelled seconds`` for
        :meth:`repro_torch.obs.DriftCollector.report`: the backend's decode
        model (the attention kernel only) at the cell's live context."""
        model = self.backend.decode_time_model
        return lambda batch, mean_len: model(batch, mean_len=mean_len)

    def reset_metrics(self) -> None:
        """Zero telemetry and the engine's wall-clock totals (a load harness
        calls this after warm-up, so no measured number holds a capture)."""
        self.telemetry.reset()
        self._elapsed = 0.0
        self._decode_elapsed = 0.0
        self._tokens_generated = 0
        self._decode_tokens = 0

    # -- internals ---------------------------------------------------------

    def _on_preempt(self, row: int, req, generated: List) -> None:
        self._pending.pop(row, None)
        self.scheduler.requeue(req, generated)
        self._m_preempt.inc()
        self._tr.request_event(req.uid, "preempt", row=row, generated=len(generated))

    def _seed_for(self, req) -> int:
        seed = req.sampling.seed
        return (req.uid if seed is None else seed) & 0x7FFFFFFF

    def _sampling_arrays(self, size: int, slots_rows):
        """(size,) host arrays of sampling parameters for (array slot,
        backend row) pairs; other slots keep inert defaults. The stream
        position is the row's generated-token count now."""
        temps = np.zeros((size,), np.float32)
        top_k = np.zeros((size,), np.int64)
        top_p = np.ones((size,), np.float32)
        seeds = np.zeros((size,), np.int64)
        pos = np.zeros((size,), np.int64)
        for slot, row in slots_rows:
            req = self.backend.row_req(row)
            sp = req.sampling
            temps[slot], top_k[slot], top_p[slot] = sp.temperature, sp.top_k, sp.top_p
            seeds[slot] = self._seed_for(req)
            pos[slot] = len(self.backend.out[row])
        return temps, top_k, top_p, seeds, pos

    def _flush(self, records: List) -> None:
        """Run the admitted prefills and sample each row's first token (at
        stream position = tokens generated so far, so a resumed request
        continues its stream exactly), through the program every tick runs."""
        first = self.backend.flush(records)
        rows = sorted(first)
        if not rows:
            return
        logits = torch.stack([first[r] for r in rows])
        dev = logits.device
        params = [torch.from_numpy(a).to(dev)
                  for a in self._sampling_arrays(len(rows), list(enumerate(rows)))]
        toks = sampling_lib.sample_batch(logits, *params).cpu().numpy()
        now = time.perf_counter()
        for r, t in zip(rows, toks):
            self._pending[r] = int(t)
            uid = self.backend.row_req(r).uid
            if uid in self._arrival and uid not in self.ttft:
                self.ttft[uid] = now - self._arrival[uid]

    def _stop_array(self, rows: List[int]) -> np.ndarray:
        """(rows, W) stop ids padded with -1, W a power of two (a graph key
        component, so bucketing bounds the captures); W 0 when no active
        row has stop tokens."""
        b = self.backend
        width = max((len(b.row_req(r).sampling.stop_token_ids) for r in rows), default=0)
        if width == 0:
            return np.zeros((b.rows, 0), np.int64)
        width = 1 << (width - 1).bit_length()
        stops = np.full((b.rows, width), -1, np.int64)
        for r in rows:
            ids = b.row_req(r).sampling.stop_token_ids
            stops[r, : len(ids)] = ids
        return stops

    def _decode_tick(self, n_steps: int) -> List[RequestOutput]:
        """Reserve room for the sync (may preempt), gather each active row's
        token to feed and its sampling parameters, run the fused decode and
        hand its results to :meth:`_sync_scan`. The sync runs at most as
        many ticks as the longest remaining ``max_tokens`` of its rows,
        rounded up to a power of two: every row is finished by then, so the
        outputs are those of ``n_steps`` ticks."""
        b = self.backend
        b.reserve_rows(n_steps)
        rows = [r for r in range(b.rows) if b.active[r]]
        if not rows:
            self._last_ticks = 0
            return []
        tok = np.zeros((b.rows,), np.int64)
        for r in rows:
            tok[r] = self._pending.pop(r) if r in self._pending else int(b.out[r][-1])
        temps, top_k, top_p, seeds, pos = self._sampling_arrays(b.rows, [(r, r) for r in rows])
        max_toks = np.zeros((b.rows,), np.int64)
        for r in rows:
            max_toks[r] = b.row_req(r).sampling.max_tokens
        longest = int(max(max_toks[r] - pos[r] for r in rows))
        n = min(n_steps, 1 << max(longest - 1, 0).bit_length())
        ys, lengths = b.fused_decode(tok, pos, self._stop_array(rows), max_toks, temps,
                                     top_k, top_p, seeds, n)
        return self._sync_scan(ys, lengths)

    def _sync_scan(self, ys, lengths) -> List[RequestOutput]:
        """The once-per-sync host step: replay the ticks' masks into each
        row's output, finish the rows that ended, and return one
        :class:`RequestOutput` per row that gained tokens or finished. The
        masks' priority is the single tick's: a fed stop token outranks the
        length cap; a sampled stop token is appended and ends the row."""
        b = self.backend
        tok_seq, nxt_seq, live, appended, fed_stop, hit_max = ys
        b.commit_scan(lengths)
        self._decode_tokens += int(live.sum())
        self._last_ticks = int(live.any(axis=1).sum())
        outputs: List[RequestOutput] = []
        for r in range(b.rows):
            col = live[:, r]
            if not col.any():
                continue
            req = b.row_req(r)
            reason = None
            last_t = 0
            for t in range(col.shape[0]):
                if not col[t]:
                    break
                last_t = t
                b.out[r].append(int(tok_seq[t, r]))
                self._tokens_generated += 1
                if fed_stop[t, r]:
                    reason = FINISH_STOP
                    break
                if hit_max[t, r]:
                    reason = FINISH_LENGTH
                    break
                if appended[t, r]:
                    b.out[r].append(int(nxt_seq[t, r]))
                    self._tokens_generated += 1
                    reason = FINISH_STOP
                    break
            if reason is not None:
                outputs.append(self._finish(r, req, reason))
                continue
            self._pending[r] = int(nxt_seq[last_t, r])
            delta = self._delta(req.uid, b.out[r])
            if delta:
                outputs.append(RequestOutput(uid=req.uid, prompt_len=len(req.prompt),
                                             new_tokens=delta, tokens=list(b.out[r])))
        return outputs

    def _delta(self, uid: int, out: List) -> List:
        """Tokens not yet streamed for ``uid`` (replayed resume tokens were
        streamed before the preemption)."""
        emitted = self._streamed.get(uid, 0)
        if len(out) <= emitted:
            return []
        self._streamed[uid] = len(out)
        return list(out[emitted:])

    def _finish(self, row: int, req, reason: str) -> RequestOutput:
        toks = list(self.backend.out[row])
        delta = self._delta(req.uid, toks)
        self._streamed.pop(req.uid, None)
        self._pending.pop(row, None)
        self.backend.release(row)
        out = RequestOutput(uid=req.uid, prompt_len=len(req.prompt), new_tokens=delta,
                            tokens=toks, finished=True, finish_reason=reason)
        self._completed.append(out)
        return out

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
Options of the JAX engine that the port does not have yet raise
``NotImplementedError`` naming the ROADMAP item, never accepted and
ignored: ``kv_dtype`` other than ``"fp32"`` (the unquantized pool in the
compute dtype), ``host_pool_bytes``, ``mesh`` and ``telemetry``.
"""

from __future__ import annotations

import time
import weakref
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.cache.pool import OutOfPages
from repro_torch.configs.base import ModelConfig
from repro_torch.core import device as device_lib
from repro_torch.kernels import plan as plan_lib
from repro_torch.serving import sampling as sampling_lib
from repro_torch.serving.backends import DenseBackend, PagedBackend
from repro_torch.serving.request import (
    FINISH_LENGTH,
    FINISH_STOP,
    Request,
    RequestOutput,
    SamplingParams,
)
from repro_torch.serving.scheduler import Scheduler, SchedulerStats

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
    decode ticks per host sync, an int >= 1 or ``"auto"``."""

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
        telemetry=None,
        steps_per_sync=1,
        mesh=None,
        kv_dtype: str = "fp32",
        host_pool_bytes=None,
        detokenizer: Optional[Callable[[Sequence], str]] = None,
        device=None,
    ):
        if kv_layout not in KV_LAYOUTS:
            raise ValueError(f"kv_layout must be one of {KV_LAYOUTS}, got {kv_layout!r}")
        if kv_dtype != "fp32":
            raise _not_ported(f"kv_dtype={kv_dtype!r}", "quantized and tiered KV")
        if host_pool_bytes:
            raise _not_ported("host_pool_bytes", "quantized and tiered KV")
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
        if telemetry is not None:
            raise _not_ported("telemetry", "telemetry")
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
                batch_prefills=batch_prefills,
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
        self._completed: List[RequestOutput] = []
        self._next_uid = 0
        self._tokens_generated = 0
        self._elapsed = 0.0
        self._decode_elapsed = 0.0
        self._decode_tokens = 0
        #: uid -> seconds from add_request to its first sampled token.
        self.ttft: Dict[int, float] = {}
        self._arrival: Dict[int, float] = {}

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
        try:
            self.scheduler.schedule(self.backend, records)
        finally:
            # Flush even when a late admission raises: admitted rows must
            # never reach a decode tick unprefilled.
            if records:
                self._flush(records)
        outputs: List[RequestOutput] = []
        if self.backend.active.any():
            td = time.perf_counter()
            outputs = self._decode_tick(n_steps)
            self._decode_elapsed += time.perf_counter() - td
        if self._detokenizer is not None:
            for o in outputs:
                o.text = self._detokenizer(o.new_tokens)
        self._elapsed += time.perf_counter() - t0
        return outputs

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

    def close(self) -> None:
        """Release every live row (and, paged, prove the pool is fully free)
        and free the decode graphs."""
        self.backend.shutdown()

    def stats(self) -> SchedulerStats:
        b = self.backend
        return SchedulerStats(
            kv_layout=b.kv_layout, running=b.num_active,
            waiting=self.scheduler.num_waiting, completed=len(self._completed),
            tokens_generated=self._tokens_generated, elapsed_s=self._elapsed,
            tokens_per_s=self._tokens_generated / self._elapsed if self._elapsed else 0.0,
            decode_elapsed_s=self._decode_elapsed,
            decode_tok_s=(self._decode_tokens / self._decode_elapsed
                          if self._decode_elapsed else 0.0),
            prefix_hit_rate=b.prefix_hit_rate(), page_occupancy=b.page_occupancy,
            preemptions=b.stats["preemptions"], resumed_tokens=b.stats["resumed_tokens"],
            prefill_launches=b.stats["prefill_launches"],
            batched_prefills=b.stats["batched_prefills"],
            steps_per_sync=self.steps_per_sync,
        )

    # -- internals ---------------------------------------------------------

    def _on_preempt(self, row: int, req, generated: List) -> None:
        self._pending.pop(row, None)
        self.scheduler.requeue(req, generated)

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

"""``LLMEngine``: the serving entry point of the port.

Port of ``repro.serving.engine.LLMEngine``: ``add_request`` /
``step() -> list[RequestOutput]`` continuous batching with streamed
increments, ``generate`` as the blocking loop, per-request sampling,
admission and preemption by ``serving.scheduler``, execution by
``serving.backends.DenseBackend`` or ``PagedBackend``. One ``step`` admits
and prefills, then runs one decode tick over the active rows; greedy
outputs equal the JAX engine's token for token (for SSM and hybrid models,
where the JAX engine's padded prefill leaks pad tokens into the recurrent
state, they equal the JAX package's unpadded prefill and decode; ROADMAP
Queue C).

``kv_layout="auto"`` (the default, as in the JAX package) serves models the
paged pool cannot hold (SSM and hybrid stacks) from dense stripes, and
ranks dense against paged for the rest with ``plan.resolve_kv_layout``.
Options of the JAX engine that the port does not have yet raise
``NotImplementedError`` naming the ROADMAP item, never accepted and
ignored: ``kv_dtype`` other than ``"fp32"`` (the unquantized pool in the
compute dtype), ``host_pool_bytes``, ``mesh``, ``steps_per_sync`` other
than 1, and ``telemetry``.
"""

from __future__ import annotations

import time
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
    ``prompt_buckets=None`` picks per-layout defaults."""

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
        if steps_per_sync != 1:
            raise _not_ported(f"steps_per_sync={steps_per_sync!r}",
                              "fused decode as a CUDA graph")
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
        self.scheduler = scheduler or Scheduler()
        self.backend.choose_victim = self.scheduler.choose_victim
        self.backend.on_preempt = self._on_preempt
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

    def step(self) -> List[RequestOutput]:
        """Admit and prefill what fits, then one decode tick over every
        active row. Returns the streamed increments."""
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
            outputs = self._decode_tick()
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
        """Release every live row (and, paged, prove the pool is fully free)."""
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
        )

    # -- internals ---------------------------------------------------------

    def _on_preempt(self, row: int, req, generated: List) -> None:
        self._pending.pop(row, None)
        self.scheduler.requeue(req, generated)

    def _seed_for(self, req) -> int:
        seed = req.sampling.seed
        return (req.uid if seed is None else seed) & 0x7FFFFFFF

    def _sample(self, logits, rows: List[int], positions: List[int]) -> np.ndarray:
        reqs = [self.backend.row_req(r) for r in rows]
        sp = [r.sampling for r in reqs]
        toks = sampling_lib.sample_tokens(
            logits, [s.temperature for s in sp], [s.top_k for s in sp],
            [s.top_p for s in sp], [self._seed_for(r) for r in reqs], positions)
        return toks.cpu().numpy()

    def _flush(self, records: List) -> None:
        """Run the admitted prefills and sample each row's first token (at
        stream position = tokens generated so far, so a resumed request
        continues its stream exactly)."""
        first = self.backend.flush(records)
        rows = sorted(first)
        if not rows:
            return
        logits = torch.stack([first[r] for r in rows])
        toks = self._sample(logits, rows, [len(self.backend.out[r]) for r in rows])
        now = time.perf_counter()
        for r, t in zip(rows, toks):
            self._pending[r] = int(t)
            uid = self.backend.row_req(r).uid
            if uid in self._arrival and uid not in self.ttft:
                self.ttft[uid] = now - self._arrival[uid]

    def _decode_tick(self) -> List[RequestOutput]:
        """Reserve each active row's next slot (may preempt), feed every
        row its pending token, sample the next, and apply the stop rules of
        the JAX engine's fused tick: a fed stop token or the max_tokens cap
        ends a row; a freshly sampled stop token is appended and ends it."""
        b = self.backend
        b.reserve_rows()
        rows = [r for r in range(b.rows) if b.active[r]]
        if not rows:
            return []
        fed = [self._pending.pop(r) if r in self._pending else int(b.out[r][-1])
               for r in rows]
        logits = b.decode(rows, fed)
        gen = [len(b.out[r]) + 1 for r in rows]
        nxt = self._sample(logits, rows, gen)
        self._decode_tokens += len(rows)
        outputs: List[RequestOutput] = []
        for i, r in enumerate(rows):
            req = b.row_req(r)
            sp = req.sampling
            b.out[r].append(fed[i])
            self._tokens_generated += 1
            reason = None
            if fed[i] in sp.stop_token_ids:
                reason = FINISH_STOP
            elif gen[i] >= sp.max_tokens:
                reason = FINISH_LENGTH
            elif int(nxt[i]) in sp.stop_token_ids:
                b.out[r].append(int(nxt[i]))
                self._tokens_generated += 1
                reason = FINISH_STOP
            if reason is not None:
                outputs.append(self._finish(r, req, reason))
                continue
            self._pending[r] = int(nxt[i])
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

"""Serving scheduler: admission, fairness and preemption policy.

Port of ``repro.serving.scheduler`` without the model-driven parts
(the occupancy cap and the prefill-savings tie-break, which need the
JAX package's decode and extend time models; see ROADMAP.md):

  * admission walks the ready queue in (effective priority, arrival) order
    with head-of-line blocking; preempted requests re-enter first;
  * fairness is priority + FCFS with aging: effective priority grows by one
    every ``aging_rounds`` rounds a request waits;
  * the page budget prices a request (pages needed minus prefix matches,
    plus decode headroom: ``sync_reserve_pages``, which grows with the
    fused decode's ticks per sync) against free + evictable pages before
    the backend's allocator is touched; a backend without a page pool
    (dense slots) always passes it, its row check is in ``try_admit``;
  * ``choose_victim`` evicts the lowest-priority, newest active row;
  * ``choose_steps_per_sync`` picks the fused decode's ticks per sync for
    ``steps_per_sync="auto"`` from the backend's measured tick (the JAX
    package prices a modelled one; the port's decode model prices only the
    attention, a small part of the tick on the card).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional, Sequence, Tuple

from repro_torch.core import perf_model


#: Denominators below this are "not measured yet": a rate over them reports
#: 0.0 rather than inf or a 10^15 tok/s artifact.
MIN_RATE_DENOM_S = 1e-9


def safe_rate(count: float, seconds: float) -> float:
    """``count / seconds``, with a near-zero denominator reported as 0.0
    (unknown) instead of inf."""
    return count / seconds if seconds > MIN_RATE_DENOM_S else 0.0


def default_choose_victim(candidates: Sequence[Tuple[int, int, int]],
                          protect: int = -1) -> Optional[int]:
    """Among active ``(priority, submit_order, row)`` rows, evict the lowest
    priority, newest among ties; never ``protect``."""
    pool = [(prio, -order, row) for prio, order, row in candidates if row != protect]
    if not pool:
        return None
    return min(pool)[2]


@dataclasses.dataclass
class SchedulerStats:
    """Serving counters surfaced by ``LLMEngine.stats()``. Rates are over
    host wall-clock time, and never to be conflated:

      * ``tokens_per_s``: tokens over the engine's whole wall time
        (scheduling, prefill and host bookkeeping included);
      * ``measured_tok_s``: every generated token (a sampled stop token
        included) over the decode phase's wall time, as the JAX package
        computes it;
      * ``decode_tok_s``: the live row-ticks of the decode syncs over the
        same decode wall time;
      * ``modeled_tok_s``: ``core.perf_model``'s prediction at the current
        batch, which prices the decode attention kernel only, not the whole
        tick; a near-zero modelled tick reports 0.0 (:func:`safe_rate`).

    The JAX package's ``occupancy_cap`` is left out: the scheduler's
    occupancy cap is not ported (ROADMAP Queue A item 2)."""

    kv_layout: str = "paged"
    running: int = 0
    waiting: int = 0
    completed: int = 0
    tokens_generated: int = 0
    elapsed_s: float = 0.0
    tokens_per_s: float = 0.0
    decode_elapsed_s: float = 0.0
    decode_tok_s: float = 0.0
    measured_tok_s: float = 0.0    # tokens / measured decode wall time
    modeled_tok_s: float = 0.0     # perf_model tokens/s at the current batch
    prefix_hit_rate: Optional[float] = 0.0   # None: no prefix cache (dense)
    page_occupancy: float = 0.0
    preemptions: int = 0
    resumed_tokens: int = 0
    prefill_launches: int = 0
    batched_prefills: int = 0
    steps_per_sync: int = 1
    kv_dtype: str = "fp32"         # pool storage (fp32 = the compute dtype, int8, fp8)
    demoted_pages: int = 0         # pages demoted device -> host tier
    promoted_pages: int = 0        # pages promoted host tier -> device
    host_bytes_resident: int = 0   # host-tier bytes held now

    def summary(self) -> str:
        hit = "n/a" if self.prefix_hit_rate is None else f"{self.prefix_hit_rate:.2f}"
        dtype = f" {self.kv_dtype}" if self.kv_dtype != "fp32" else ""
        tier = ""
        if self.demoted_pages or self.promoted_pages:
            tier = (f" | tier {self.demoted_pages} demoted / {self.promoted_pages} promoted "
                    f"({self.host_bytes_resident} host bytes)")
        return (
            f"[{self.kv_layout}{dtype}] {self.completed} done / {self.running} running / "
            f"{self.waiting} waiting | {self.tokens_generated} tokens in "
            f"{self.elapsed_s:.2f}s ({self.tokens_per_s:.1f} tok/s wall, decode "
            f"{self.decode_tok_s:.1f} tok/s, measured {self.measured_tok_s:.1f}, modeled "
            f"{self.modeled_tok_s:.0f}) | prefix hit {hit} | "
            f"occupancy {self.page_occupancy:.2f} | {self.preemptions} preemptions "
            f"({self.resumed_tokens} tokens resumed) | {self.prefill_launches} "
            f"prefill launches ({self.batched_prefills} batched) | "
            f"{self.steps_per_sync} steps per sync{tier}"
        )


@dataclasses.dataclass
class _Waiting:
    req: object
    arrival: int
    rounds_waited: int = 0


class Scheduler:
    """Admission / fairness / preemption policy over a serving backend."""

    def __init__(self, *, aging_rounds: int = 4):
        if aging_rounds < 1:
            raise ValueError("aging_rounds must be >= 1")
        self.aging_rounds = aging_rounds
        self._waiting: List[_Waiting] = []
        self._requeue: "deque[Tuple[object, List]]" = deque()
        self._arrival = 0

    def add(self, req) -> None:
        self._waiting.append(_Waiting(req, self._arrival))
        self._arrival += 1

    def requeue(self, req, generated: Sequence) -> None:
        """Re-enter a preempted request at the front; its generated tokens
        replay through the extend path on re-admission."""
        self._requeue.appendleft((req, list(generated)))

    @property
    def num_waiting(self) -> int:
        return len(self._waiting) + len(self._requeue)

    def has_work(self) -> bool:
        return bool(self._waiting or self._requeue)

    def _effective_priority(self, w: _Waiting) -> int:
        return w.req.priority + w.rounds_waited // self.aging_rounds

    def page_budget_ok(self, backend, req) -> bool:
        if not hasattr(backend, "quote"):
            return True
        total, matched = backend.quote(req)
        reserve = getattr(backend, "sync_reserve_pages", backend.reserve_pages)
        return total - matched + reserve <= backend.free_pages + backend.evictable_pages

    def _admission_ok(self, backend, req) -> bool:
        return backend.num_active < backend.rows and self.page_budget_ok(backend, req)

    def schedule(self, backend, records: List) -> List:
        """One admission round: preempted work first, then the ready queue,
        head-of-line blocking. Records are appended to the caller's list
        and must be flushed before the next decode tick."""
        while self._requeue:
            req, toks = self._requeue[0]
            if not self._admission_ok(backend, req):
                break
            try:
                rec = backend.try_admit(req, resume_tokens=toks)
            except ValueError:
                self._requeue.popleft()
                raise
            if rec is None:
                break
            self._requeue.popleft()
            records.append(rec)
        if not self._requeue:
            ranked = sorted(self._waiting,
                            key=lambda w: (-self._effective_priority(w), w.arrival))
            for w in ranked:
                if not self._admission_ok(backend, w.req):
                    break
                try:
                    rec = backend.try_admit(w.req)
                except ValueError:
                    self._waiting.remove(w)
                    raise
                if rec is None:
                    break
                self._waiting.remove(w)
                records.append(rec)
        for w in self._waiting:
            w.rounds_waited += 1
        return records

    def choose_victim(self, candidates, protect: int = -1) -> Optional[int]:
        return default_choose_victim(candidates, protect)

    def choose_steps_per_sync(self, backend) -> int:
        """Ticks per sync for ``steps_per_sync="auto"``: the smallest power
        of two whose amortized host-sync cost drops under 10% of the
        backend's measured tick (``decode_tick_s`` of its latest sync; every
        sync runs all rows at the full width, so the next one costs the
        same), ``perf_model.choose_steps_per_sync``. 1 until a sync has been
        measured."""
        tick = getattr(backend, "decode_tick_s", None)
        if tick is None:
            return 1
        return perf_model.choose_steps_per_sync(decode_tick_s=float(tick))

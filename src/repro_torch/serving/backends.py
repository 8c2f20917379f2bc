"""Execution backends for the serving engine: mechanism, not policy.

Port of ``repro.serving.backends``:

  * ``DenseBackend`` (``backends.py:315``): one ``cache_len`` stripe per
    decode row (and the Mamba-2 state of SSM and hybrid models); each
    admitted prompt is right-padded to its bucket and prefilled into its
    slot; one decode tick advances every active slot. No preemption.
  * ``PagedBackend`` (``backends.py:533``): the paged KV pool with
    hash-chain prefix sharing, same-round in-flight page sharing, batched
    tail-prefill flush in dependency waves, per-token page append with
    copy-on-write, and preemption with resume by replay.

Who is admitted or evicted is the scheduler's call. Left out of this slice
(ROADMAP.md): quantized pools, the host page tier, the serving mesh and the
fused multi-step decode scan. Differences that follow from eager PyTorch:
the caches are updated in place, and a decode tick runs only on the live
shape (the JAX package keeps static shapes for ``jit``): the paged tick
takes the active rows with the page table cut to the widest live row; the
dense tick takes the rows up to the last active one, as a view of the
stripes cut to the widest live row. The decode plan, and with it the
split-K choice, is resolved for that live shape.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.cache.pool import NULL_PAGE, OutOfPages, PagePool, SequencePages, SequenceReleasedError
from repro_torch.cache.prefix import PrefixCache, page_hashes
from repro_torch.configs.base import ModelConfig
from repro_torch.core import device as device_lib
from repro_torch.core import perf_model
from repro_torch.kernels import plan as plan_lib
from repro_torch.kernels.decode_attention import STAGE as DECODE_BLOCK
from repro_torch.models import transformer
from repro_torch.serving.scheduler import default_choose_victim


class _SeqState:
    """One active decode row."""

    __slots__ = ("req", "pages", "submit_order")

    def __init__(self, req, pages, submit_order):
        self.req = req
        self.pages = pages
        self.submit_order = submit_order


class _Backend:
    """Row bookkeeping and prompt buckets, shared by both layouts."""

    def _init_rows(self, rows: int, prompt_buckets) -> None:
        self.rows = rows
        self.lengths = np.zeros((rows,), np.int32)
        self.active = np.zeros((rows,), bool)
        #: Generated tokens per row (replayed resume tokens included).
        self.out: List[List] = [[] for _ in range(rows)]
        self.prompt_buckets = tuple(prompt_buckets)

    @property
    def num_active(self) -> int:
        return int(self.active.sum())

    def _bucket_for(self, n: int) -> int:
        for b in self.prompt_buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds buckets {self.prompt_buckets}")

    def fits_buckets(self, n: int) -> bool:
        return any(n <= b for b in self.prompt_buckets)


class DenseBackend(_Backend):
    """Slot-based dense KV: each row owns a ``cache_len`` stripe (and, for
    SSM and hybrid models, its recurrent state); a request prefills into a
    free slot, right-padded to its prompt bucket; one decode tick advances
    every active slot. A slot is committed until its sequence finishes."""

    kv_layout = "dense"

    def __init__(self, cfg: ModelConfig, params, *, device: torch.device, rows: int = 8,
                 cache_len: int = 2048, prompt_buckets=(128, 512, 2048)):
        self.cfg = cfg
        self.params = params
        self.device = device
        self.cache_len = cache_len
        self._init_rows(rows, (b for b in prompt_buckets if b <= cache_len))
        self.slot_req: List[Optional[object]] = [None] * rows
        self.stats = {"preemptions": 0, "resumed_tokens": 0, "prefill_launches": 0,
                      "batched_prefills": 0}
        self.caches = transformer.init_caches(cfg, rows, cache_len, device)

    # -- capacity ----------------------------------------------------------

    def validate(self, req) -> None:
        n = len(req.prompt)
        if not self.fits_buckets(n):
            raise ValueError(f"prompt length {n} exceeds buckets {self.prompt_buckets}")
        if n + req.max_new_tokens > self.cache_len:
            raise ValueError(
                f"request {req.uid}: prompt {n} + max_tokens {req.max_new_tokens} "
                f"exceeds the dense cache stripe ({self.cache_len} tokens)")

    def decode_time_model(self, batch: int, mean_len: Optional[float] = None) -> float:
        """Modelled tick time (``perf_model.estimate_dense_decode``): the
        whole stripe per cell, whatever ``mean_len`` is live."""
        return perf_model.estimate_dense_decode(
            batch=batch, num_q_heads=self.cfg.n_heads, num_kv_heads=self.cfg.n_kv_heads,
            capacity=self.cache_len, head_dim=self.cfg.head_dim,
            dtype_bytes=device_lib.dtype_of(self.cfg.compute_dtype).itemsize,
            topo=plan_lib.TOPOLOGY).time

    @property
    def page_occupancy(self) -> float:
        return self.num_active / self.rows if self.rows else 0.0

    def prefix_hit_rate(self) -> None:
        """Dense stripes have no prefix cache: None, not a cache that never hit."""
        return None

    def prefix_stats(self) -> Dict[str, object]:
        """Every sharing counter is a structural zero and
        ``prefix_hit_rate`` is None, as in the JAX package."""
        return {
            "prefix_entries": 0.0, "pages_reused": 0.0, "prompt_pages": 0.0,
            "prefix_hit_rate": None, "prefix_lookup_hits": 0.0,
            "prefix_lookup_queries": 0.0, "prefix_evictions": 0.0,
            **{k: float(v) for k, v in self.stats.items()},
        }

    # -- admission / prefill ----------------------------------------------

    def try_admit(self, req, resume_tokens: Sequence = ()):
        if len(resume_tokens):
            raise ValueError("dense backend does not preempt, so it cannot resume")
        free = np.flatnonzero(~self.active)
        if len(free) == 0:
            return None
        n = len(req.prompt)
        bucket = self._bucket_for(n)
        row = int(free[0])
        self.lengths[row] = n
        self.active[row] = True
        self.slot_req[row] = req
        self.out[row] = []
        return {"req": req, "row": row, "n": n, "bucket": bucket,
                "prompt": np.asarray(req.prompt)}

    def _write_slot(self, row: int, caches: List[dict]) -> None:
        """Copy one prefilled sequence's caches into slot ``row``; the
        stripe past the bucket is zeroed, as the JAX package's full-width
        copy leaves it."""
        for dst, src in zip(self.caches, caches):
            for key, val in src.items():
                if key in ("k", "v"):
                    n = val.shape[2]
                    dst[key][row, :, :n] = val[0].to(dst[key].dtype)
                    dst[key][row, :, n:] = 0
                else:
                    dst[key][row] = val[0].to(dst[key].dtype)

    @torch.no_grad()
    def flush(self, records) -> Dict[int, torch.Tensor]:
        """Prefill each admitted record into its slot (right-padded to its
        bucket; the SSM state is the unpadded prompt's); returns per-row
        last-position logits for the engine's first-token sample."""
        first_logits: Dict[int, torch.Tensor] = {}
        for rec in records:
            n, bucket = rec["n"], rec["bucket"]
            padded = np.pad(rec["prompt"], (0, bucket - n))[None]
            self.stats["prefill_launches"] += 1
            logits, caches = transformer.prefill(
                self.params, self.cfg, torch.from_numpy(padded.astype(np.int64)).to(self.device),
                cache_len=bucket,
                last_positions=torch.tensor([n - 1], dtype=torch.int64, device=self.device))
            self._write_slot(rec["row"], caches)
            first_logits[rec["row"]] = logits[0]
        return first_logits

    # -- decode / teardown -------------------------------------------------

    def reserve_rows(self) -> None:
        """Dense stripes pre-reserve every position at admission."""

    def _live_width(self, rows: int) -> int:
        """Stripe width one tick reads: the widest live row of the first
        ``rows`` rounded up to the decode kernels' staging block (so the
        plan's chunk divides it), at most ``cache_len``."""
        longest = int(self.lengths[:rows].max())
        return min(self.cache_len, -(-longest // DECODE_BLOCK) * DECODE_BLOCK)

    @torch.no_grad()
    def decode(self, rows: List[int], tokens: List[int]) -> torch.Tensor:
        """One decode step for the active ``rows``; returns their logits
        (len(rows), V). The tick runs rows ``0 .. max(rows)`` over views of
        the slots cut to the live width; a free slot inside that range gets
        length 0 (no attention work) and its state is overwritten at its
        next prefill."""
        self.lengths[rows] += 1
        hi = max(rows) + 1
        width = self._live_width(hi)
        tok = np.zeros((hi,), np.int64)
        tok[rows] = [int(t) for t in tokens]
        lengths = np.where(self.active[:hi], self.lengths[:hi], 0).astype(np.int32)
        views = []
        for c in self.caches:
            v = {key: val[:hi] for key, val in c.items()}
            for key in ("k", "v"):
                if key in v:
                    v[key] = v[key][:, :, :width]
            views.append(v)
        dev = self.device
        logits, _ = transformer.decode_step(
            self.params, self.cfg, torch.from_numpy(tok).to(dev), views,
            torch.from_numpy(lengths).to(dev))
        return logits[torch.as_tensor(rows, device=dev)]

    def row_req(self, row: int):
        return self.slot_req[row]

    def release(self, row: int) -> None:
        if self.slot_req[row] is None:
            raise SequenceReleasedError(f"release of row {row}, which holds no sequence")
        self.active[row] = False
        self.slot_req[row] = None
        self.lengths[row] = 0

    def shutdown(self) -> None:
        """Mark every slot free; dense rows own no pool pages, so there is
        nothing to leak-check."""
        for row in range(self.rows):
            self.active[row] = False
            self.slot_req[row] = None
            self.lengths[row] = 0


class PagedBackend(_Backend):
    """Paged KV-cache backend. ``rows`` is the decode batch width;
    capacity is the page pool: admission succeeds when a request's
    non-shared prompt pages fit the free list with ``reserve_pages`` of
    decode headroom."""

    kv_layout = "paged"

    def __init__(self, cfg: ModelConfig, params, *, device: torch.device,
                 num_pages: int = 128, page_size: int = 16, rows: int = 8,
                 max_pages_per_seq: int = 16, prompt_buckets=(32, 64, 128),
                 prefix_sharing: bool = True, reserve_pages: int = 1,
                 batch_prefills: bool = True):
        for b in prompt_buckets:
            if b % page_size:
                raise ValueError(
                    f"prompt bucket {b} must be a multiple of page_size {page_size}")
        if num_pages - 1 < max_pages_per_seq:
            raise ValueError(
                f"num_pages={num_pages} (usable {num_pages - 1}) cannot hold one "
                f"max_pages_per_seq={max_pages_per_seq} sequence")
        self.cfg = cfg
        self.params = params
        self.device = device
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self.cache_len = max_pages_per_seq * page_size
        self.reserve_pages = reserve_pages
        self.prefix_sharing = prefix_sharing
        self.batch_prefills = batch_prefills

        self._init_rows(rows, (b for b in prompt_buckets if b <= self.cache_len))
        self._submit_counter = 0
        self.preempted: List[Tuple[object, List]] = []
        self.choose_victim: Callable = default_choose_victim
        self.on_preempt: Callable = (
            lambda row, req, toks: self.preempted.append((req, toks)))
        self.stats = {
            "preemptions": 0, "prefix_evictions": 0, "pages_reused": 0,
            "prompt_pages": 0, "cow_copies": 0, "extend_prefills": 0,
            "resumed_tokens": 0, "prefill_launches": 0, "batched_prefills": 0,
            "inflight_pages_reused": 0,
        }

        self.pool = PagePool(num_pages, page_size)
        self.prefix = PrefixCache(self.pool)
        #: chain hash -> (physical page, publishing uid) for pages admitted
        #: but not yet prefilled this round; cleared by :meth:`flush`.
        self._pending_pages: Dict[bytes, Tuple[int, int]] = {}
        self.caches = transformer.init_paged_caches(cfg, num_pages, page_size, device)
        self.page_table = np.zeros((rows, max_pages_per_seq), np.int32)
        self.seqs: List[Optional[_SeqState]] = [None] * rows

    # -- capacity ----------------------------------------------------------

    def validate(self, req) -> None:
        tok = np.asarray(req.prompt)
        if tok.ndim != 1:
            raise ValueError("paged backend expects flat token prompts")
        n = len(tok)
        if self.pool.pages_needed(n + req.max_new_tokens) > self.max_pages_per_seq:
            raise ValueError(
                f"request {req.uid}: prompt {n} + max_new_tokens {req.max_new_tokens} "
                f"can outgrow max_pages_per_seq={self.max_pages_per_seq} "
                f"({self.cache_len} tokens) mid-decode; reject at admission instead")
        if not self.prefix_sharing and not self.fits_buckets(n):
            raise ValueError(f"prompt length {n} exceeds buckets {self.prompt_buckets}")

    def quote(self, req) -> Tuple[int, int]:
        """(pages the prompt needs, shared pages it would reuse) — a pure
        peek: LRU order and hit counters stay untouched."""
        n = len(req.prompt)
        total = self.pool.pages_needed(n)
        matched = 0
        if self.prefix_sharing and n > 1:
            limit = (n - 1) // self.page_size
            hashes = req.page_hashes(self.page_size)
            matched = len(self.prefix.lookup(hashes[:limit], touch=False))
            while matched < limit and hashes[matched] in self._pending_pages:
                matched += 1
        return total, matched

    @property
    def free_pages(self) -> int:
        return self.pool.free_pages

    @property
    def evictable_pages(self) -> int:
        return len(self.prefix)

    @property
    def page_occupancy(self) -> float:
        return self.pool.used_pages / max(self.pool.num_pages - 1, 1)

    # -- page plumbing -----------------------------------------------------

    def _scatter_tail(self, tail_caches: List[dict], pids: np.ndarray) -> None:
        """Write prefilled tails' K/V into their pages, every layer. ``pids``
        (rows, bucket / ps): destinations past a tail's real pages are the
        null page, a garbage sink."""
        flat = torch.from_numpy(pids.reshape(-1).astype(np.int64)).to(self.device)
        ps = self.page_size
        for pool, tail in zip(self.caches, tail_caches):
            for name, dense in (("k_pages", tail["k"]), ("v_pages", tail["v"])):
                rows, hkv, bucket, hd = dense.shape
                new = dense.reshape(rows, hkv, bucket // ps, ps, hd).permute(1, 0, 2, 3, 4)
                pool[name][:, flat] = new.reshape(hkv, rows * (bucket // ps), ps, hd).to(
                    pool[name].dtype)

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write: physical page ``src`` -> ``dst``, every layer."""
        for pool in self.caches:
            for name in ("k_pages", "v_pages"):
                pool[name][:, dst] = pool[name][:, src]

    @staticmethod
    def _prefix_page_bucket(pages: int) -> int:
        """Prefix page count bucketed to the next power of two (the width of
        the extend page table; the live length stays exact)."""
        if pages <= 0:
            return 0
        return 1 << (pages - 1).bit_length()

    # -- admission ---------------------------------------------------------

    def _make_room(self, pages_needed: int) -> bool:
        """Evict idle prefix-cache pages until ``pages_needed`` fit; report
        whether they do."""
        short = pages_needed - self.pool.free_pages
        if short > 0 and len(self.prefix):
            self.stats["prefix_evictions"] += self.prefix.evict(short)
            short = pages_needed - self.pool.free_pages
        return short <= 0

    def _reserve(self, num_tokens: int, matched) -> Optional[SequencePages]:
        """Pin the matched prefix pages, make room, allocate; None when the
        pool cannot hold the request."""
        for p in matched:
            self.pool.incref(p)
        try:
            need = self.pool.pages_needed(num_tokens) - len(matched)
            if not self._make_room(need + self.reserve_pages):
                return None
            try:
                return self.pool.allocate_sequence(num_tokens, shared_prefix=matched)
            except OutOfPages:
                return None
        finally:
            for p in matched:
                self.pool.decref(p)

    def try_admit(self, req, resume_tokens: Sequence = ()):
        """Reserve a decode row and pages for ``req`` (prefill runs at
        :meth:`flush`). The prefix-cache match continues through pages a
        record admitted earlier this round will publish. ``resume_tokens``
        (a preempted run's output) replay as more prompt. Returns an
        admission record, or None when the pool or rows cannot hold it."""
        free_rows = np.flatnonzero(~self.active)
        if len(free_rows) == 0:
            return None
        tok = np.asarray(req.prompt)
        if tok.ndim != 1:
            raise ValueError("paged backend expects flat token prompts")
        orig_n = len(tok)
        if len(resume_tokens):
            tok = np.concatenate([tok, np.asarray([int(t) for t in resume_tokens], tok.dtype)])
        n = len(tok)
        ps = self.page_size
        total_pages = self.pool.pages_needed(n)
        if total_pages > self.max_pages_per_seq:
            raise ValueError(
                f"prompt needs {total_pages} pages > max_pages_per_seq {self.max_pages_per_seq}")
        self.validate(req)

        if not self.prefix_sharing:
            hashes = []
        elif len(resume_tokens):
            hashes = page_hashes(tok, ps)
        else:
            hashes = req.page_hashes(ps)
        # At least one tail token is prefilled here, for the next-token logits.
        limit = (n - 1) // ps
        matched = self.prefix.lookup(hashes[:limit])
        after: set = set()
        if self.prefix_sharing:
            inflight = 0
            while len(matched) < limit and hashes[len(matched)] in self._pending_pages:
                pid, owner = self._pending_pages[hashes[len(matched)]]
                matched.append(pid)
                after.add(owner)
                inflight += 1
            self.stats["inflight_pages_reused"] += inflight

        if not self.fits_buckets(n - len(matched) * ps):
            if len(resume_tokens):
                # Drop replayed tokens until the tail fits a bucket; decode
                # regenerates them exactly.
                m_full = len(matched)
                for keep in range(len(resume_tokens) - 1, -1, -1):
                    nk = orig_n + keep
                    mk = min(m_full, (nk - 1) // ps)
                    if self.fits_buckets(nk - mk * ps):
                        return self.try_admit(req, list(resume_tokens)[:keep])
            raise ValueError(
                f"prompt tail {n - len(matched) * ps} exceeds buckets {self.prompt_buckets}")
        seq = self._reserve(n, matched)
        if seq is None and matched and self.fits_buckets(n):
            # Reuse blocked admission: prefill from scratch instead.
            matched = []
            after = set()
            seq = self._reserve(n, matched)
        if seq is None:
            return None
        m = len(matched)
        tail = tok[m * ps:]
        bucket = self._bucket_for(len(tail))
        self.stats["pages_reused"] += m
        self.stats["prompt_pages"] += total_pages

        row = int(free_rows[0])
        self.seqs[row] = _SeqState(req=req, pages=seq, submit_order=self._submit_counter)
        self._submit_counter += 1
        self._set_table(row)
        self.lengths[row] = n
        self.active[row] = True
        self.out[row] = list(resume_tokens)
        self.stats["resumed_tokens"] += len(resume_tokens)
        if self.prefix_sharing:
            for i in range(m, n // ps):
                self._pending_pages[hashes[i]] = (seq.pages[i], req.uid)
        return {
            "req": req, "row": row, "seq": seq, "matched": matched, "tail": tail,
            "bucket": bucket, "n": n, "hashes": hashes,
            "mb": self._prefix_page_bucket(m) if m else 0,
            "after": frozenset(after),
        }

    def _set_table(self, row: int) -> None:
        pages = self.seqs[row].pages.pages
        self.page_table[row] = NULL_PAGE
        self.page_table[row, : len(pages)] = pages

    @torch.no_grad()
    def flush(self, records) -> Dict[int, torch.Tensor]:
        """Run the admitted tail prefills in dependency waves (a borrower of
        same-round pages runs after their publisher). Returns per-row
        last-position logits. Serving takes no gradient: parameters that
        require grad build no graph here."""
        first_logits: Dict[int, torch.Tensor] = {}
        todo = list(records)
        published: set = set()
        while todo:
            wave = [r for r in todo if r.get("after", frozenset()) <= published] or list(todo)
            done = {id(r) for r in wave}
            todo = [r for r in todo if id(r) not in done]
            self._flush_wave(wave, first_logits)
            published.update(r["req"].uid for r in wave)
        self._pending_pages.clear()
        return first_logits

    def _flush_wave(self, records, first_logits: Dict[int, torch.Tensor]) -> None:
        """One wave: group by (tail bucket, prefix-page bucket), run each
        group as one batched prefill, scatter the tails into their pages,
        publish full pages to the prefix cache."""
        ps = self.page_size
        dev = self.device
        groups: Dict[Tuple[int, ...], list] = {}
        for i, rec in enumerate(records):
            key = (rec["bucket"], rec["mb"]) if self.batch_prefills else (
                rec["bucket"], rec["mb"], i)
            groups.setdefault(key, []).append(rec)
        for (bucket, mb, *_), grp in groups.items():
            rows = len(grp)
            padded = np.stack([np.pad(r["tail"], (0, bucket - len(r["tail"]))) for r in grp])
            tokens = torch.from_numpy(padded.astype(np.int64)).to(dev)
            last = torch.tensor([len(r["tail"]) - 1 for r in grp], dtype=torch.int64,
                                device=dev)
            self.stats["prefill_launches"] += 1
            self.stats["batched_prefills"] += rows > 1
            if mb == 0:
                logits, tail_caches = transformer.prefill(
                    self.params, self.cfg, tokens, cache_len=bucket, last_positions=last)
            else:
                pt = np.full((rows, mb), NULL_PAGE, np.int32)
                for i, r in enumerate(grp):
                    pt[i, : len(r["matched"])] = r["matched"]
                plens = torch.tensor([len(r["matched"]) * ps for r in grp],
                                     dtype=torch.int32, device=dev)
                self.stats["extend_prefills"] += rows
                plan = plan_lib.plan_for_config(
                    self.cfg,
                    (rows, self.cfg.n_heads, self.cfg.n_kv_heads, bucket,
                     mb * ps + bucket, self.cfg.head_dim),
                    device_type=dev.type, phase=plan_lib.EXTEND,
                    kv_layout=plan_lib.PAGED, page_size=ps)
                logits, tail_caches = transformer.prefill(
                    self.params, self.cfg, tokens, cache_len=bucket, last_positions=last,
                    prefix_caches=self.caches, page_table=torch.from_numpy(pt).to(dev),
                    prefix_len=plens, plan=plan)
            pids = np.full((rows, bucket // ps), NULL_PAGE, np.int32)
            for i, r in enumerate(grp):
                tail_pages = r["seq"].pages[len(r["matched"]):]
                pids[i, : len(tail_pages)] = tail_pages
            self._scatter_tail(tail_caches, pids)
            for i, r in enumerate(grp):
                if self.prefix_sharing:
                    nfull = r["n"] // ps
                    self.prefix.insert(r["hashes"][:nfull], r["seq"].pages[:nfull])
                first_logits[r["row"]] = logits[i]

    # -- preemption / decode ----------------------------------------------

    def _preempt_one(self, protect: int) -> bool:
        """Evict the active row the ``choose_victim`` policy names (never
        ``protect``) and report it through ``on_preempt``."""
        candidates = [
            (s.req.priority, s.submit_order, row)
            for row, s in enumerate(self.seqs)
            if s is not None and self.active[row] and row != protect
        ]
        row = self.choose_victim(candidates, protect) if candidates else None
        if row is None:
            return False
        state = self.seqs[row]
        self.stats["preemptions"] += 1
        self.pool.release(state.pages)
        generated = list(self.out[row])
        self.active[row] = False
        self.seqs[row] = None
        self.page_table[row] = NULL_PAGE
        self.lengths[row] = 0
        self.out[row] = []
        self.on_preempt(row, state.req, generated)
        return True

    def reserve_rows(self) -> None:
        """Reserve every active row's next token slot, preempting other rows
        under pool pressure; copy-on-write copies happen here."""
        for row in range(self.rows):
            if not self.active[row]:
                continue
            state = self.seqs[row]
            while True:
                try:
                    _, _, cow = self.pool.append_token(state.pages)
                    break
                except OutOfPages:
                    if not (self._make_room(1) or self._preempt_one(row)):
                        raise OutOfPages("pool exhausted and nothing left to preempt")
            if cow is not None:
                self.stats["cow_copies"] += 1
                self._copy_page(*cow)
            self._set_table(row)

    @torch.no_grad()
    def decode(self, rows: List[int], tokens: List[int]) -> torch.Tensor:
        """One decode step for the active ``rows`` (their slots reserved by
        :meth:`reserve_rows`); returns their logits (len(rows), V)."""
        self.lengths[rows] += 1
        width = max(len(self.seqs[r].pages.pages) for r in rows)
        dev = self.device
        tok = torch.tensor([int(t) for t in tokens], dtype=torch.int64, device=dev)
        lengths = torch.from_numpy(self.lengths[rows]).to(dev)
        pt = torch.from_numpy(np.ascontiguousarray(self.page_table[rows, :width])).to(dev)
        logits, self.caches = transformer.decode_step(
            self.params, self.cfg, tok, self.caches, lengths, page_table=pt)
        return logits

    def row_req(self, row: int):
        return self.seqs[row].req

    def release(self, row: int) -> None:
        state = self.seqs[row]
        if state is None:
            raise SequenceReleasedError(f"release of row {row}, which holds no sequence")
        self.pool.release(state.pages)
        self.active[row] = False
        self.seqs[row] = None
        self.page_table[row] = NULL_PAGE
        self.lengths[row] = 0

    # -- teardown / introspection ------------------------------------------

    def live_page_refs(self) -> Dict[int, int]:
        refs: Dict[int, int] = {}
        for state in self.seqs:
            if state is not None:
                for pid in state.pages.pages:
                    refs[pid] = refs.get(pid, 0) + 1
        for pid in self.prefix.pages():
            refs[pid] = refs.get(pid, 0) + 1
        return refs

    def check_leaks(self, raise_on_leak: bool = True):
        return self.pool.check_leaks(self.live_page_refs(), raise_on_leak=raise_on_leak)

    def shutdown(self) -> None:
        """Release every live row, drain the prefix cache, prove the pool
        is fully free."""
        for row in range(self.rows):
            if self.seqs[row] is not None:
                self.release(row)
        self.prefix.drain()
        self._pending_pages.clear()
        self.pool.check_leaks()

    def prefix_hit_rate(self) -> float:
        total = self.stats["prompt_pages"]
        return self.stats["pages_reused"] / total if total else 0.0

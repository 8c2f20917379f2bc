"""Paged execution backend for the serving engine: mechanism, not policy.

Port of ``repro.serving.backends.PagedBackend`` (``backends.py:533``):
the paged KV pool with hash-chain prefix sharing, same-round in-flight page
sharing, batched tail-prefill flush in dependency waves, per-token page
append with copy-on-write, and preemption with resume by replay. Who is
admitted or evicted is the scheduler's call.

Left out of this slice (ROADMAP.md): the dense-stripe backend, quantized
pools, the host page tier, the serving mesh and the fused multi-step
decode scan. Differences that follow from eager PyTorch: the pools are
updated in place, and a decode tick runs only the active rows, with the
page table cut to the widest live row (the JAX package keeps static
shapes for ``jit``); the decode plan, and with it the split-K choice, is
resolved for that live shape.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.cache.pool import NULL_PAGE, OutOfPages, PagePool, SequencePages, SequenceReleasedError
from repro_torch.cache.prefix import PrefixCache, page_hashes
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import plan as plan_lib
from repro_torch.models import transformer
from repro_torch.serving.scheduler import default_choose_victim


class _SeqState:
    """One active decode row."""

    __slots__ = ("req", "pages", "submit_order")

    def __init__(self, req, pages, submit_order):
        self.req = req
        self.pages = pages
        self.submit_order = submit_order


class PagedBackend:
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
        self.prompt_buckets = tuple(b for b in prompt_buckets if b <= self.cache_len)
        self.reserve_pages = reserve_pages
        self.prefix_sharing = prefix_sharing
        self.batch_prefills = batch_prefills

        self.rows = rows
        self.lengths = np.zeros((rows,), np.int32)
        self.active = np.zeros((rows,), bool)
        #: Generated tokens per row (replayed resume tokens included).
        self.out: List[List] = [[] for _ in range(rows)]
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

"""Fixed-size KV page allocator: free list, ref counts, copy-on-write.

The control plane of the paged KV cache (host-side, pure Python — the
actual K/V data lives in torch tensors owned by the serving backend and
indexed by the page ids handed out here). The port's copy of
``repro.cache.pool``, kept line for line so both engines allocate the same
pages for the same request stream. Design mirrors vLLM's block manager, shrunk to
what the NUMA story needs:

  * a pool of ``num_pages`` physical pages of ``page_size`` tokens each,
    LIFO free list (hot pages are reused first — they are the ones most
    likely still resident in a domain's cache),
  * physical page 0 is the reserved **null page**: never allocated, it is
    the write/read sink for inactive decode rows and padded page-table
    entries, so a decode step can scatter unconditionally without
    corrupting live data,
  * per-page reference counts. A page with ``refcount > 1`` is shared
    (prefix cache and/or forked sequences) and therefore read-only; the
    pool's :meth:`ensure_writable` implements copy-on-write by allocating a
    fresh page and telling the caller which physical copy to perform,
  * per-sequence page tables (:class:`SequencePages`): the ordered list of
    physical pages backing one growing sequence, plus its token length.

The pool never touches array data; COW and page writes surface as
``(src_page, dst_page)`` copy instructions the backend applies to its page
tensors. That split keeps the allocator exactly testable and the device
compute free of host round-trips beyond the page-table ints it already
needs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

NULL_PAGE = 0


class PoolError(RuntimeError):
    """Base class for page-pool misuse; every typed pool error derives
    from it so callers (and the sanitizer) can catch the family."""


class OutOfPages(PoolError):
    """Raised when an allocation cannot be satisfied; the serving engine
    reacts by evicting prefix-cache pages and/or preempting sequences."""


class SequenceReleasedError(PoolError):
    """An operation (release/append/fork) hit a sequence whose pages were
    already returned to the pool. Double releases used to be silent no-ops
    — which is exactly how refcount desyncs hide — so they are typed
    errors now."""


class RefcountLeakError(PoolError):
    """:meth:`PagePool.check_leaks` found pages whose refcounts do not
    match the live references the caller claims exist (engine teardown
    left sequences or prefix entries holding pages)."""

    def __init__(self, leaks: Dict[int, Tuple[int, int]]):
        self.leaks = leaks
        detail = ", ".join(
            f"page {pid}: rc={actual} expected={expected}"
            for pid, (actual, expected) in sorted(leaks.items())
        )
        super().__init__(f"refcount leaks: {detail}")


@dataclasses.dataclass
class SequencePages:
    """Page table of one sequence: physical pages, in logical order."""

    pages: List[int]
    length: int = 0  # tokens currently stored
    released: bool = False

    def tail_page(self) -> int:
        if not self.pages:
            raise ValueError("empty sequence has no tail page")
        return self.pages[-1]


class PagePool:
    """Allocator for ``num_pages`` physical pages of ``page_size`` tokens."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        if page_size < 1:
            raise ValueError("page_size must be positive")
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO free list; page 0 reserved as the null page.
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refcount = [0] * num_pages
        self._refcount[NULL_PAGE] = 1  # permanently pinned

    # -- raw page ops -------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def refcount(self, pid: int) -> int:
        return self._refcount[pid]

    def alloc(self) -> int:
        if not self._free:
            raise OutOfPages(
                f"no free pages ({self.num_pages - 1} total in pool)"
            )
        pid = self._free.pop()
        assert self._refcount[pid] == 0
        self._refcount[pid] = 1
        return pid

    def incref(self, pid: int) -> None:
        if pid == NULL_PAGE:
            return
        if self._refcount[pid] <= 0:
            raise ValueError(f"incref on free page {pid}")
        self._refcount[pid] += 1

    def decref(self, pid: int) -> bool:
        """Drop one reference; returns True when the page was freed."""
        if pid == NULL_PAGE:
            return False
        rc = self._refcount[pid]
        if rc <= 0:
            raise ValueError(f"decref on free page {pid}")
        self._refcount[pid] = rc - 1
        if rc == 1:
            self._free.append(pid)
            return True
        return False

    # -- sequence ops -------------------------------------------------------

    def pages_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.page_size)

    def allocate_sequence(
        self, num_tokens: int, shared_prefix: Optional[List[int]] = None
    ) -> SequencePages:
        """Page table for a ``num_tokens``-token sequence.

        ``shared_prefix``: already-allocated pages (from the prefix cache)
        covering the first ``len(shared_prefix) * page_size`` tokens; the
        pool takes one reference on each. Remaining pages come off the free
        list; on exhaustion everything is rolled back and OutOfPages raised.
        """
        shared = list(shared_prefix or [])
        need = self.pages_needed(num_tokens)
        if len(shared) > need:
            raise ValueError("shared prefix longer than the sequence")
        fresh: List[int] = []
        try:
            for _ in range(need - len(shared)):
                fresh.append(self.alloc())
        except OutOfPages:
            for pid in fresh:
                self.decref(pid)
            raise
        for pid in shared:
            self.incref(pid)
        return SequencePages(pages=shared + fresh, length=num_tokens)

    def append_token(self, seq: SequencePages) -> Tuple[int, int, Optional[Tuple[int, int]]]:
        """Grow ``seq`` by one token; returns ``(page, offset, cow)``.

        ``page``/``offset`` locate the new token's slot. ``cow`` is None or a
        ``(src, dst)`` physical copy the engine must apply *before* writing —
        emitted when the token lands in a shared page (copy-on-write). A new
        page is allocated when the token starts a fresh page boundary.
        """
        if seq.released:
            raise SequenceReleasedError("append_token on a released sequence")
        pos = seq.length
        cow = None
        if pos % self.page_size == 0:
            seq.pages.append(self.alloc())
        else:
            tail = seq.tail_page()
            if self._refcount[tail] > 1:
                dst = self.alloc()
                self.decref(tail)
                seq.pages[-1] = dst
                cow = (tail, dst)
        seq.length = pos + 1
        return seq.tail_page(), pos % self.page_size, cow

    def reserve_tokens(
        self,
        seq: SequencePages,
        num_tokens: int,
        cows: Optional[List[Tuple[int, int]]] = None,
    ) -> List[Tuple[int, int]]:
        """Pre-grow ``seq`` by ``num_tokens`` slots in one go; returns the
        list of ``(src, dst)`` COW copies the engine must apply before any
        of the reserved slots is written.

        This is the host-side half of the fused multi-step decode scan: the
        scan writes up to N tokens per row without host intervention, so
        every page those tokens could land in must exist *before* launch.
        Built on :meth:`append_token` (one call per token) so page-boundary
        and copy-on-write behaviour — and the shadow sanitizer's view of
        both — is identical to N single-step appends. On ``OutOfPages``
        the partial progress is kept (``seq.length`` reflects it; COWs so
        far are in ``cows`` when the caller passed its own list), so the
        caller can free room and re-request the remainder.
        """
        out = cows if cows is not None else []
        for _ in range(num_tokens):
            _, _, cow = self.append_token(seq)
            if cow is not None:
                out.append(cow)
        return out

    def trim_tokens(self, seq: SequencePages, new_length: int) -> int:
        """Shrink ``seq`` back to ``new_length`` tokens, returning now-unused
        tail pages to the pool; returns #pages freed.

        The inverse of an over-reservation: a scan that stopped early (stop
        token, all rows done) consumed fewer slots than were reserved, and
        the untouched tail pages go straight back on the free list.
        """
        if seq.released:
            raise SequenceReleasedError("trim_tokens on a released sequence")
        if not 0 <= new_length <= seq.length:
            raise ValueError(
                f"trim_tokens to {new_length} outside [0, {seq.length}]"
            )
        keep = self.pages_needed(new_length)
        freed = 0
        while len(seq.pages) > keep:
            freed += bool(self.decref(seq.pages.pop()))
        seq.length = new_length
        return freed

    def fork(self, seq: SequencePages) -> SequencePages:
        """A new sequence sharing every page of ``seq`` (beam/parallel
        sampling). All pages — including the partial tail — are shared;
        the first divergent append triggers COW on the tail."""
        if seq.released:
            raise SequenceReleasedError("fork of a released sequence")
        for pid in seq.pages:
            self.incref(pid)
        return SequencePages(pages=list(seq.pages), length=seq.length)

    def release(self, seq: SequencePages) -> int:
        """Drop the sequence's references; returns #pages actually freed
        (shared pages survive under their remaining references).

        Releasing an already-released sequence raises
        :class:`SequenceReleasedError` — a silent no-op here is how a
        double-decref elsewhere stays hidden until pages alias."""
        if seq.released:
            raise SequenceReleasedError(
                "release of an already-released sequence"
            )
        freed = 0
        for pid in seq.pages:
            freed += bool(self.decref(pid))
        seq.pages = []
        seq.length = 0
        seq.released = True
        return freed

    # -- invariants ---------------------------------------------------------

    def check_leaks(
        self,
        live_refs: Optional[Dict[int, int]] = None,
        raise_on_leak: bool = True,
    ) -> Dict[int, Tuple[int, int]]:
        """Verify every page's refcount against the caller's claimed live
        references.

        ``live_refs`` maps page id -> number of references the caller still
        legitimately holds (live sequences' page tables, prefix-cache
        entries). Omitted pages are expected free. The null page's
        permanent pin is accounted for automatically. Returns
        ``{pid: (actual_rc, expected_rc)}`` for every mismatch; raises
        :class:`RefcountLeakError` on mismatch unless ``raise_on_leak`` is
        False. Also validates free-list consistency (a freed page must have
        rc == 0 and appear exactly once)."""
        expected = dict(live_refs or {})
        expected[NULL_PAGE] = expected.get(NULL_PAGE, 0) + 1
        leaks: Dict[int, Tuple[int, int]] = {}
        for pid in range(self.num_pages):
            want = expected.get(pid, 0)
            have = self._refcount[pid]
            if have != want:
                leaks[pid] = (have, want)
        free_set = set(self._free)
        if len(free_set) != len(self._free):  # duplicate free-list entry
            dupes = sorted(p for p in free_set if self._free.count(p) > 1)
            for pid in dupes:
                leaks[pid] = (self._refcount[pid], -self._free.count(pid))
        for pid in free_set:
            if self._refcount[pid] != 0:
                leaks.setdefault(pid, (self._refcount[pid], 0))
        if leaks and raise_on_leak:
            raise RefcountLeakError(leaks)
        return leaks

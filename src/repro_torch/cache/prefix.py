"""Hash-based prefix sharing: longest-shared-prefix page reuse.

The port's copy of ``repro.cache.prefix``: the chain hashes are byte-for-byte
the same, so a page cached by either engine has one name.

Requests in a serving mix overwhelmingly share their head — system prompts,
few-shot preambles, multi-turn history. Prefilling that head once and
letting every later request reference the same physical pages is the
serving-scale form of the paper's ACC reuse: the shared pages are the KV
working set that stays resident in a domain's cache while every sequence
attending it hits.

Granularity is one **full page**: a page's K/V content is determined by the
token ids of every position up to and including that page (K/V at position
i depends on tokens[0..i] only through the token at i and its RoPE position
— but the *hidden state* feeding the projections depends on the whole
prefix), so a page is reusable exactly when the entire token prefix up to
its end matches. That is captured by a hash chain:

    h_0   = H(tokens[0:ps])
    h_j   = H(h_{j-1}, tokens[j*ps:(j+1)*ps])

and the cache maps ``h_j -> physical page id``. Lookup walks the chain and
stops at the first miss — the longest shared prefix, by construction.

The cache owns one pool reference per cached page. Eviction is LRU over
chain entries and only frees pages no live sequence still references
(refcount 1 == only the cache holds it); entries whose page is still shared
are skipped, not freed. Evicting h_j while h_{j+1} survives merely strands
the longer entry until its own eviction — lookups stop at the hole.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.cache.pool import PagePool


def page_hashes(tokens: Sequence[int], page_size: int) -> List[bytes]:
    """Chain hashes of every *full* page of ``tokens``."""
    toks = np.asarray(tokens).reshape(-1)
    out: List[bytes] = []
    prev = b""
    for j in range(len(toks) // page_size):
        h = hashlib.sha256()
        h.update(prev)
        h.update(np.ascontiguousarray(
            toks[j * page_size : (j + 1) * page_size], dtype=np.int64
        ).tobytes())
        prev = h.digest()
        out.append(prev)
    return out


class PrefixCache:
    """chain-hash -> physical page id, LRU-ordered, pool-ref-owning."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()
        self.hits = 0
        self.queries = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, hashes: Sequence[bytes], touch: bool = True) -> List[int]:
        """Physical pages of the longest cached prefix of ``hashes``.

        Does NOT take references — callers incref via
        ``pool.allocate_sequence(shared_prefix=...)`` while the entries are
        still cache-pinned. Matched entries are refreshed to MRU and the
        page-level hit / query counters advance; ``touch=False`` is a pure
        peek (for admission *pricing*, which may probe the same request
        every scheduling round without distorting LRU order or the hit
        rate).
        """
        pages: List[int] = []
        for h in hashes:
            pid = self._entries.get(h)
            if pid is None:
                break
            if touch:
                self._entries.move_to_end(h)
            pages.append(pid)
        if touch:
            self.queries += len(hashes)
            self.hits += len(pages)
        return pages

    def insert(self, hashes: Sequence[bytes], pages: Sequence[int]) -> int:
        """Register ``pages`` (the physical backing of full pages whose chain
        hashes are ``hashes``), taking one pool reference per new entry.
        Returns the number of entries actually added."""
        if len(hashes) != len(pages):
            raise ValueError("hashes and pages must align")
        added = 0
        for h, pid in zip(hashes, pages):
            if h in self._entries:
                self._entries.move_to_end(h)
                continue
            self.pool.incref(pid)
            self._entries[h] = pid
            added += 1
        return added

    def evict(self, max_pages: int, on_evict=None) -> int:
        """Free up to ``max_pages`` pool pages by dropping LRU entries whose
        page only the cache still references. Returns pages freed.

        ``on_evict(hash, pid)``, when given, fires for each victim *before*
        its entry is dropped and its reference released, while the page
        content is still valid: the host tier's demotion hook."""
        freed = 0
        if max_pages <= 0:
            return freed
        for h in list(self._entries):
            pid = self._entries[h]
            if self.pool.refcount(pid) > 1:
                # A live sequence still shares it: dropping the entry would
                # not free the page, only lose future sharing. Keep it.
                continue
            if on_evict is not None:
                on_evict(h, pid)
            del self._entries[h]
            self.evictions += 1
            freed += bool(self.pool.decref(pid))
            if freed >= max_pages:
                break
        return freed

    def pages(self) -> List[int]:
        """Physical pages currently pinned by cache entries (one list item
        per entry — a page cached under several chain hashes appears once
        per entry, matching the references held)."""
        return list(self._entries.values())

    def drain(self) -> int:
        """Teardown: drop every entry and its pool reference regardless of
        sharing (unlike :meth:`evict`, which skips live pages). Returns
        pages actually freed. After this the cache holds no references, so
        ``pool.check_leaks`` sees only the live sequences'."""
        freed = 0
        for h in list(self._entries):
            pid = self._entries.pop(h)
            freed += bool(self.pool.decref(pid))
        return freed

    @property
    def hit_rate(self) -> float:
        return self.hits / self.queries if self.queries else 0.0

    def stats(self) -> Tuple[int, int, int]:
        """(entries, hits, queries)."""
        return len(self._entries), self.hits, self.queries

    def counters(self) -> dict:
        """Everything :meth:`stats` reports plus evictions and the
        page-level lookup hit rate: what ``PagedBackend.prefix_stats()``
        surfaces."""
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "queries": self.queries,
            "evictions": self.evictions,
            "hit_rate": self.hit_rate,
        }

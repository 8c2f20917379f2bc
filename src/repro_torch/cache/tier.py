"""Host KV tier: an LRU, byte-budgeted store of demoted pages behind the
device pool.

The port's copy of ``repro.cache.tier`` (``HostPageStore``, with the same
LRU, byte budget and counters). Under pool pressure the serving backend
copies a cold page's K/V payload (every layer's codes, plus a quantized
pool's scale entries) host-side, and only then frees the device page
(**demote**); admission continues a request's chain-hash walk into this
store where the device prefix cache's match ends, and restores the matched
payloads into fresh device pages (**promote**). Keys are the prefix cache's
chain hashes, so a payload serves any request whose token prefix matches.

The store does not look inside a payload: the backend hands it an opaque
per-layer structure of host tensors (pinned on the card) and gets the same
object back at promotion. It never holds device page ids, so residency is
exclusive: a hash is on the device (prefix cache), here, or gone.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["HostPageStore"]


class HostPageStore:
    """LRU host-memory store of demoted KV pages, keyed by chain hash.

    ``capacity_bytes`` is the host-DRAM budget; ``page_nbytes`` the host
    footprint of one logical page's payload (all layers, K+V, codes +
    scales — the backend computes it once from its cache shapes). Admits
    beyond capacity evict LRU entries; a store too small for one page
    admits nothing (capacity 0 disables tiering cleanly).
    """

    def __init__(self, capacity_bytes: int, page_nbytes: int):
        if page_nbytes <= 0:
            raise ValueError("page_nbytes must be positive")
        self.page_nbytes = int(page_nbytes)
        self.capacity_pages = max(int(capacity_bytes) // self.page_nbytes, 0)
        self._lru: "OrderedDict[bytes, Any]" = OrderedDict()
        self.demotions = 0
        self.promotions = 0
        self.evictions = 0
        self.hits = 0
        self.queries = 0

    # -- capacity -----------------------------------------------------------

    def __len__(self) -> int:
        return len(self._lru)

    def __contains__(self, h: bytes) -> bool:
        return h in self._lru

    @property
    def bytes_resident(self) -> int:
        return len(self._lru) * self.page_nbytes

    @property
    def free_slots(self) -> int:
        return self.capacity_pages - len(self._lru)

    # -- demote -------------------------------------------------------------

    def admit(self, h: bytes, payload: Any) -> bool:
        """Store one demoted page's payload under its chain hash.

        Returns True when the page is host-resident afterwards. A re-admit
        of a resident hash refreshes it to MRU without copying (the
        payload under a chain hash is content-determined — two demotions
        of the same hash carry identical K/V). Overflow evicts LRU
        entries; a zero-capacity store rejects everything.
        """
        if self.capacity_pages <= 0:
            return False
        if h in self._lru:
            self._lru.move_to_end(h)
            return True
        while len(self._lru) >= self.capacity_pages:
            self._lru.popitem(last=False)
            self.evictions += 1
        self._lru[h] = payload
        self.demotions += 1
        return True

    # -- promote ------------------------------------------------------------

    def lookup_chain(self, hashes: Sequence[bytes]) -> List[bytes]:
        """The longest stored run of ``hashes`` (from the front), MRU-
        refreshing each hit — the host-tier continuation of
        ``PrefixCache.lookup``. Payloads stay put; :meth:`take` removes
        them once device pages are allocated to receive them."""
        out: List[bytes] = []
        for h in hashes:
            if h not in self._lru:
                break
            self._lru.move_to_end(h)
            out.append(h)
        self.queries += len(hashes)
        self.hits += len(out)
        return out

    def take(self, h: bytes) -> Any:
        """Remove and return a resident payload (promotion consumes the
        host copy — the page is device-resident again, and residency is
        exclusive). KeyError on a non-resident hash."""
        payload = self._lru.pop(h)  # KeyError = promote of absent page
        self.promotions += 1
        return payload

    def peek(self, h: bytes) -> Optional[Any]:
        """Payload under ``h`` without removing or touching it."""
        return self._lru.get(h)

    def discard(self, h: bytes) -> bool:
        """Drop a resident payload without counting a promotion: the hash
        became device-resident through a fresh prefill (not a restore), so
        the host copy is superseded — exclusive residency demands it go.
        Returns whether anything was dropped."""
        return self._lru.pop(h, None) is not None

    def drain(self) -> int:
        """Teardown: drop every payload; returns entries dropped."""
        n = len(self._lru)
        self._lru.clear()
        return n

    # -- introspection ------------------------------------------------------

    def counters(self) -> Dict[str, float]:
        return {
            "entries": float(len(self._lru)),
            "capacity_pages": float(self.capacity_pages),
            "bytes_resident": float(self.bytes_resident),
            "demotions": float(self.demotions),
            "promotions": float(self.promotions),
            "evictions": float(self.evictions),
            "hits": float(self.hits),
            "queries": float(self.queries),
        }

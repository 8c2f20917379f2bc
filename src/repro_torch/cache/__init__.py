"""Paged KV-cache control plane: allocator, prefix sharing, placement."""

from repro_torch.cache import layout, pool, prefix  # noqa: F401
from repro_torch.cache.pool import NULL_PAGE, OutOfPages, PagePool, SequencePages  # noqa: F401
from repro_torch.cache.prefix import PrefixCache, page_hashes  # noqa: F401

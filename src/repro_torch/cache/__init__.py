"""Paged KV-cache control plane: allocator, prefix sharing, placement,
quantized pages and the host tier."""

from repro_torch.cache import layout, pool, prefix, quant, tier  # noqa: F401
from repro_torch.cache.pool import NULL_PAGE, OutOfPages, PagePool, SequencePages  # noqa: F401
from repro_torch.cache.prefix import PrefixCache, page_hashes  # noqa: F401

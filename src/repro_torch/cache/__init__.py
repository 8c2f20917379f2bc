"""Paged KV-cache control plane: allocator, prefix sharing, placement and
its modelled traffic, quantized pages and the host tier."""

from repro_torch.cache import layout, pool, prefix, quant, tier  # noqa: F401
from repro_torch.cache.layout import (  # noqa: F401
    HEAD_ALIGNED,
    INTERLEAVED,
    PAGE_POLICIES,
    PagedTraffic,
    compare_policies,
    decode_page_traffic,
    domain_of_head,
    domain_of_page,
)
from repro_torch.cache.pool import NULL_PAGE, OutOfPages, PagePool, SequencePages  # noqa: F401
from repro_torch.cache.prefix import PrefixCache, page_hashes  # noqa: F401
from repro_torch.cache.tier import HostPageStore  # noqa: F401

"""Cross-request prefix KV cache: radix-indexed, ref-counted,
copy-on-write page sharing over the memory-pool tiers (the port's copy of
``repro.prefix``)."""

from repro_torch.prefix.cache import (
    PREFIX_PAGE_PRIORITY, PrefixCacheManager, PrefixCacheStats, PrefixHit,
)
from repro_torch.prefix.index import PrefixNode, RadixPrefixIndex

__all__ = [
    "PREFIX_PAGE_PRIORITY",
    "PrefixCacheManager",
    "PrefixCacheStats",
    "PrefixHit",
    "PrefixNode",
    "RadixPrefixIndex",
]

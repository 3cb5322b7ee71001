"""Offload runtime of the PyTorch port: the paged KV cache whose pages live
in the memory pool (``kvcache``)."""

from repro_torch.offload.kvcache import PagedKVCache, PrefetchedPages

__all__ = ["PagedKVCache", "PrefetchedPages"]

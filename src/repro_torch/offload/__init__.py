"""Offload runtime of the PyTorch port: the paged KV cache whose pages live
in the memory pool, and the continuous scheduler's per-request page table
(``kvcache``); for training, the remat policies with activation offload
(``policies``) and the optimizer-state offload (``optstate``)."""

from repro_torch.offload.kvcache import (
    KVPageTable, PagedKVCache, PrefetchedPages, worst_case_page_bytes,
)

__all__ = ["KVPageTable", "PagedKVCache", "PrefetchedPages",
           "worst_case_page_bytes"]

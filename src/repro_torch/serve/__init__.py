"""Multi-tenant serving: paged INT8 KV cache + continuous batching.

* `repro_torch.serve.paging` — page pools, free-list allocator, page tables.
* `repro_torch.serve.decode` — the batched paged decode/prefill steps
  (B requests, B different adapters per step).
* `repro_torch.serve.engine` — :class:`ServeEngine`: continuous batching,
  power-of-two buckets, per-request streaming handles.
"""

from repro_torch.serve.engine import RequestHandle, ServeEngine
from repro_torch.serve.paging import (
    OutOfPagesError,
    PageAllocator,
    PageTable,
    init_pools,
    kv_bytes_per_token,
)

__all__ = [
    "OutOfPagesError",
    "PageAllocator",
    "PageTable",
    "RequestHandle",
    "ServeEngine",
    "init_pools",
    "kv_bytes_per_token",
]

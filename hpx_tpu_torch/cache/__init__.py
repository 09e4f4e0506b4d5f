"""Paged KV cache: block allocator, page tables and the radix prefix tree.

Counterpart of ``hpx_tpu.cache``: pure host-side bookkeeping; the device
pools live with their owner (``models/serving.ContinuousServer``).
"""

from .block_allocator import (BlockAllocator, CacheOOM, block_bytes,  # noqa: F401
                              blocks_for_budget)
from .page_table import (PageTable, device_table, materialize,  # noqa: F401
                         occupancy)
from .radix import RadixCache, prefix_hashes  # noqa: F401

"""Distributed containers (components/containers analog), on one device.

Counterpart of ``hpx_tpu.containers``; ``UnorderedMap`` (component
partitions over localities) is not ported yet.
"""

from .partitioned_vector import (  # noqa: F401
    PartitionedVector,
    PartitionedVectorView,
    Segment,
)

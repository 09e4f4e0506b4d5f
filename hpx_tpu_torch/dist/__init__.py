"""Distribution policies (libs/full/distribution_policies analog).

Counterpart of the layout half of ``hpx_tpu.dist``; the locality plane
(actions, AGAS, components, placement policies) is not ported yet.
"""

from .distribution_policies import (  # noqa: F401
    ContainerLayout,
    container_layout,
    default_layout,
    target_layout,
)

from .threadpool import WorkStealingPool, default_pool, reset_default_pool  # noqa: F401
from . import batch_environments  # noqa: F401

from .executors import (  # noqa: F401
    BaseExecutor,
    ForkJoinExecutor,
    ParallelExecutor,
    SequencedExecutor,
    ThreadPoolExecutor,
)
from .cuda import CudaExecutor, Target, get_future  # noqa: F401

from .executors import (  # noqa: F401
    BaseExecutor,
    ForkJoinExecutor,
    ParallelExecutor,
    SequencedExecutor,
    ThreadPoolExecutor,
)
from .params import (  # noqa: F401
    AutoChunkSize,
    ChunkSize,
    DynamicChunkSize,
    GuidedChunkSize,
    NumCores,
    StaticChunkSize,
    auto_chunk_size,
    dynamic_chunk_size,
    guided_chunk_size,
    num_cores,
    static_chunk_size,
)
from .policies import (  # noqa: F401
    ExecutionPolicy,
    par,
    par_simd,
    par_unseq,
    seq,
    simd,
    unseq,
)
from .cuda import (  # noqa: F401
    CudaExecutor, Target, default_target, get_future, get_targets,
)
from .execution_base import AgentRef, this_task, yield_while  # noqa: F401

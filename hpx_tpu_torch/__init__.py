"""hpx_tpu_torch — the PyTorch/CUDA port of hpx_tpu.

HPX's programming model (futures, dataflow, executors) on PyTorch, with
the device kernels written by hand in CUDA C++ for Hopper (sm_90a). The
JAX package ``hpx_tpu`` is the reference this package is tested against;
this package never imports it or JAX.

Public API façade mirroring HPX's umbrella headers (hpx/hpx.hpp):

    import hpx_tpu_torch as hpx
    f = hpx.async_(fn, *args)            # hpx::async
    hpx.dataflow(fn, f1, f2)             # hpx::dataflow
    hpx.when_all(fs); hpx.wait_all(fs)   # combinators
    hpx.cuda_executor().async_execute(fn, tensor)   # device launch

The device path runs on ``cuda:0`` unless a caller passes
``device="cpu"``.
"""

from .core.errors import Error, ErrorCode, HpxError  # noqa: F401
from .core.config import Configuration  # noqa: F401
from .core.timing import (  # noqa: F401
    HighResolutionTimer, high_resolution_clock_now,
)
from .runtime import batch_environments  # noqa: F401

# -- futures / async / dataflow ---------------------------------------------
from .futures import (  # noqa: F401
    Future, Promise, PackagedTask, Launch,
    async_, async_many, post, post_many, sync, dataflow, unwrapping,
    make_ready_future, make_exceptional_future, is_future,
    when_all, when_any, when_each, when_some,
    wait_all, wait_any, wait_each, wait_some, split_future,
)
from .synchronization import (  # noqa: F401
    Latch, Mutex, enable_lock_verification,
)

# -- executors ---------------------------------------------------------------
from .exec import (  # noqa: F401
    BaseExecutor, SequencedExecutor, ParallelExecutor, ThreadPoolExecutor,
    ForkJoinExecutor, CudaExecutor, Target, get_future,
)

# the HPX spelling (hpx::cuda::experimental::cuda_executor)
cuda_executor = CudaExecutor

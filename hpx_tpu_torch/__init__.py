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

    # config #1: SAXPY + dot, the whole algorithm on the card
    policy = hpx.par.on(hpx.cuda_executor())
    z = hpx.transform(policy, x, lambda xi: a * xi)
    dot = hpx.transform_reduce(policy, z, 0.0, operator.add,
                               operator.mul, rng2=y)

    # config #3: the STREAM triad over partitioned_vectors (4 partitions
    # on one device), through the segmented overlay
    layout = hpx.container_layout(4)
    b = hpx.partitioned_vector.from_array(x, layout)
    c = hpx.partitioned_vector.from_array(y, layout)
    a = hpx.transform(policy, b, lambda bi, ci: bi + s * ci, c)

The device path runs on ``cuda:0`` unless a caller passes
``device="cpu"``.
"""

from .core.version import HPX_TPU_VERSION, full_version_as_string  # noqa: F401
from .core.errors import Error, ErrorCode, HpxError  # noqa: F401
from .core.config import Configuration  # noqa: F401
from .core.timing import (  # noqa: F401
    HighResolutionTimer, TimedExecutor, async_after, async_at,
    high_resolution_clock_now, sleep_for, sleep_until,
)
from .runtime import batch_environments  # noqa: F401

__version__ = full_version_as_string()

# -- futures / async / dataflow ---------------------------------------------
from .futures import (  # noqa: F401
    Future, Promise, PackagedTask, Launch,
    async_, async_many, post, post_many, sync, dataflow, unwrapping,
    make_ready_future, make_exceptional_future, is_future,
    when_all, when_any, when_each, when_some,
    wait_all, wait_any, wait_each, wait_some, split_future,
)
from .futures.task_group import TaskGroup, task_group  # noqa: F401
from . import lcos  # noqa: F401
from .synchronization import (  # noqa: F401
    Latch, Mutex, enable_lock_verification,
)

# -- executors & execution policies ------------------------------------------
from .exec import (  # noqa: F401
    BaseExecutor, SequencedExecutor, ParallelExecutor, ThreadPoolExecutor,
    ForkJoinExecutor, CudaExecutor, Target, get_future,
    ExecutionPolicy, seq, par, par_unseq, unseq, simd, par_simd,
    static_chunk_size, auto_chunk_size, dynamic_chunk_size,
    guided_chunk_size, num_cores,
)

# the HPX spelling (hpx::cuda::experimental::cuda_executor)
cuda_executor = CudaExecutor

# P2300 senders/receivers (hpx::execution::experimental)
from .exec import p2300  # noqa: F401
# the reference exposes this under hpx::execution::experimental
execution_experimental = p2300

# -- parallel algorithms (one device) ----------------------------------------
from .algo import (  # noqa: F401
    for_each, for_each_n, for_loop, transform, copy, copy_n, copy_if,
    fill, fill_n, generate, generate_n,
    reduce, transform_reduce, count, count_if,
    all_of, any_of, none_of, min_element, max_element, minmax_element,
    equal, mismatch, find, find_if,
    inclusive_scan, exclusive_scan, transform_inclusive_scan,
    transform_exclusive_scan, adjacent_difference, adjacent_find,
    sort, stable_sort, is_sorted, merge, reverse, rotate, unique, partition,
    induction, reduction,
)

# -- partitioned data + segmented algorithms (one device) --------------------
from .containers import (  # noqa: F401
    PartitionedVector, PartitionedVectorView, Segment,
)
from .dist.distribution_policies import (  # noqa: F401
    ContainerLayout, container_layout, default_layout, target_layout,
)

# the HPX spelling
partitioned_vector = PartitionedVector

# -- SPMD blocks (host plane + device/mesh plane) -----------------------------
from .parallel.spmd import (  # noqa: F401
    SpmdBlock, define_spmd_block, device_spmd_block,
)

# -- pipeline parallelism (GPipe-style microbatched stages) -------------------
from .parallel.pipeline import Pipeline, PipelineStage  # noqa: F401

# -- block executor (config #5's block_executor) ------------------------------
from .exec.block import BlockExecutor, place_blocks  # noqa: F401

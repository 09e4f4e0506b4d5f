from .future import (  # noqa: F401
    Future,
    PackagedTask,
    Promise,
    SharedState,
    is_future,
    make_exceptional_future,
    make_ready_future,
)
from .async_ import (  # noqa: F401
    Launch,
    async_,
    async_many,
    post,
    post_many,
    sync,
)
from .combinators import (  # noqa: F401
    WhenAnyResult,
    WhenSomeResult,
    split_future,
    wait_all,
    wait_any,
    wait_each,
    wait_some,
    when_all,
    when_any,
    when_each,
    when_some,
)
from .dataflow import dataflow, unwrapping  # noqa: F401
from .task_group import TaskGroup, task_group  # noqa: F401

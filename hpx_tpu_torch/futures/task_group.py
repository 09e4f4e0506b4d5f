"""hpx::experimental::task_group analog.

Reference analog: libs/core/task_group (run children, wait collects; a
child throwing makes wait() rethrow; the group is reusable after wait;
children may spawn further children into the group). Counterpart of
``hpx_tpu.futures.task_group``.

    with task_group() as tg:          # wait() implied at scope exit
        tg.run(f, x)
        tg.run(g)
    # or explicitly:
    tg = TaskGroup(); tg.run(f); tg.wait()
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional

from .async_ import async_
from .future import Future


class TaskGroup:
    """Structured concurrency: spawn tasks, wait for all of them.

    Exceptions: like the reference, the FIRST child exception is
    rethrown by wait(); the rest are swallowed (all children always run
    to completion before wait returns). Children may call run() to add
    more children; wait() drains until the group is empty.
    """

    def __init__(self, executor: Any = None) -> None:
        self._executor = executor
        self._lock = threading.Lock()
        self._futures: List[Future] = []

    def run(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> None:
        """Schedule a child task."""
        if self._executor is not None:
            f = self._executor.async_execute(fn, *args, **kwargs)
        else:
            f = async_(fn, *args, **kwargs)
        with self._lock:
            self._futures.append(f)

    def wait(self) -> None:
        """Wait for all children (including ones they spawn); rethrows
        the first child exception once everything has finished."""
        first_exc: Optional[BaseException] = None
        while True:
            with self._lock:
                batch = self._futures[:]
                self._futures.clear()
            if not batch:
                break
            for f in batch:
                try:
                    f.get()
                except BaseException as e:  # noqa: BLE001
                    if first_exc is None:
                        first_exc = e
        if first_exc is not None:
            raise first_exc

    # -- context manager (scope-exit wait, like the reference's dtor) -------
    def __enter__(self) -> "TaskGroup":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.wait()
        else:
            # an exception is already in flight: still drain children,
            # but don't mask the original error
            try:
                self.wait()
            except BaseException:  # noqa: BLE001
                pass


def task_group(executor: Any = None) -> TaskGroup:
    """Factory spelling: `with task_group() as tg: ...`."""
    return TaskGroup(executor)

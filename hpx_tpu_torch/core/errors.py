"""Error codes and exceptions.

Reference analog: libs/core/errors (hpx::error enum, hpx::exception,
HPX_THROW_EXCEPTION, error_code). The runtime keeps the error taxonomy —
every runtime error carries a stable enum value usable programmatically —
but uses native Python exceptions as the carrier. The codes and types are
those of ``hpx_tpu.core.errors``, so both packages raise the same errors.
"""

from __future__ import annotations

import enum
from typing import Any, Optional


class Error(enum.IntEnum):
    """Stable error codes (subset of hpx::error relevant to this runtime)."""

    success = 0
    no_success = 1
    not_implemented = 2
    out_of_memory = 3
    bad_action_code = 4
    bad_component_type = 5
    network_error = 6
    version_too_new = 7
    version_too_old = 8
    unknown_component_address = 9
    duplicate_component_address = 10
    invalid_status = 11
    bad_parameter = 12
    internal_server_error = 13
    service_unavailable = 14
    bad_request = 15
    repeated_request = 16
    lock_error = 17
    duplicate_console = 18
    no_registered_console = 19
    startup_timed_out = 20
    uninitialized_value = 21
    bad_response_type = 22
    deadlock = 23
    assertion_failure = 24
    null_thread_id = 25
    invalid_data = 26
    yield_aborted = 27
    dynamic_link_failure = 28
    commandline_option_error = 29
    serialization_error = 30
    unhandled_exception = 31
    kernel_error = 32
    broken_task = 33
    task_moved = 34
    task_already_started = 35
    future_already_retrieved = 36
    promise_already_satisfied = 37
    future_does_not_support_cancellation = 38
    future_can_not_be_cancelled = 39
    no_state = 40
    broken_promise = 41
    thread_resource_error = 42
    future_cancelled = 43
    thread_cancelled = 44
    thread_not_interruptable = 45
    duplicate_component_id = 46
    unknown_error = 47
    bad_plugin_type = 48
    filesystem_error = 49
    bad_function_call = 50
    task_canceled_exception = 51
    task_block_not_active = 52
    out_of_range = 53
    length_error = 54
    migration_needs_retry = 55


class HpxError(RuntimeError):
    """Base runtime exception carrying an `Error` code.

    Analog of hpx::exception (libs/core/errors/include/hpx/errors/exception.hpp).
    """

    def __init__(self, code: Error, message: str = "", function: str = "",
                 file: str = "", line: int = 0):
        self.code = Error(code)
        self.function = function
        self.file = file
        self.line = line
        super().__init__(
            f"{message} (hpx error: {self.code.name}[{int(self.code)}])"
            + (f" in {function}" if function else "")
        )

    def get_error(self) -> Error:
        return self.code

    def __reduce__(self):
        # exceptions travel inside parcels: default exception pickling
        # would re-call __init__ with the FORMATTED message as the code
        # argument, which breaks on the receiving side. __dict__ rides
        # along wholesale so subclass attributes (e.g.
        # ReplayValidationError.attempts) survive the wire.
        return (_restore_hpx_error,
                (type(self), self.args[0] if self.args else ""),
                dict(self.__dict__))


def _restore_hpx_error(cls, text: str):
    e = cls.__new__(cls)
    RuntimeError.__init__(e, text)
    return e


class FutureError(HpxError):
    """std::future_error analog for future/promise protocol violations."""


class BadParameter(HpxError):
    def __init__(self, message: str = "", function: str = ""):
        super().__init__(Error.bad_parameter, message, function)


class UndeclaredConfigKey(BadParameter):
    """Strict-mode config contract: an ``hpx.``-prefixed key that is
    not in the config_schema registry at all — a typo, or a knob that
    was never declared. Fix: declare it in config_schema.py first."""


class ReservedConfigKey(BadParameter):
    """Strict-mode config contract: the key IS declared, but as
    ``reserved=True`` (HPX interface parity — accepted from ini/CLI so
    reference invocations keep working, but nothing in this runtime
    reads it). A runtime ``set()`` would be silently ignored, so
    strict mode fails it with THIS type — distinct from
    :class:`UndeclaredConfigKey` so callers can tell "typo" from
    "knob without a reader"."""


class NotImplementedYet(HpxError):
    def __init__(self, message: str = "", function: str = ""):
        super().__init__(Error.not_implemented, message, function)


class NetworkError(HpxError):
    def __init__(self, message: str = "", function: str = ""):
        super().__init__(Error.network_error, message, function)


class LocalityLost(NetworkError):
    """A peer locality is gone: the failure detector promoted it
    SUSPECT→DEAD, or a send targeted a locality already marked dead.
    Pending parcels toward it fail with THIS type (not a generic
    NetworkError) so callers can distinguish "the worker died —
    fail over" from "the wire hiccuped — retry". Lives here (not in
    `svc/faultinject`) so `dist/runtime` can raise the real thing;
    the injected variant subclasses this, keeping one except clause
    for both."""

    def __init__(self, locality: int = -1, message: str = "",
                 function: str = ""):
        super().__init__(
            message or f"locality {locality} lost", function)
        self.locality = locality


class DeadlockError(HpxError):
    def __init__(self, message: str = "", function: str = ""):
        super().__init__(Error.deadlock, message, function)


class CacheOOM(HpxError):
    """A KV block pool has no free block. Recoverable: evict
    unreferenced radix chains (`RadixCache.evict`) and retry — the
    serving loop's OOM→evict→retry path. Lives here (not in
    `cache/block_allocator`) so `svc/faultinject` can subclass it for
    injected-OOM faults without a cache↔svc import cycle."""

    def __init__(self, message: str = "", function: str = ""):
        super().__init__(Error.out_of_memory, message, function)


class ServerClosedError(HpxError):
    """submit() after shutdown(): the server is draining (invalid_status),
    which a client tells apart from a malformed request."""

    def __init__(self, message: str = ""):
        super().__init__(Error.invalid_status,
                         message or "server is shut down — submit() no "
                         "longer accepts requests (queued and in-flight "
                         "work still drains via run())",
                         "ContinuousServer.submit")


class RequestShedError(HpxError):
    """The server gave up on one request (admission OOM that outlived
    its deferral budget, or a decode-step OOM). Recorded per rid in
    ``ContinuousServer.failed``; service_unavailable, so a client may
    retry, unlike a bad_parameter rejection."""

    def __init__(self, rid: int, reason: str):
        super().__init__(Error.service_unavailable,
                         f"request {rid} shed: {reason}",
                         "ContinuousServer")
        self.rid = rid
        self.reason = reason


class DeadlineExceededError(RequestShedError):
    """Shed because the submit()-time deadline lapsed while the request
    was still queued or prefilling: the overload fail-fast path (a
    starving queue sheds instead of aging out)."""

    def __init__(self, rid: int, deadline_s: Optional[float]):
        RequestShedError.__init__(
            self, rid,
            f"deadline of {deadline_s or 0.0:g}s lapsed before the "
            "request went live")
        self.deadline_s = deadline_s


class ConcretizationTypeError(TypeError):
    """A function mapped over a range on the device path (the algorithms'
    ``vmap``) asked for the Python value of an element (``float(x)``,
    ``x.item()``). The name and base class (TypeError) of
    ``jax.errors.ConcretizationTypeError``, which the reference raises
    for the same function under ``jax.vmap``."""


class TracerBoolConversionError(ConcretizationTypeError):
    """A mapped function branched on an element (``if x > 0``): Python
    control flow that depends on the data. The name and bases of
    ``jax.errors.TracerBoolConversionError``."""


def throw_exception(code: Error, message: str = "", function: str = "") -> None:
    """HPX_THROW_EXCEPTION analog."""
    raise HpxError(code, message, function)


class ErrorCode:
    """hpx::error_code analog: out-parameter error reporting for the
    no-throw API variants (f(..., ec) sets ec instead of raising)."""

    def __init__(self) -> None:
        self.value: Error = Error.success
        self.message: str = ""

    def clear(self) -> None:
        self.value = Error.success
        self.message = ""

    def set(self, code: Error, message: str = "") -> None:
        self.value = Error(code)
        self.message = message

    def __bool__(self) -> bool:  # truthy when an error occurred
        return self.value != Error.success

    def __repr__(self) -> str:
        return f"ErrorCode({self.value.name}, {self.message!r})"


def throws_or_sets(ec: Optional[ErrorCode], code: Error, message: str) -> Any:
    """Helper implementing HPX's `throws` vs `error_code&` convention."""
    if ec is None:
        raise HpxError(code, message)
    ec.set(code, message)
    return None

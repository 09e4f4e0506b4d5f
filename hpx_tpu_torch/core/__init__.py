from . import config, errors, version  # noqa: F401
from .config import Configuration  # noqa: F401
from .errors import (  # noqa: F401
    BadParameter,
    DeadlockError,
    Error,
    ErrorCode,
    FutureError,
    HpxError,
)

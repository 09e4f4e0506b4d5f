from . import config, errors  # noqa: F401
from .config import Configuration  # noqa: F401
from .errors import (  # noqa: F401
    BadParameter,
    DeadlockError,
    Error,
    ErrorCode,
    FutureError,
    HpxError,
)

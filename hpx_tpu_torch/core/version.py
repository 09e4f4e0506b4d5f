"""Version info.

Reference analog: libs/core/version (hpx::full_version_as_string).
Counterpart of ``hpx_tpu.core.version``: the port carries the version of
the package it ports.
"""

HPX_TPU_VERSION = (0, 1, 0)
__version__ = ".".join(str(v) for v in HPX_TPU_VERSION)


def full_version_as_string() -> str:
    return ".".join(str(v) for v in HPX_TPU_VERSION)

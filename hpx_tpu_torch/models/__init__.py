from . import stencil1d  # noqa: F401

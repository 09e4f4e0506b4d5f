"""The native host runtime: the C++ work-stealing scheduler (``scheduler.cpp``)
and its ctypes binding (``loader.py``)."""

from .profiling import bound, device_trace, roofline, timed  # noqa: F401

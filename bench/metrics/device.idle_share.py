"""The device: the share of the window in which no operation ran on it,
from the profiler's trace of the window, in %."""


def read(w):
    if w.device_trace is None:
        return None
    return 100.0 * (1.0 - w.device_trace.busy_s() / w.device_trace.window_s)

"""`segment_mean` (kernels/csrc/segment_mean.cu): the least time its bytes
need at the card's HBM rate over its traced kernel time, in %.  The bytes
come from each step's shapes (`bench.yardstick.segment_mean_bytes`)."""
from bench import yardstick

KERNEL = "segment_mean_kernel"


def read(w):
    if w.device_trace is None:
        return None
    secs, launches = w.device_trace.kernel_s(KERNEL)
    if launches != len(w.steps) * len(w.config["fanouts"]) or secs <= 0:
        return None
    nbytes = sum(s.segment_mean_bytes for s in w.steps)
    return 100.0 * nbytes / yardstick.HBM_BYTES_PER_S / secs

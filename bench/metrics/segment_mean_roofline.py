"""`segment_mean` (kernels/csrc/segment_mean.cu): the least time its bytes
need at the card's HBM rate over its traced kernel time, in %.  The bytes
and launches of each step come from its shapes, counted by the cell's
family (`Step.kernels`)."""
from bench import yardstick

KERNEL = "segment_mean_kernel"


def read(w):
    counts = [s.kernels.get("segment_mean") for s in w.steps]
    if w.device_trace is None or None in counts:
        return None
    secs, launches = w.device_trace.kernel_s(KERNEL)
    if launches != sum(n for _, n in counts) or secs <= 0:
        return None
    nbytes = sum(b for b, _ in counts)
    return 100.0 * nbytes / yardstick.HBM_BYTES_PER_S / secs

"""`hgt_attend` (kernels/csrc/hgt_attend.cu, forward and backward): the
least time its bytes need at the card's HBM rate over its traced kernel
time, in %.  The bytes and launches of each step come from its layers'
destinations, slots and k'/v' rows, counted by the cell's family
(`Step.kernels`).  None where the traced launches are not the counted ones
(a program without the kernel, or with other launches)."""
from bench import yardstick

KERNEL = "hgt_attend"


def read(w):
    counts = [s.kernels.get("hgt_attend") for s in w.steps]
    if w.device_trace is None or not counts or None in counts:
        return None
    secs, launches = w.device_trace.kernel_s(KERNEL)
    if launches != sum(n for _, n in counts) or secs <= 0:
        return None
    nbytes = sum(b for b, _ in counts)
    return 100.0 * nbytes / yardstick.HBM_BYTES_PER_S / secs

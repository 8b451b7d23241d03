"""HGT's joint attention (kernels/csrc/hgt_attend.cu, its forward and both
backward passes): the traced device ms of its kernels a step.  None without
a trace or where no such kernel ran (a program without them)."""
KERNEL = "hgt_attend"


def read(w):
    if w.device_trace is None or not w.steps:
        return None
    secs, launches = w.device_trace.kernel_s(KERNEL)
    if launches == 0:
        return None
    return 1e3 * secs / len(w.steps)

"""GAT's attention over the fanout (kernels/csrc/gat_attend.cu, its forward,
backward and the backward's sum of the attention vectors' partials): the
traced device ms of its kernels a step.  None without a trace or where no
such kernel ran (a program without them)."""
KERNEL = "gat_attend"


def read(w):
    if w.device_trace is None or not w.steps:
        return None
    secs, launches = w.device_trace.kernel_s(KERNEL)
    if launches == 0:
        return None
    return 1e3 * secs / len(w.steps)

"""The whole training step on the host clock: the 90th percentile of every
window step's wall time, `next_batch` to the end of `sgd_step`,
synchronised, in ms.  It was an end-to-end tail; its runs spread too
widely to hold a bound (PERF.md section 2), so it stands here, unbounded."""
from bench import yardstick


def read(w):
    if not w.steps:
        return None
    return yardstick.percentile([s.wall_s * 1e3 for s in w.steps], 90)

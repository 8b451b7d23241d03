"""The whole training step on the host clock: all seeds of the window's
steps over the window's seconds, in seeds/s.  It was the end-to-end rate;
on a host whose cores are shared its runs spread too widely to hold a
bound (PERF.md section 2), so it stands here, unbounded."""


def read(w):
    if not w.steps:
        return None
    return sum(s.seeds for s in w.steps) / w.seconds

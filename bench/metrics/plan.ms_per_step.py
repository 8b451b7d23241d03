"""Loader planning (`GIDSDataLoader.plan_next`: host neighbour sampling and
the window's admits): host ms a step, from the span around each call."""


def read(w):
    if not w.spans.records:
        return None
    return w.spans.total("plan_next", w.t0, w.t1) / len(w.steps) * 1e3

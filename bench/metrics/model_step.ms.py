"""Model step (`models.gnn.sgd_step`: forward, backward, SGD update): device
ms a step between CUDA events recorded around the call."""
import statistics


def read(w):
    got = [s.model_ms for s in w.steps if s.model_ms is not None]
    return statistics.fmean(got) if got and len(got) == len(w.steps) else None

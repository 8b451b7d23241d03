"""The model step's share of the card's peak: the matrix-product operations
of every step (forward and backward, counted from the shapes by the cell's
family, `Window.step_flops`) over the model step's own device time (the
CUDA events around it that `model_step.ms` reads), against the peak for
the configuration's precision, in %."""
from bench import yardstick


def read(w):
    c = w.config
    got = [s.model_ms for s in w.steps if s.model_ms is not None]
    if not got or len(got) != len(w.steps) or w.step_flops is None:
        return None
    peak = yardstick.PEAK_FLOPS_PER_S["tf32" if c["tf32"] else c["dtype"]]
    return yardstick.share_of_peak(w.step_flops * len(got), sum(got) / 1e3,
                                   peak)

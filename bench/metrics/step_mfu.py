"""The whole training step's share of the card's peak: the matrix-product
operations of every step of the window (forward and backward, counted from
the shapes by the cell's family, `Window.step_flops`) over the window's
seconds, against the peak for the configuration's precision, in %.  It
bounds what any kernel's roofline can claim: sampling, staging and the
copies all lie in its time."""
from bench import yardstick


def read(w):
    c = w.config
    if not w.steps or w.step_flops is None:
        return None
    peak = yardstick.PEAK_FLOPS_PER_S["tf32" if c["tf32"] else c["dtype"]]
    return yardstick.share_of_peak(w.step_flops * len(w.steps), w.seconds,
                                   peak)

"""The whole training step's share of the card's peak: the matrix-product
operations of every step of the window (forward and backward, counted from
the shapes in `bench.yardstick`) over the window's seconds, against the
peak for the configuration's precision, in %.  It bounds what any kernel's
roofline can claim: sampling, staging and the copies all lie in its
time."""
from bench import yardstick


def read(w):
    c = w.config
    if not w.steps:
        return None
    flops = yardstick.step_matmul_flops(
        c["model"], w.traffic["batch_size"], c["fanouts"], c["in_dim"],
        c["hidden_dim"], c["num_classes"])
    peak = yardstick.PEAK_FLOPS_PER_S["tf32" if c["tf32"] else c["dtype"]]
    return yardstick.share_of_peak(flops * len(w.steps), w.seconds, peak)

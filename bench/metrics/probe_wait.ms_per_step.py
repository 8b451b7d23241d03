"""The host blocked on the card in the device tier's probe: host ms a step
from the end of the enqueue (the copies and the three device stages) until
the hit mask and the stage events are read (`last_split_ms["probe_wait"]`)."""
import statistics


def read(w):
    got = [s.split_ms["probe_wait"] for s in w.steps
           if "probe_wait" in s.split_ms]
    if not got or len(got) != len(w.steps):
        return None
    return statistics.fmean(got)

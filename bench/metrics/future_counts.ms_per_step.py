"""The device tier's reuse counts (`DeviceStoreTier._future_counts`: the
window's unique ids sorted and binary-searched): host ms a step, as the
tier reports it in `last_split_ms["future_counts"]`."""
import statistics


def read(w):
    got = [s.split_ms["future_counts"] for s in w.steps
           if "future_counts" in s.split_ms]
    if not got or len(got) != len(w.steps):
        return None
    return statistics.fmean(got)

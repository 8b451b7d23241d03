"""Host-to-device copy of the staged rows, ids and reuse counts: ms a step
between CUDA events (`last_split_ms["h2d"]`)."""
import statistics


def read(w):
    got = [s.split_ms["h2d"] for s in w.steps if "h2d" in s.split_ms]
    return statistics.fmean(got) if len(got) == len(w.steps) else None

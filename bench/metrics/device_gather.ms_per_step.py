"""Device cache and gather: the cache access, `tiered_gather` and
`store_fill`, ms a step between CUDA events (`last_split_ms`)."""
import statistics

STAGES = ("cache_access", "gather", "fill")


def read(w):
    got = [sum(s.split_ms[k] for k in STAGES) for s in w.steps
           if all(k in s.split_ms for k in STAGES)]
    return statistics.fmean(got) if len(got) == len(w.steps) else None

"""The loader's `execute` less the device tier's host stages: host ms a step
in the span around each `GIDSDataLoader.execute` that the reuse counts,
host staging and the wait for the card (`last_split_ms` "future_counts",
"stage_host", "probe_wait") do not cover: the lower tiers' probes, the
report, pricing and feedback."""
import statistics

STAGES = ("future_counts", "stage_host", "probe_wait")


def read(w):
    if not w.steps or not any(r[0] == "execute" for r in w.spans.records):
        return None
    got = [sum(s.split_ms[k] for k in STAGES) for s in w.steps
           if all(k in s.split_ms for k in STAGES)]
    if len(got) != len(w.steps):
        return None
    execute_ms = w.spans.total("execute", w.t0, w.t1) / len(w.steps) * 1e3
    return execute_ms - statistics.fmean(got)

"""Host staging (`HostStager.stage`): ms a step on the host clock, as the
device tier reports it in `last_split_ms["stage_host"]`."""
import statistics


def read(w):
    got = [s.split_ms["stage_host"] for s in w.steps
           if "stage_host" in s.split_ms]
    return statistics.fmean(got) if len(got) == len(w.steps) else None

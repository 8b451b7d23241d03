"""HGT's slot layout (`models/hgt.py` `hgt_blocks`: each hop's distinct
source rows per relation, each slot's row in the stacked k'/v', the CSR
over the destinations): host ms a step in the program's own `hgt_slots`
spans, which the `hgt` family copies into the run's spans in traced runs.
Nothing where the program records no such span."""


def read(w):
    if not w.steps or not any(n == "hgt_slots"
                              for n, _, _ in w.spans.records):
        return None
    return w.spans.total("hgt_slots", w.t0, w.t1) / len(w.steps) * 1e3

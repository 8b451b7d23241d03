"""Relational sampling (`sampling/relational.py`: every hop's per-relation
draws): host ms a step in the program's own `sample_relations` spans,
which a family copies into the run's spans in traced runs (the `rgat`
family, from the loader's tracer).  Nothing where the program records no
such span."""


def read(w):
    if not w.steps or not any(n == "sample_relations"
                              for n, _, _ in w.spans.records):
        return None
    return w.spans.total("sample_relations", w.t0, w.t1) / len(w.steps) * 1e3

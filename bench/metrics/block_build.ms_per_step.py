"""Block building (`sampling/relational.py`: each hop's deduplication into
the next level and the slots' position maps): host ms a step in the
program's own `build_blocks` spans, which a family copies into the run's
spans in traced runs (the `rgat` family, from the loader's tracer).
Nothing where the program records no such span."""


def read(w):
    if not w.steps or not any(n == "build_blocks"
                              for n, _, _ in w.spans.records):
        return None
    return w.spans.total("build_blocks", w.t0, w.t1) / len(w.steps) * 1e3

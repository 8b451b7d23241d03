"""Host staging: the share of the rows staged and copied to the card that
the device cache did not already hold (its misses over the rows staged),
over the window, in %."""


def read(w):
    staged = sum(s.staged_rows for s in w.steps)
    if w.cache_misses is None or not staged:
        return None
    return 100.0 * w.cache_misses / staged

"""Device cache (`device_store.device_gather`): hits over accesses in the
window, from the cache's own `hits` and `misses` counters, in %."""


def read(w):
    if w.cache_hits is None or not (w.cache_hits + w.cache_misses):
        return None
    return 100.0 * w.cache_hits / (w.cache_hits + w.cache_misses)

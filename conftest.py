"""Settings every test directory shares: a pytest-xdist worker gets its
share of the machine's cores.

Each worker's torch would otherwise open an intra-op pool as wide as the
machine, so that every worker's small CPU ops spin-wait against the other
workers' pools.  The share is the cores this process may run on divided by
the workers; `OMP_NUM_THREADS` carries it to the processes a test starts.
A run without workers keeps torch's default, and XLA's threads are left as
they are."""
import os


def pytest_configure():
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        return
    share = max(1, len(os.sched_getaffinity(0)) // int(workers))
    os.environ["OMP_NUM_THREADS"] = str(share)
    import torch
    torch.set_num_threads(share)
